"""Parity of the port's likelihoods with ``nifty_tpu``'s on the same numpy
inputs in float64: energy, transformation, normalized residual, metric and
both square roots of the metric of all eight likelihoods (1e-12 of the
largest entry: a few pointwise operations and one sum), unbatched and with
a leading batch axis of 2 against ``jax.vmap``; ``LikelihoodSum``; and a
32^2 Poisson log-normal field (metric matvec 1e-10, one lockstep update
1e-6, the budgets of the other update tests).  The draws and curves of
likelihoods whose square roots do not come from a transformation are in
``test_torch_likelihood_draws.py``.
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from test_torch_driver import JaxKey, build  # noqa: E402
from test_torch_optimize_kl import SHORT  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    gl, wl = jt.tree.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.max(np.abs(w)), 1e-300))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jt.from_numpy(tree)


def _normal(rng, shape, dtype):
    if np.issubdtype(dtype, np.complexfloating):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return rng.standard_normal(shape)


def _like(rng, shapes, batch=()):
    """Standard normal numpy tree shaped like a port tree of shapes."""
    return jt.tree.tree_map(
        lambda s: _normal(rng, batch + s.shape, np.dtype(str(s.dtype).replace("torch.", ""))),
        shapes)


RNG = np.random.default_rng(0)
REAL = RNG.standard_normal(6)
COMPLEX = RNG.standard_normal(6) + 1j * RNG.standard_normal(6)
COUNTS = RNG.poisson(6.0, 6)
COUNTS_DICT = {"a": RNG.poisson(6.0, 4), "b": RNG.poisson(3.0, (2, 3))}
EVENTS = RNG.integers(0, 2, 6)
EVENTS_DICT = {"a": RNG.integers(0, 2, 5), "b": RNG.integers(0, 2, (2, 2))}
BETA = RNG.uniform(0.5, 2.0, 6)
BETA_DICT = {"a": RNG.uniform(0.5, 2.0, 3), "b": RNG.uniform(0.5, 2.0, (2, 2))}
LABELS = RNG.integers(0, 3, (4, 1))


def _positive(lo, hi):
    return lambda rng, shapes, batch: jt.tree.tree_map(
        lambda s: rng.uniform(lo, hi, batch + s.shape), shapes)


def _normal_primals(rng, shapes, batch):
    return _like(rng, shapes, batch)


def _mean_and_scale(rng, shapes, batch):
    mean, scale = shapes
    return (_normal(rng, batch + mean.shape, np.dtype(str(mean.dtype).replace("torch.", ""))),
            rng.uniform(0.5, 2.0, batch + scale.shape))


def _logits(rng, shapes, batch):
    return rng.standard_normal(batch + (4, 3))


# name -> (JAX likelihood, port likelihood, primals(rng, domain shapes, batch))
CASES = {
    "gaussian": (lambda: jft.Gaussian(jnp.asarray(REAL), noise_cov_inv=lambda x: 4.0 * x),
                 lambda: jt.Gaussian(torch.from_numpy(REAL), noise_cov_inv=lambda x: 4.0 * x),
                 _normal_primals),
    "studentt": (lambda: jft.StudentT(jnp.asarray(REAL), dof=3.0, noise_std_inv=lambda x: 2.0 * x),
                 lambda: jt.StudentT(torch.from_numpy(REAL), dof=3.0,
                                     noise_std_inv=lambda x: 2.0 * x),
                 _normal_primals),
    "studentt_diag": (lambda: jft.StudentT(jnp.asarray(REAL), dof=4.0,
                                           noise_cov_inv=jnp.asarray(BETA)),
                      lambda: jt.StudentT(torch.from_numpy(REAL), dof=4.0,
                                          noise_cov_inv=torch.from_numpy(BETA)),
                      _normal_primals),
    "poissonian": (lambda: jft.Poissonian(jnp.asarray(COUNTS)),
                   lambda: jt.Poissonian(torch.from_numpy(COUNTS)), _positive(2.0, 10.0)),
    "poissonian_dict": (lambda: jft.Poissonian(_to_jax(COUNTS_DICT)),
                        lambda: jt.Poissonian(_to_torch(COUNTS_DICT)), _positive(2.0, 10.0)),
    "bernoulli": (lambda: jft.Bernoulli(jnp.asarray(EVENTS)),
                  lambda: jt.Bernoulli(torch.from_numpy(EVENTS)), _positive(0.1, 0.9)),
    "bernoulli_dict": (lambda: jft.Bernoulli(_to_jax(EVENTS_DICT)),
                       lambda: jt.Bernoulli(_to_torch(EVENTS_DICT)), _positive(0.1, 0.9)),
    "inverse_gamma": (lambda: jft.InverseGamma(jnp.asarray(BETA), alpha=1.5),
                      lambda: jt.InverseGamma(torch.from_numpy(BETA), alpha=1.5),
                      _positive(0.5, 2.0)),
    "inverse_gamma_dict": (lambda: jft.InverseGamma(_to_jax(BETA_DICT)),
                           lambda: jt.InverseGamma(_to_torch(BETA_DICT)), _positive(0.5, 2.0)),
    "vc_gaussian": (lambda: jft.VariableCovarianceGaussian(jnp.asarray(REAL)),
                    lambda: jt.VariableCovarianceGaussian(torch.from_numpy(REAL)),
                    _mean_and_scale),
    "vc_gaussian_complex": (
        lambda: jft.VariableCovarianceGaussian(jnp.asarray(COMPLEX), iscomplex=True),
        lambda: jt.VariableCovarianceGaussian(torch.from_numpy(COMPLEX), iscomplex=True),
        _mean_and_scale),
    "vc_studentt": (lambda: jft.VariableCovarianceStudentT(jnp.asarray(REAL), dof=3.0),
                    lambda: jt.VariableCovarianceStudentT(torch.from_numpy(REAL), dof=3.0),
                    _mean_and_scale),
    "categorical": (lambda: jft.Categorical(jnp.asarray(LABELS)),
                    lambda: jt.Categorical(torch.from_numpy(LABELS)), _logits),
}


def _optional(fn):
    """``fn()``, or the exception class it raised for a method the
    likelihood does not have."""
    try:
        return fn()
    except NotImplementedError:
        return NotImplementedError


def _tangents(rng, primals):
    return jax.tree_util.tree_map(
        lambda p: _normal(rng, np.shape(p), np.asarray(p).dtype), primals)


@pytest.mark.parametrize("batch", [(), (2,)], ids=["one", "B2"])
@pytest.mark.parametrize("case", CASES)
def test_likelihood_matches_jax(case, batch):
    make_j, make_t, primals = CASES[case]
    lh_j, lh_t = make_j(), make_t()
    rng = np.random.default_rng(1)
    p = primals(rng, lh_t.domain, batch)
    t = _tangents(rng, p)
    u = _like(rng, lh_t.lsm_tangents_shape, batch)
    pj, tj, uj = _to_jax(p), _to_jax(t), _to_jax(u)
    pt, tt, ut = _to_torch(p), _to_torch(t), _to_torch(u)

    def jx(method, *args):
        fn = getattr(lh_j, method)
        return jax.vmap(fn)(*args) if batch else fn(*args)

    e_j = jx("energy", pj)
    _close(lh_t.energy(pt), jnp.sum(e_j) if batch else e_j)
    for method in ("transformation", "normalized_residual"):
        got = _optional(lambda: getattr(lh_t, method)(pt))
        want = _optional(lambda: jx(method, pj))
        if want is NotImplementedError:
            assert got is NotImplementedError, (case, method)
        else:
            _close(got, want)
    _close(lh_t.metric(pt, tt), jx("metric", pj, tj))
    _close(lh_t.left_sqrt_metric(pt, ut), jx("left_sqrt_metric", pj, uj))
    _close(lh_t.right_sqrt_metric(pt, tt), jx("right_sqrt_metric", pj, tj))
    lsm, rsm = lh_t.sqrt_metric_at(pt)
    _close(lsm(ut), jx("left_sqrt_metric", pj, uj))
    _close(rsm(tt), jx("right_sqrt_metric", pj, tj))


def test_likelihood_data_types_and_buffers():
    with pytest.raises(TypeError, match="integer"):
        jt.Poissonian(torch.tensor([1.0, 2.0]))
    with pytest.raises(TypeError, match="integer"):
        jt.Bernoulli({"a": torch.tensor([0.0, 1.0])})
    with pytest.raises(TypeError, match="integer"):
        jft.Poissonian(jnp.asarray([1.0, 2.0]))
    # float means float64: the white noise of the metric samples
    lh = jt.Poissonian(torch.tensor([1, 2]))
    assert lh.lsm_tangents_shape.dtype == torch.float64 == lh.domain.dtype
    assert jt.Bernoulli(torch.tensor([1, 0]), sampling_dtype=np.float32).domain.dtype \
        == torch.float32
    moved = jt.Poissonian(_to_torch(COUNTS_DICT)).to(torch.float32)
    assert moved.data["a"].dtype == torch.int64  # integer data stays integer
    ig = jt.InverseGamma(_to_torch(BETA_DICT), alpha=2.0)
    assert {n for n, _ in ig.named_buffers()} == {"_beta.0", "_beta.1", "_alpha.0", "_alpha.1"}
    assert torch.equal(ig.alpha["b"], torch.full((2, 2), 2.0, dtype=torch.float64))
    # data that is not a tensor lands on the default device (the CPU here)
    assert jt.Poissonian(np.array([1, 2, 3])).data.device.type == "cpu"


def test_studentt_over_a_dict_is_the_sum_of_its_leaves():
    """The JAX package's ``StudentT`` takes arrays only; the port's maps over
    a dict's leaves, so its energy is the sum of the leaves' energies."""
    rng = np.random.default_rng(2)
    data = {"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))}
    p = {k: rng.standard_normal(v.shape) for k, v in data.items()}
    got = jt.StudentT(_to_torch(data), dof=2.5).energy(_to_torch(p))
    want = sum(float(jft.StudentT(jnp.asarray(data[k]), dof=2.5).energy(jnp.asarray(p[k])))
               for k in data)
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def _sum_case(mod):
    """Two likelihoods over a dict domain: a Poissonian counts term on
    exp(a) and a Gaussian on b^2 + 1."""
    as_arr = jnp.asarray if mod is jft else torch.from_numpy
    exp = jnp.exp if mod is jft else torch.exp
    f1 = mod.Model(lambda x: exp(x["a"]), domain={"a": mod.ShapeWithDtype((5,))})
    f2 = mod.Model(lambda x: x["b"] ** 2 + 1.0, domain={"b": mod.ShapeWithDtype((3,))})
    counts = np.random.default_rng(4).poisson(3.0, 5)
    data = np.random.default_rng(5).standard_normal(3)
    return (mod.Poissonian(as_arr(counts)).amend(f1)
            + mod.Gaussian(as_arr(data), noise_cov_inv=lambda x: 4.0 * x).amend(f2))


def test_likelihood_sum_matches_jax():
    lh_j, lh_t = _sum_case(jft), _sum_case(jt)
    assert isinstance(lh_t, jt.LikelihoodSum)
    assert sorted(lh_t.domain) == ["a", "b"]
    assert sorted(lh_t.lsm_tangents_shape) == ["lh_left", "lh_right"]
    rng = np.random.default_rng(6)
    p = {"a": rng.standard_normal(5), "b": rng.standard_normal(3)}
    t = {"a": rng.standard_normal(5), "b": rng.standard_normal(3)}
    u = {"lh_left": rng.standard_normal(5), "lh_right": rng.standard_normal(3)}
    pj, tj, uj = _to_jax(p), _to_jax(t), _to_jax(u)
    pt, tt, ut = _to_torch(p), _to_torch(t), _to_torch(u)
    _close(lh_t.energy(pt), lh_j.energy(pj))
    _close(lh_t.transformation(pt), lh_j.transformation(pj))
    _close(lh_t.normalized_residual(pt), lh_j.normalized_residual(pj))
    _close(lh_t.metric(pt, tt), lh_j.metric(pj, tj))
    _close(lh_t.metric_at(pt)(tt), lh_j.metric_at(pj)(tj))
    _close(lh_t.left_sqrt_metric(pt, ut), lh_j.left_sqrt_metric(pj, uj))
    _close(lh_t.right_sqrt_metric(pt, tt), lh_j.right_sqrt_metric(pj, tj))
    lsm, rsm = lh_t.sqrt_metric_at(pt)
    _close(lsm(ut), lh_j.left_sqrt_metric(pj, uj))
    _close(rsm(tt), lh_j.right_sqrt_metric(pj, tj))
    # the summed metric is each summand's square roots composed and added
    both = jt.tree.tree_add(*(lh.left_sqrt_metric(pt, lh.right_sqrt_metric(pt, tt))
                              for lh in (lh_t.left_likelihood, lh_t.right_likelihood)))
    _close(both, lh_j.metric(pj, tj))


# -- a 32^2 Poisson log-normal field, as demos/2_poisson_counts.py --------


def _poisson_field(mod, counts):
    cf = build(mod)
    exp = jnp.exp if mod is jft else torch.exp
    as_arr = jnp.asarray if mod is jft else torch.from_numpy
    lam = mod.Model(lambda x: exp(cf(x)), domain=cf.domain, init=cf.init)
    return mod.Poissonian(as_arr(counts)).amend(lam)


@pytest.fixture(scope="module")
def poisson_problem():
    cf = build(jft)
    rng = np.random.default_rng(7)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    counts = rng.poisson(np.exp(np.asarray(cf(_to_jax(lat)))))
    pos = {k: 0.5 * rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    return _poisson_field(jft, counts), _poisson_field(jt, counts), pos


def test_poisson_field_metric_matches_jax(poisson_problem):
    lh_j, lh_t, pos = poisson_problem
    t = {k: np.random.default_rng(8).standard_normal(v.shape) for k, v in pos.items()}
    want = jax.jit(lambda p, t: lh_j.metric(p, t))(_to_jax(pos), _to_jax(t))
    _close(lh_t.metric(_to_torch(pos), _to_torch(t)), want, 1e-10)
    _close(lh_t.metric_at(_to_torch(pos))(_to_torch(t)), want, 1e-10)
    _close(lh_t.energy(_to_torch(pos)), lh_j.energy(_to_jax(pos)), 1e-10)


def test_poisson_field_lockstep_update_matches_jax(poisson_problem):
    lh_j, lh_t, pos = poisson_problem
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="vmap")
    smp_j = jft.Samples(pos=_to_jax(pos), samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(9), **SHORT))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map="vmap")
    assert opt_t.lockstep
    smp_t = jt.Samples(pos=_to_torch(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(9)), **SHORT))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    assert st_t.sample_state.nit.tolist() == np.asarray(st_j.sample_state.nit).tolist()
    np.testing.assert_allclose(
        float(st_t.minimization_state.fun), float(st_j.minimization_state.fun), rtol=1e-6)
    _close(smp_t.pos, smp_j.pos, 1e-6)
    _close(smp_t._samples, smp_j._samples, 1e-6)
