"""The port's evidence lower bound (``evidence_lower_bound.py``) against
``nifty_tpu.estimate_evidence_lower_bound`` on the same likelihoods and
samples, float64 on the CPU.

On the linear-Gaussian case of ``tests/test_num_and_responses.py``: the
explicit path (every relevant eigenvalue) to 1e-9 relative, SLQ fed the
reference's Rademacher probes (a noise provider that splits the key as
``stochastic_lq_logdet`` does) to 1e-10, in lockstep rows and looped.  On a
16^2 correlated field with geoVI-like samples: the deflated ARPACK path's
eigenvalues to 1e-8 and its bound to 1e-8.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu.evidence_lower_bound as jel  # noqa: E402
import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.evidence_lower_bound as tel  # noqa: E402
from nifty_tpu.optimize_kl import _StandardHamiltonian as JHam  # noqa: E402
from nifty_tpu_torch import tree as tt  # noqa: E402
from nifty_tpu_torch.optimize_kl import _StandardHamiltonian as THam  # noqa: E402

torch.set_num_threads(1)

STATS = ("elbo_mean", "elbo_up", "elbo_lw", "lower_error")


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _close(got, want, rtol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), (got, want)


def _struct(tree):
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float64)


class JaxProbeKey:
    """Noise provider replaying the reference's probes."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxProbeKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        return self.draw(primals, tt.normal, device)

    def draw(self, primals, rng, device=None):
        jrng = jax.random.rademacher if rng is tt.rademacher else jax.random.normal
        out = jtree.random_like(self.key, _struct(primals), rng=jrng)
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device or "cpu")


def _pair(lh_j, lh_t, pos, resid):
    """Both packages' Samples from numpy position and residuals."""
    s_j = jft.Samples(pos=jax.tree_util.tree_map(jnp.asarray, pos),
                      samples=jax.tree_util.tree_map(jnp.asarray, resid))
    s_t = jt.Samples(pos=jt.from_numpy(pos), samples=jt.from_numpy(resid))
    return s_j, s_t


@pytest.fixture(scope="module")
def linear_gaussian():
    """``tests/test_num_and_responses.py::test_elbo_linear_gaussian``: 4 dof,
    6 data, noise 0.5, two exact posterior samples about the exact mean."""
    rng = np.random.default_rng(42)
    n, m, noise = 4, 6, 0.5
    R = rng.normal(size=(m, n))
    truth = rng.normal(size=n)
    data = R @ truth + noise * rng.normal(size=m)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / noise ** 2).amend(
        jft.Model(lambda p: jnp.asarray(R) @ p["x"], domain={"x": jft.ShapeWithDtype((n,))}))
    tR = torch.from_numpy(R)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / noise ** 2).amend(
        jt.Model(lambda p: tR @ p["x"], domain={"x": jt.ShapeWithDtype((n,))}))
    M = R.T @ R / noise ** 2
    post_cov = np.linalg.inv(M + np.eye(n))
    post_mean = post_cov @ (R.T @ data / noise ** 2)
    eps = rng.normal(size=(2, n))
    resid = {"x": eps @ np.linalg.cholesky(post_cov).T}
    return lh_j, lh_t, _pair(lh_j, lh_t, {"x": post_mean}, resid), M


def test_explicit_path(linear_gaussian):
    lh_j, lh_t, (s_j, s_t), M = linear_gaussian
    e_j, st_j = jft.estimate_evidence_lower_bound(lh_j, s_j, n_eigenvalues=4, verbose=False)
    e_t, st_t = jt.estimate_evidence_lower_bound(lh_t, s_t, n_eigenvalues=4, verbose=False)
    _close(e_t, e_j, 1e-9)
    for k in STATS:
        assert abs(st_t[k] - st_j[k]) <= 1e-9 * abs(st_j[k]), k
    assert st_t["metric_matvecs"] == 4
    ev = np.linalg.eigvalsh(M + np.eye(4))
    assert abs(st_t["logdet"] - np.sum(np.log(ev))) <= 1e-12 * np.sum(np.log(ev))
    assert abs(st_t["largest_eigenvalue"] - ev[-1]) <= 1e-12 * ev[-1]


def test_explicit_metric_is_the_dense_one(linear_gaussian):
    """The metric's explicit matrix is R^T N^-1 R + 1."""
    _, lh_t, (_, s_t), M = linear_gaussian
    met = tel._RavelMetric(THam(lh_t).metric_at(s_t.pos), s_t.pos)
    _close(met.explicit(), M + np.eye(4), 1e-13)
    _close(met @ np.ones(4), (M + np.eye(4)) @ np.ones(4), 1e-13)


@pytest.mark.parametrize("slq_map", ["vmap", "smap"])
def test_slq_on_the_reference_probes(linear_gaussian, slq_map):
    lh_j, lh_t, (s_j, s_t), _ = linear_gaussian
    key = jax.random.PRNGKey(42)
    kw = dict(n_eigenvalues=4, verbose=False, method="slq", slq_order=4, slq_samples=16)
    e_j, st_j = jft.estimate_evidence_lower_bound(lh_j, s_j, key=key, **kw)
    e_t, st_t = jt.estimate_evidence_lower_bound(lh_t, s_t, key=JaxProbeKey(key),
                                                 slq_map=slq_map, **kw)
    _close(e_t, e_j, 1e-10)
    for k in STATS:
        assert abs(st_t[k] - st_j[k]) <= 1e-10 * max(abs(st_j[k]), 1e-300), k
    assert st_t["metric_matvecs"] == 4 * 16


def test_slq_default_key(linear_gaussian):
    """Without a key the probes come from seed 0; the bound is within the
    JAX package's own 3 of the explicit one."""
    _, lh_t, (_, s_t), _ = linear_gaussian
    _, exact = jt.estimate_evidence_lower_bound(lh_t, s_t, 4, verbose=False)
    _, slq = jt.estimate_evidence_lower_bound(lh_t, s_t, 4, verbose=False, method="slq",
                                              slq_order=4, slq_samples=64)
    assert abs(slq["elbo_mean"] - exact["elbo_mean"]) < 3.0


def test_argument_checks(linear_gaussian):
    lh_j, lh_t, (_, s_t), _ = linear_gaussian
    with pytest.raises(TypeError, match="Samples"):
        jt.estimate_evidence_lower_bound(lh_t, s_t.pos, 2)
    with pytest.raises(TypeError, match="Likelihood"):
        jt.estimate_evidence_lower_bound(lambda x: x, s_t, 2)
    with pytest.raises(ValueError, match="unknown method"):
        jt.estimate_evidence_lower_bound(lh_t, s_t, 2, method="lanczos")
    with pytest.raises(ValueError, match="more eigenvalues"):
        jt.estimate_evidence_lower_bound(lh_t, s_t, 5, verbose=False)


def _field(mod):
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((16, 16), distances=1.0 / 16, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1.0, 5e-1),
                         asperity=(5e-1, 1e-1))
    return cfm.finalize()


@pytest.fixture(scope="module")
def field_problem():
    """A 16^2 correlated field, data from a prior draw plus noise 0.1, and
    samples as a geoVI run would leave them: a position and two mirrored
    residuals (numpy, seed 12)."""
    cf_j, cf_t = _field(jft), _field(jt)
    rng = np.random.default_rng(12)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    truth = np.asarray(cf_j({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + 0.1 * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / 0.01).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / 0.01).amend(cf_t)
    r = {k: 0.05 * rng.standard_normal(v.shape) for k, v in lat.items()}
    resid = {k: np.stack([v, -v]) for k, v in r.items()}
    pos = {k: v + 0.1 * rng.standard_normal(v.shape) for k, v in lat.items()}
    return lh_j, lh_t, _pair(lh_j, lh_t, pos, resid)


def test_deflated_eigsh_eigenvalues(field_problem):
    lh_j, lh_t, (s_j, s_t) = field_problem
    n = jtree.size(s_j.pos)
    met_j = jel._ravel_metric(JHam(lh_j).metric, s_j.pos, dtype=np.float64)
    met_t = tel._RavelMetric(THam(lh_t).metric_at(s_t.pos), s_t.pos)
    x = np.random.default_rng(0).standard_normal(n)
    _close(met_t @ x, met_j @ x, 1e-12)
    ev_j, _ = jel._eigsh(met_j, 12, tot_dofs=256, min_lh_eval=1e-3, batch_size=4, verbose=False)
    ev_t, _ = tel._eigsh(met_t, 12, tot_dofs=256, min_lh_eval=1e-3, batch_size=4, verbose=False)
    assert ev_t.shape == ev_j.shape == (12,)
    _close(ev_t, ev_j, 1e-8)
    assert met_t.matvecs > 12


def test_deflated_eigsh_bound(field_problem):
    lh_j, lh_t, (s_j, s_t) = field_problem
    e_j, st_j = jft.estimate_evidence_lower_bound(lh_j, s_j, n_eigenvalues=8, batch_size=4,
                                                  verbose=False)
    e_t, st_t = jt.estimate_evidence_lower_bound(lh_t, s_t, n_eigenvalues=8, batch_size=4,
                                                 verbose=False)
    _close(e_t, e_j, 1e-8)
    for k in STATS:
        assert abs(st_t[k] - st_j[k]) <= 1e-8 * abs(st_j[k]), k
