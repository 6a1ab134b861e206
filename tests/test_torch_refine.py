"""Parity of the port's ICR field on coordinate charts
(``nifty_tpu_torch.refine.RefinementField``) with ``nifty_tpu``'s, for the
cases of ``tests/test_refine.py``: regular 1-D and 2-D charts, deformed
charts, irregular extents, periodic axes, the one-window stencils and
demo 9's log-deformed chart.

- The matrices, the forward, its jvp and its vjp against the JAX package
  on the same numpy latents, at 1e-10 of the largest entry: the matrices
  come from each library's own Cholesky factorizations of the same
  kernel matrices (Matern-3/2, whose conditioning keeps two correct
  factorizations within ~1e-11), and the fields sum in another order.
- Latents with a leading batch axis (B = 2) against ``jax.vmap``.
- The covariance the model implies (``A A^T``, from the port's own
  Jacobian) against the exact kernel, with ``tests/test_refine.py``'s
  bounds.
- ``coarse_windows`` (both routes, with a leading axis) and
  ``refinement_matrices`` against the JAX package.
- A short ``optimize_kl`` on an ICR field (CG 5 steps), the noise
  replayed, whose KL energy matches the JAX package's at 1e-8 (the
  position at 1e-6).
"""

import importlib
import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp
from scipy.spatial import distance_matrix

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import refine as jr  # noqa: E402
from nifty_tpu.refine import charted_field as jcf  # noqa: E402
from nifty_tpu_torch import refine as tr  # noqa: E402
from nifty_tpu_torch.refine import charted_field as tcf  # noqa: E402

tok = importlib.import_module("nifty_tpu_torch.optimize_kl")

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _matern_j(r):
    return (1.0 + r) * jnp.exp(-r)


def _matern_t(r):
    return (1.0 + r) * torch.exp(-r)


def _warp(reg):
    return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)


CASES = {
    "1d_depth1": dict(shape0=12, depth=1, distances0=0.25),
    "1d_depth2": dict(shape0=12, depth=2, distances0=0.25),
    "2d": dict(shape0=(8, 8), depth=1, distances0=0.3),
    "2d_depth2": dict(shape0=(8, 8), depth=2, distances0=0.5),
    "deformed_1d": dict(shape0=14, depth=2, distances0=0.2,
                        nonlinear_map=lambda x: x + 0.05 * x ** 2),
    "irregular_extents": dict(shape0=(9, 6), depth=2, distances0=(0.5, 0.8)),
    "deformed_2d": dict(shape0=(8, 7), depth=1, distances0=(0.4, 0.4), nonlinear_map=_warp),
    "deformed_axis0": dict(shape0=(8, 7), depth=2, distances0=(0.4, 0.4), nonlinear_map=_warp,
                           irregular_axes=(0,)),
    "periodic": dict(shape0=(8, 8), depth=1, distances0=0.5, periodic=(True, False)),
    "one_window_5_4_jump": dict(shape0=(5, 5), depth=1, distances0=0.7, coarse_size=5,
                                fine_size=4, fine_strategy="jump"),
    "one_window_5_2": dict(shape0=(5,), depth=1, distances0=0.7, coarse_size=5, fine_size=2),
    "demo9": dict(shape0=(14,), depth=5, distances0=(1.0,),
                  nonlinear_map=lambda reg: np.expm1(0.35 * reg)),
}


@pytest.fixture(scope="module")
def fields():
    out = {}
    for name, kw in CASES.items():
        out[name] = (jr.RefinementField(jr.CoordinateChart(**kw), _matern_j),
                     tr.RefinementField(tr.CoordinateChart(**kw), _matern_t))
    return out


def _latents(domain, seed, lead=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + tuple(v.shape)) for k, v in domain.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("case", CASES)
def test_matrices_match(fields, case):
    jf, tf = fields[case]
    cov_j, olfs_j, kers_j = jf._matrices
    cov_t, olfs_t, kers_t = tf.matrices()
    _close(cov_t, cov_j)
    assert len(olfs_t) == len(olfs_j) == jf.chart.depth
    for olf_t, olf_j, ker_t, ker_j in zip(olfs_t, olfs_j, kers_t, kers_j):
        _close(olf_t, olf_j)
        _close(ker_t, ker_j)
    for level in range(jf.chart.depth):
        assert tf._varying_axes(level) == jf._varying_axes(level)
    assert {k: v.shape for k, v in tf.domain.items()} == {
        k: tuple(v.shape) for k, v in jf.domain.items()}


@pytest.mark.parametrize("case", CASES)
def test_forward_jvp_vjp_match(fields, case):
    jf, tf = fields[case]
    lat, tan = _latents(jf.domain, 1), _latents(jf.domain, 2)
    jlat = {k: jnp.asarray(v) for k, v in lat.items()}
    want, want_t = jax.jit(lambda p, t: jax.jvp(jf, (p,), (t,)))(
        jlat, {k: jnp.asarray(v) for k, v in tan.items()})
    got, got_t = torch.func.jvp(tf, (jt.from_numpy(lat),), (jt.from_numpy(tan),))
    assert got.shape == jf.chart.shape
    _close(got, want)
    _close(got_t, want_t)
    cot = np.random.default_rng(3).standard_normal(jf.chart.shape)
    want_c = jax.vjp(jf, jlat)[1](jnp.asarray(cot))[0]
    got_c = torch.func.vjp(tf, jt.from_numpy(lat))[1](torch.from_numpy(cot))[0]
    for k in want_c:
        _close(got_c[k], want_c[k])


@pytest.mark.parametrize("case", ["1d_depth2", "deformed_axis0", "periodic", "demo9"])
def test_leading_batch_axis_matches_vmap(fields, case):
    jf, tf = fields[case]
    lat = _latents(jf.domain, 4, lead=(2,))
    want = jax.vmap(jf)({k: jnp.asarray(v) for k, v in lat.items()})
    got = tf(jt.from_numpy(lat))
    _close(got, want)
    for b in range(2):  # and each row is the unbatched field
        _close(tf(jt.from_numpy({k: v[b] for k, v in lat.items()})), want[b])


def _implied_covariance(tf):
    """``A A^T`` of the linear model, from the port's Jacobian at zero."""
    zeros = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in tf.domain.items()}
    jac = torch.func.jacfwd(tf)(zeros)
    npix = int(np.prod(tf.chart.shape))
    a = np.concatenate([jac[k].reshape(npix, -1).numpy() for k in sorted(jac)], axis=-1)
    return a @ a.T


def _exact(tf, kernel=lambda r: (1.0 + r) * np.exp(-r)):
    pos = tf.chart.positions(tf.chart.depth).reshape(-1, tf.chart.ndim)
    return kernel(distance_matrix(pos, pos))


@pytest.mark.parametrize("case,bound", [("1d_depth1", 0.02), ("1d_depth2", 0.02), ("2d", 0.05),
                                        ("deformed_1d", 0.05), ("deformed_2d", 0.05)])
def test_implied_covariance_is_the_kernel(fields, case, bound):
    """``tests/test_refine.py``'s covariance checks, on the port's field."""
    tf = fields[case][1]
    assert np.abs(_implied_covariance(tf) - _exact(tf)).max() < bound


def test_irregular_extents_stay_a_consistent_gp(fields):
    tf = fields["irregular_extents"][1]
    assert tf.chart.shape[0] != tf.chart.shape[1]
    exact = _exact(tf)
    err = np.abs(_implied_covariance(tf) - exact) / exact.max()
    assert err.max() < 0.11 and np.median(err) < 2e-2


@pytest.mark.parametrize("csz,fsz,strategy", [(3, 2, "extend"), (3, 4, "jump"), (5, 2, "extend"),
                                              (5, 4, "jump"), (5, 4, "extend")])
@pytest.mark.parametrize("ndim", [1, 2])
def test_one_window_covariance_is_exact(csz, fsz, strategy, ndim):
    """With ``shape0 = coarse_size^d`` and depth 1 there is one window: the
    implied covariance equals the kernel on the fine pixels (atol 1e-7,
    rtol 1e-6, as in ``tests/test_refine.py``)."""
    dist0 = 0.7
    tf = tr.RefinementField(tr.CoordinateChart(
        (csz,) * ndim, depth=1, distances0=dist0, coarse_size=csz, fine_size=fsz,
        fine_strategy=strategy), _matern_t)
    dvol = dist0 / (fsz if strategy == "jump" else 2)
    idx = np.stack(np.meshgrid(*(np.arange(fsz),) * ndim, indexing="ij"), axis=-1)
    idx = idx.reshape(-1, ndim) * dvol
    truth = (1.0 + distance_matrix(idx, idx)) * np.exp(-distance_matrix(idx, idx))
    np.testing.assert_allclose(_implied_covariance(tf), truth, atol=1e-7, rtol=1e-6)


def test_refinement_matrices_condition_exactly():
    rng = np.random.default_rng(42)
    coarse, fine = rng.normal(size=(9, 2)), 0.3 * rng.normal(size=(4, 2))
    olf, ker = tr.refinement_matrices(_matern_t, torch.from_numpy(coarse), torch.from_numpy(fine))
    olf_j, ker_j = jr.refinement_matrices(_matern_j, jnp.asarray(coarse), jnp.asarray(fine))
    _close(olf, olf_j)
    _close(ker, ker_j)
    cc = (1 + distance_matrix(coarse, coarse)) * np.exp(-distance_matrix(coarse, coarse))
    fc = (1 + distance_matrix(fine, coarse)) * np.exp(-distance_matrix(fine, coarse))
    ff = (1 + distance_matrix(fine, fine)) * np.exp(-distance_matrix(fine, fine))
    np.testing.assert_allclose(olf.numpy() @ cc, fc, atol=1e-8)
    np.testing.assert_allclose(ker.numpy() @ ker.numpy().T, ff - fc @ np.linalg.solve(cc, fc.T),
                               atol=1e-7)
    # leading axes are independent sites
    both, _ = tr.refinement_matrices(_matern_t, torch.from_numpy(np.stack([coarse, coarse + 1])),
                                     torch.from_numpy(np.stack([fine, fine + 1])))
    _close(both[0], olf_j)


def test_matrices_at_matches_direct_conditioning(fields):
    jf, tf = fields["2d"]
    olf, ker = tf.matrices_at(0, (1, 2))
    cw, fw = tf._site_coords(0, (1, 2))
    olf2, ker2 = tr.refinement_matrices(_matern_t, torch.from_numpy(cw), torch.from_numpy(fw))
    assert torch.equal(olf, olf2) and torch.equal(ker, ker2)
    olf_j, ker_j = jf.matrices_at(0, (1, 2))
    _close(olf, olf_j)
    _close(ker, ker_j)


def test_periodic_irregular_axis_raises():
    kw = dict(shape0=(8, 8), depth=1, distances0=0.5, periodic=(True, False), nonlinear_map=_warp)
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="periodic"):
            mod.RefinementField(mod.CoordinateChart(**kw),
                                _matern_j if mod is jr else _matern_t)


@pytest.mark.parametrize("ndim", [1, 2])
def test_coarse_windows_without_a_chart(ndim):
    x = np.random.default_rng(ndim).normal(size=(2,) + (6,) * ndim)
    want = jax.vmap(lambda v: jcf.coarse_windows(v, ndim))(jnp.asarray(x))
    got = tcf.coarse_windows(torch.from_numpy(x), ndim)
    assert got.shape == (2,) + (4,) * ndim + (3 ** ndim,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    center = got[(slice(None),) + (Ellipsis,) + (3 ** ndim // 2,)]
    np.testing.assert_array_equal(center.numpy(), x[(slice(None),) + (slice(1, -1),) * ndim])


@pytest.mark.parametrize("case", ["2d_depth2", "periodic", "one_window_5_4_jump",
                                  "irregular_extents"])
def test_coarse_windows_and_interleave_with_a_chart(fields, case):
    """The slice route (uniform axes) and the index-table route (periodic
    axes) of ``coarse_windows``, and ``_interleave_children``, with a
    leading axis, against the JAX package's, bit for bit (both copy)."""
    chart = fields[case][0].chart
    for level in range(chart.depth):
        x = np.random.default_rng(level).normal(size=(2,) + chart.shapes[level])
        want = jax.vmap(lambda v: jcf.coarse_windows(v, chart.ndim, chart=chart, level=level))(
            jnp.asarray(x))
        got = tcf.coarse_windows(torch.from_numpy(x), chart.ndim, chart=chart, level=level)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        y = np.random.default_rng(9).normal(
            size=(2,) + chart.site_counts(level) + (chart.fine_size ** chart.ndim,))
        want = jax.vmap(lambda v: jcf._interleave_children(v, chart.ndim, chart.fine_size))(
            jnp.asarray(y))
        got = tcf._interleave_children(torch.from_numpy(y), chart.ndim, chart.fine_size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_struct(tree):
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float64)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG: split with
    ``jax.random.split``, draw with ``nifty_tpu.tree.random_like``."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        out = jft.random_like(self.key, _jax_struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


def test_optimize_kl_on_an_icr_field_matches():
    """``tests/test_refine.py::test_refinement_in_inference``'s problem with
    short solves (CG 5 steps: CG on the metric amplifies rounding
    differences per step), the noise replayed: KL energies within 1e-8."""
    kw = dict(shape0=16, depth=2, distances0=0.3)
    jf = jr.RefinementField(jr.CoordinateChart(**kw), _matern_j)
    tf = tr.RefinementField(tr.CoordinateChart(**kw), _matern_t)
    lat = _latents(jf.domain, 5)
    noise = 0.2
    truth = np.asarray(jf({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + noise * np.random.default_rng(6).standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / noise ** 2).amend(jf)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / noise ** 2).amend(tf)
    pos = _latents(jf.domain, 7)
    kwargs = dict(
        n_total_iterations=2, n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-6, maxiter=3, cg_kwargs=dict(maxiter=5))),
        sample_mode="linear_resample",
    )
    key = jax.random.PRNGKey(4)
    energies_j, energies_t = [], []
    smp_j, st_j = jft.optimize_kl(
        lh_j, {k: jnp.asarray(v) for k, v in pos.items()}, key=key,
        callback=lambda s, st: energies_j.append(float(st.minimization_state.fun)), **kwargs)
    smp_t, st_t = tok.optimize_kl(
        lh_t, jt.from_numpy(pos), key=JaxKey(key),
        callback=lambda s, st: energies_t.append(float(st.minimization_state.fun)), **kwargs)
    assert len(energies_t) == len(energies_j) == 2
    np.testing.assert_allclose(energies_t, energies_j, rtol=1e-8)
    # the energy is flat at the Newton steps' ends, the position is not:
    # 1e-6 of its largest entry, as for the correlated field's update
    # (tests/test_torch_optimize_kl.py)
    for k in pos:
        _close(smp_t.pos[k], smp_j.pos[k], 1e-6)
