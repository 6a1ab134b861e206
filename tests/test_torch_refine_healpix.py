"""Parity of the port's ICR field on the HEALPix sphere
(``nifty_tpu_torch.refine.RefinementHPField``) with ``nifty_tpu``'s, on the
sphere and on sphere × radius.

- The charts (shapes, positions, neighbour windows) equal the JAX
  package's (tolerance 0: the same C++ core and numpy code).
- ``ker`` at 1e-10 of its largest entry.  ``olf`` is compared with the
  columns of a window that name the same coarse pixel summed (a pixel with
  7 neighbours repeats its centre): the split between two identical
  columns is fixed only by the 1e-10 jitter, so two correct Cholesky
  factorizations put it ~1e-7 apart, while the filter the field applies,
  the sum, agrees at 1e-10 of its largest entry.
- The forward, its jvp and its vjp at 1e-10, B = 2 against ``jax.vmap``,
  on Matern kernels whose scale keeps the kernel matrices well enough
  conditioned for that.
- The covariance the model implies against the exact kernel, on
  ``tests/test_refine.py``'s cases and bounds.
- A short ``optimize_kl`` on a sphere field and a sphere × radius field
  (CG 5 steps), the noise replayed: KL energies within 1e-8.
"""

import importlib
import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import refine as jr  # noqa: E402
from nifty_tpu_torch import refine as tr  # noqa: E402

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


def _matern(lib, scale):
    return lambda r: (1.0 + r / scale) * lib.exp(-r / scale)


def _gauss(lib, scale):
    return lambda r: lib.exp(-(r / scale) ** 2 / 2)


def _chart(mod, nside, depth, radial):
    rc = (mod.CoordinateChart(5, depth=depth, distances0=0.2, nonlinear_map=lambda x: 1.0 + x)
          if radial else None)
    return mod.HEALPixChart(nside, depth, radial_chart=rc)


CASES = {
    # (nside0, depth, radial, kernel scale).  At nside 2 a kernel of scale
    # 0.5 makes the posterior so ill-conditioned that two Newton-CG steps
    # amplify rounding about 1e8-fold (the JAX package's own smap and vmap
    # routes end 5e-8 apart in KL energy), so this case takes 0.3
    "sphere": (2, 2, False, 0.3),
    "sphere_depth3": (1, 3, False, 0.5),
    "sphere_radius": (1, 2, True, 0.5),
}


@pytest.fixture(scope="module")
def fields():
    out = {}
    for name, (nside, depth, radial, scale) in CASES.items():
        out[name] = (jr.RefinementHPField(_chart(jr, nside, depth, radial), _matern(jnp, scale)),
                     tr.RefinementHPField(_chart(tr, nside, depth, radial), _matern(torch, scale)))
    return out


def _latents(domain, seed, lead=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + tuple(v.shape)) for k, v in domain.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _merge_repeats(olf, win):
    """``olf (npix, [nr,] F, 9 [x 3])`` with the columns of each pixel's
    window that name the same coarse pixel summed into the first."""
    olf = np.array(olf, copy=True)
    radial = olf.ndim == 4
    if radial:
        olf = olf.reshape(olf.shape[:3] + (9, 3))
    for p, row in enumerate(win):
        for w in range(9):
            first = int(np.flatnonzero(row == row[w])[0])
            if first != w:
                if radial:
                    olf[p, :, :, first] += olf[p, :, :, w]
                    olf[p, :, :, w] = 0.0
                else:
                    olf[p, :, first] += olf[p, :, w]
                    olf[p, :, w] = 0.0
    return olf


@pytest.mark.parametrize("case", CASES)
def test_charts_match(fields, case):
    jf, tf = fields[case]
    jc, tc = jf.chart, tf.chart
    assert (tc.nsides, tc.shapes, tc.depth) == (jc.nsides, jc.shapes, jc.depth)
    for level in range(tc.depth + 1):
        np.testing.assert_array_equal(tc.positions(level), jc.positions(level))
        if level < tc.depth:
            np.testing.assert_array_equal(tc.neighbor_windows(level), jc.neighbor_windows(level))
    with pytest.raises(ValueError, match="radial"):
        tr.HEALPixChart(1, 2, radial_chart=tr.CoordinateChart(5, depth=1))


@pytest.mark.parametrize("case", CASES)
def test_matrices_match(fields, case):
    jf, tf = fields[case]
    cov_j, olfs_j, kers_j, wins_j = jf._matrices
    cov_t, olfs_t, kers_t, wins_t = tf.matrices()
    _close(cov_t, cov_j)
    for olf_t, olf_j, ker_t, ker_j, win_t, win_j in zip(olfs_t, olfs_j, kers_t, kers_j, wins_t,
                                                          wins_j):
        np.testing.assert_array_equal(win_t.numpy(), win_j)
        _close(ker_t, ker_j)
        _close(_merge_repeats(olf_t.numpy(), win_j), _merge_repeats(olf_j, win_j))
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
    assert got.shape == jf.chart.shapes[-1]
    _close(got, want)
    _close(got_t, want_t)
    cot = np.random.default_rng(3).standard_normal(jf.chart.shapes[-1])
    want_c = jax.vjp(jf, jlat)[1](jnp.asarray(cot))[0]
    got_c = torch.func.vjp(tf, jt.from_numpy(lat))[1](torch.from_numpy(cot))[0]
    for k in want_c:
        _close(got_c[k], want_c[k])


@pytest.mark.parametrize("case", CASES)
def test_leading_batch_axis_matches_vmap(fields, case):
    jf, tf = fields[case]
    lat = _latents(jf.domain, 4, lead=(2,))
    want = jax.vmap(jf)({k: jnp.asarray(v) for k, v in lat.items()})
    _close(tf(jt.from_numpy(lat)), want)


def _implied_covariance(tf):
    zeros = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in tf.domain.items()}
    jac = torch.func.jacfwd(tf)(zeros)
    npts = int(np.prod(tf.chart.shapes[-1]))
    a = np.concatenate([jac[k].reshape(npts, -1).numpy() for k in sorted(jac)], axis=-1)
    return a @ a.T


@pytest.mark.parametrize("radial,bound", [(False, 0.02), (True, 0.05)],
                         ids=["sphere", "sphere_radius"])
def test_implied_covariance_is_the_kernel(radial, bound):
    """``tests/test_refine.py``'s HEALPix covariance checks (Gaussian
    kernels of scale 1 and 1.5) on the port's fields."""
    if radial:
        chart = tr.HEALPixChart(2, depth=1, radial_chart=tr.CoordinateChart(
            6, depth=1, distances0=0.1, nonlinear_map=lambda x: 1.0 + x))
        scale = 1.5
    else:
        chart, scale = tr.HEALPixChart(4, depth=1), 1.0
    tf = tr.RefinementHPField(chart, _gauss(torch, scale))
    pos = chart.positions(chart.depth).reshape(-1, 3)
    exact = _gauss(np, scale)(np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1)))
    assert np.abs(_implied_covariance(tf) - exact).max() < bound


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


@pytest.mark.parametrize("case", ["sphere", "sphere_radius"])
def test_optimize_kl_on_a_sphere_field_matches(fields, case):
    """Gaussian data on the field, short solves (CG 5 steps), the noise
    replayed, lockstep draws: KL energies within 1e-8."""
    jf, tf = fields[case]
    lat = _latents(jf.domain, 5)
    noise = 0.2
    truth = np.asarray(jf({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + noise * np.random.default_rng(6).standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / noise ** 2).amend(jf)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / noise ** 2).amend(tf)
    pos = _latents(jf.domain, 7)
    kwargs = dict(
        n_total_iterations=2, n_samples=2, residual_map="vmap",
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-6, maxiter=3, cg_kwargs=dict(maxiter=5))),
        sample_mode="linear_resample",
    )
    key = jax.random.PRNGKey(8)
    energies_j, energies_t = [], []
    jft.optimize_kl(lh_j, {k: jnp.asarray(v) for k, v in pos.items()}, key=key,
                    callback=lambda s, st: energies_j.append(float(st.minimization_state.fun)),
                    **kwargs)
    tok.optimize_kl(lh_t, jt.from_numpy(pos), key=JaxKey(key),
                    callback=lambda s, st: energies_t.append(float(st.minimization_state.fun)),
                    **kwargs)
    assert len(energies_t) == len(energies_j) == 2
    np.testing.assert_allclose(energies_t, energies_j, rtol=1e-8)
