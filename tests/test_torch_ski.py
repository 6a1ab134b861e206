"""Parity of the port's structured kernel interpolation (``responses/ski.py``:
the interpolation tables, K11's plain versions as ``W`` and ``W^T``, the
Toeplitz and BTTB products, ``HarmonicSKI``, ``ToeplitzSKI`` and
``StructuredKernelInterpolation``) with ``nifty_tpu`` from the same numpy
inputs, float64.

Tolerances: ``interpolation_matrix`` is host numpy in both packages and
agrees bit for bit; everything else agrees to 1e-12 of the largest entry
(FFTs and sums in another order).
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.responses import ski as jski  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.ops import los_interp as li  # noqa: E402
from nifty_tpu_torch.responses import ski as tski  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _se_kernel(xp, l):
    return lambda r: xp.exp(-(r ** 2) / (2 * l ** 2))


def _se_harmonic(xp, l, ndim):
    # Continuous FT of the squared-exponential, xi in cycles/length.
    return lambda k: (2 * np.pi) ** (ndim / 2) * l ** ndim * xp.exp(-2 * np.pi ** 2 * l ** 2
                                                                    * k ** 2)


GRIDS = {
    "1d": ((32,), ((0.0, 4.0),), 40),
    "2d": ((12, 10), ((0.0, 3.0), (-1.0, 1.0)), 25),
    "3d": ((6, 7, 5), ((0.0, 1.0), (0.0, 2.0), (-1.0, 0.5)), 30),
}


def _points(case, seed=0):
    shape, bounds, n = GRIDS[case]
    rng = np.random.default_rng(seed)
    b = np.asarray(bounds)
    # a few points outside the grid: the indices clip there
    lo, hi = b[:, 0] - 0.05 * (b[:, 1] - b[:, 0]), b[:, 1] + 0.05 * (b[:, 1] - b[:, 0])
    return shape, bounds, rng.uniform(lo[:, None], hi[:, None], size=(len(shape), n))


@pytest.mark.parametrize("case", GRIDS)
def test_interpolation_matrix_bit_for_bit(case):
    shape, bounds, pts = _points(case)
    for kw in (dict(grid_bounds=bounds), dict(grid_bounds=None, distances=0.3)):
        ij, wj = jski.interpolation_matrix(shape, sampling_points=pts, **kw)
        it, wt = tski.interpolation_matrix(shape, sampling_points=pts, **kw)
        np.testing.assert_array_equal(it, np.asarray(ij))
        np.testing.assert_array_equal(wt, np.asarray(wj))


@pytest.mark.parametrize("case", GRIDS)
def test_apply_and_adjoint_interpolation(case):
    shape, bounds, pts = _points(case, 1)
    idx, w = tski.interpolation_matrix(shape, bounds, pts)
    n = int(np.prod(shape))
    table = tski.interpolation_table(idx, w, n)
    rng = np.random.default_rng(2)
    f, v = rng.standard_normal(n), rng.standard_normal(pts.shape[1])
    _close(tski.apply_interpolation(table, torch.from_numpy(f)),
           jski.apply_interpolation(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(f)))
    _close(tski.adjoint_interpolation(table, torch.from_numpy(v)),
           jski.adjoint_interpolation(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(v), n))
    # rows: a batch of fields is interpolated row by row
    f2 = rng.standard_normal((3, n))
    _close(tski.apply_interpolation(table, torch.from_numpy(f2)),
           jax.vmap(lambda x: jski.apply_interpolation(jnp.asarray(idx), jnp.asarray(w), x))(
               jnp.asarray(f2)))
    assert li.los_integrate.launches == 0


@pytest.mark.parametrize("kind", ["real", "complex", "matrix"])
def test_matmul_toeplitz(kind):
    rng = np.random.default_rng(3)
    c = rng.standard_normal(9)
    x = rng.standard_normal((9, 4) if kind == "matrix" else 9)
    if kind == "complex":
        c = c + 1j * rng.standard_normal(9)
    _close(tski.matmul_toeplitz(torch.from_numpy(c), torch.from_numpy(x)),
           jski.matmul_toeplitz(jnp.asarray(c), jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(7, 5), (4, 5, 6)], ids=["2d", "3d"])
def test_matmul_bttb(shape):
    rng = np.random.default_rng(4)
    row, x = rng.standard_normal(shape), rng.standard_normal(shape)
    _close(tski.matmul_bttb(torch.from_numpy(row), torch.from_numpy(x)),
           jski.matmul_bttb(jnp.asarray(row), jnp.asarray(x)))


def _harmonic_pair(case="2d", padding=0.5, jitter=False, subslice=None):
    shape, bounds, pts = _points(case, 5)
    ndim = len(shape)
    kw = dict(padding=padding, jitter=jitter, subslice=subslice)
    return (jft.HarmonicSKI(shape, bounds, pts, harmonic_kernel=_se_harmonic(jnp, 0.3, ndim),
                            **kw),
            jt.HarmonicSKI(shape, bounds, pts, harmonic_kernel=_se_harmonic(torch, 0.3, ndim),
                           **kw), pts.shape[1])


@pytest.mark.parametrize("case,padding,jitter", [("1d", 0.5, True), ("2d", 0.5, False),
                                                 ("2d", 1.0, 1e-6), ("3d", 0.0, False)])
def test_harmonic_ski_methods(case, padding, jitter):
    sj, st, npts = _harmonic_pair(case, padding, jitter)
    assert st.grid_shape == sj.grid_shape and st.jitter == sj.jitter
    assert st.grid_total_volume == sj.grid_total_volume
    _close(st.power(), sj.power())
    _close(st.amplitude(), sj.amplitude())
    rng = np.random.default_rng(6)
    xg = rng.standard_normal(sj.grid_shape)
    _close(st.harmonic_transform(torch.from_numpy(xg)), sj.harmonic_transform(jnp.asarray(xg)))
    _close(st.correlated_field(torch.from_numpy(xg)), sj.correlated_field(jnp.asarray(xg)))
    xs = rng.standard_normal(sj.grid_unpadded_shape if sj.grid_subslice is not None
                             else sj.grid_shape)
    _close(st.sandwich(torch.from_numpy(xs)), sj.sandwich(jnp.asarray(xs)))
    v = rng.standard_normal(npts)
    _close(st(torch.from_numpy(v)), sj(jnp.asarray(v)))
    _close(st.evaluate(), sj.evaluate())
    kern = _se_kernel(np, 0.3)
    np.testing.assert_array_equal(st.evaluate_(kern), sj.evaluate_(kern))


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_toeplitz_ski(case):
    shape, bounds, pts = _points(case, 7)
    sj = jft.ToeplitzSKI(shape, bounds, pts, kernel=_se_kernel(jnp, 0.5))
    st = jt.ToeplitzSKI(shape, bounds, pts, kernel=_se_kernel(torch, 0.5))
    v = np.random.default_rng(8).standard_normal(pts.shape[1])
    _close(st(torch.from_numpy(v)), sj(jnp.asarray(v)))
    _close(st.evaluate(), sj.evaluate())
    np.testing.assert_array_equal(st.evaluate_(_se_kernel(np, 0.5)),
                                  sj.evaluate_(_se_kernel(np, 0.5)))


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_structured_kernel_interpolation_model(case):
    shape, bounds, pts = _points(case, 9)

    def amp(xp):
        return lambda k: 1.0 / (1.0 + (k / 3.0) ** 2)

    mj = jft.StructuredKernelInterpolation(shape, bounds, pts, amp(jnp), padding=0.5)
    mt = jt.StructuredKernelInterpolation(shape, bounds, pts, amp(torch), padding=0.5)
    assert mt.domain.shape == tuple(mj.domain.shape)
    rng = np.random.default_rng(10)
    x, tan = rng.standard_normal(mj.domain.shape), rng.standard_normal(mj.domain.shape)
    ct = rng.standard_normal(pts.shape[1])
    y_j, pull = jax.vjp(mj, jnp.asarray(x))
    _, tan_j = jax.jvp(mj, (jnp.asarray(x),), (jnp.asarray(tan),))
    y_t, fwd, bwd = linearize(mt, torch.from_numpy(x))
    _close(y_t, y_j)
    _close(fwd(torch.from_numpy(tan)), tan_j)
    _close(bwd(torch.from_numpy(ct)), pull(jnp.asarray(ct))[0])
    # leading batch axes are rows
    x2 = rng.standard_normal((2, *mj.domain.shape))
    _close(mt(torch.from_numpy(x2)), jax.vmap(mj)(jnp.asarray(x2)))
