"""Parity of the port's spherical harmonic transforms on Gauss-Legendre grids
(``nifty_tpu_torch.ops.sht``) with ``nifty_tpu.ops.sht`` on the same numpy
inputs, at lmax 8 and 16 and at mmax 8 < lmax 16, in float64.

Tolerances, relative to the largest entry of the JAX package's output:
the host helpers and index maps are the same arithmetic (1e-12, most are
bitwise); the table transform is one batched matrix product and an FFT
whose summation order differs (1e-12); the on-the-fly transform adds a
recurrence of lmax steps (1e-11).  The float32 recurrence at lmax 300 is
held to its own float64 result within 1e-4 (relative L2 norm), where the
JAX package's float32 result, whose Legendre diagonal underflows, is off by
far more (its error is printed in the assertion message).
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import sht as js  # noqa: E402
from nifty_tpu_torch.ops import sht as ts  # noqa: E402

torch.set_num_threads(1)

CONFIGS = [(8, None), (16, None), (16, 8)]
IDS = ["lmax8", "lmax16", "lmax16_mmax8"]
RTOL = 1e-12
RTOL_OTF = 1e-11


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _alm(n, lmax, seed):
    rng = np.random.default_rng(seed)
    alm = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    alm[: lmax + 1] = alm[: lmax + 1].real
    return alm


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def pair(request):
    lmax, mmax = request.param
    return (js.SphericalHarmonicTransform(lmax, mmax=mmax, dtype=jnp.float64),
            ts.SphericalHarmonicTransform(lmax, mmax=mmax))


@pytest.mark.parametrize("lmax,mmax", CONFIGS, ids=IDS)
def test_host_helpers_match(lmax, mmax):
    for nlat in (lmax + 1, 2 * lmax):
        for a, b in zip(ts.gauss_legendre_quadrature(nlat), js.gauss_legendre_quadrature(nlat)):
            np.testing.assert_array_equal(a, b)
    assert ts.n_alm(lmax, mmax) == js.n_alm(lmax, mmax)
    for m in range(lmax + 1):
        for l in range(m, lmax + 1):
            assert ts.alm_index(l, m, lmax) == js.alm_index(l, m, lmax)
    theta = np.linspace(0.05, 3.1, 9)
    _close(ts.normalized_legendre_table(lmax, theta, mmax),
           js.normalized_legendre_table(lmax, theta, mmax))
    mm = lmax if mmax is None else mmax
    np.testing.assert_array_equal(ts._packed_positions(lmax, mm), js._packed_positions(lmax, mm))


@pytest.mark.parametrize("lmax,mmax", CONFIGS, ids=IDS)
def test_packing_and_real_maps_match(lmax, mmax):
    mm = lmax if mmax is None else mmax
    alm = _alm(ts.n_alm(lmax, mmax), lmax, 1)
    x = np.random.default_rng(2).standard_normal(ts.n_real(lmax, mmax))
    _close(ts.real2alm(torch.from_numpy(x), lmax, mmax),
           jax.jit(lambda v: js.real2alm(v, lmax, mmax))(x))
    _close(ts.alm2real(torch.from_numpy(alm), lmax, mmax),
           jax.jit(lambda a: js.alm2real(a, lmax, mmax))(alm))
    A = ts._unpack_alm_to_matrix(torch.from_numpy(alm), lmax, mm)
    _close(A, jax.jit(lambda a: js._unpack_alm_to_matrix(a, lmax, mm))(alm))
    _close(ts._pack_matrix_to_alm(A, lmax, mm), alm)
    layout = ts.AlmLayout(lmax, mmax)
    # the planes are the dense matrix's real and imaginary parts
    planes = layout.alm2planes(torch.from_numpy(alm))
    _close(planes[0], A.real)
    _close(planes[1], A.imag)
    _close(layout.planes2alm(planes), alm)
    _close(layout.real2planes(torch.from_numpy(x)),
           layout.alm2planes(layout.real2alm(torch.from_numpy(x))))


def test_alm2map_and_map2alm_match(pair):
    jsht, tsht = pair
    alm = _alm(jsht.n_alm, jsht.lmax, 3)
    m_j = np.array(jax.jit(jsht.alm2map)(alm))
    _close(tsht.alm2map(torch.from_numpy(alm)), m_j)
    map2alm_j = jax.jit(jsht.map2alm)
    _close(tsht.map2alm(torch.from_numpy(m_j)), map2alm_j(m_j))
    rng = np.random.default_rng(4)
    maps = rng.standard_normal((2,) + jsht.grid_shape)
    got = tsht.map2alm(torch.from_numpy(maps))
    for i in range(2):
        _close(got[i], map2alm_j(maps[i]))


def test_synthesize_real_and_its_derivatives_match(pair):
    jsht, tsht = pair
    rng = np.random.default_rng(5)
    n = ts.n_real(jsht.lmax, jsht.mmax)
    x, t = rng.standard_normal(n), rng.standard_normal(n)
    ct = rng.standard_normal(jsht.grid_shape)
    synth_j = jax.jit(jsht.synthesize_real)
    y_j, tan_j = jax.jit(lambda a, b: jax.jvp(synth_j, (a,), (b,)))(x, t)
    vjp_j = jax.jit(lambda a, c: jax.vjp(synth_j, a)[1](c)[0])
    y_t, tan_t = torch.func.jvp(tsht.synthesize_real, (torch.from_numpy(x),),
                                (torch.from_numpy(t),))
    _close(y_t, y_j)
    _close(tan_t, tan_j)
    _, vjp_t = torch.func.vjp(tsht.synthesize_real, torch.from_numpy(x))
    _close(vjp_t(torch.from_numpy(ct))[0], vjp_j(x, ct))
    # leading axes are a batch
    xb = torch.from_numpy(rng.standard_normal((3, n)))
    yb = tsht.synthesize_real(xb)
    for i in range(3):
        _close(yb[i], synth_j(xb[i].numpy()))


def test_gl_roundtrip_and_monopole():
    sht = ts.SphericalHarmonicTransform(16)
    alm = torch.from_numpy(_alm(sht.n_alm, 16, 6))
    _close(sht.map2alm(sht.alm2map(alm)), alm)
    y00 = torch.zeros(sht.n_alm, dtype=torch.complex128)
    y00[0] = 1.0
    np.testing.assert_allclose(_np(sht.alm2map(y00)), 1.0 / np.sqrt(4 * np.pi), rtol=1e-12)


@pytest.mark.parametrize("lmax,mmax", [(16, None), (24, 10)], ids=["lmax16", "lmax24_mmax10"])
def test_on_the_fly_matches_jax_and_the_table(lmax, mmax):
    o_j = js.SphericalHarmonicTransformOnTheFly(lmax, mmax=mmax, dtype=jnp.float64)
    o_t = ts.SphericalHarmonicTransformOnTheFly(lmax, mmax=mmax)
    table = ts.SphericalHarmonicTransform(lmax, mmax=mmax)
    alm = _alm(o_j.n_alm, lmax, 7)
    m_j = np.array(jax.jit(o_j.alm2map)(alm))
    m_t = o_t.alm2map(torch.from_numpy(alm))
    _close(m_t, m_j, RTOL_OTF)
    _close(m_t, table.alm2map(torch.from_numpy(alm)), RTOL_OTF)
    _close(o_t.map2alm(m_t), jax.jit(o_j.map2alm)(m_j), RTOL_OTF)
    x = np.random.default_rng(8).standard_normal(ts.n_real(lmax, mmax))
    _close(o_t.synthesize_real(torch.from_numpy(x)), jax.jit(o_j.synthesize_real)(x), RTOL_OTF)


def test_on_the_fly_adjoint_through_autograd():
    """Autograd through the synthesis loop gives its transpose: <S x, y> =
    <x, S^T y>, and the gradient of |S x|^2 is the JAX package's."""
    o = ts.SphericalHarmonicTransformOnTheFly(12)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(13 ** 2))
    y = torch.from_numpy(rng.standard_normal(o.grid_shape))
    _, vjp = torch.func.vjp(o.synthesize_real, x)
    lhs = float(torch.sum(o.synthesize_real(x) * y))
    np.testing.assert_allclose(float(vjp(y)[0] @ x), lhs, rtol=1e-12)
    o_j = js.SphericalHarmonicTransformOnTheFly(12, dtype=jnp.float64)
    g_j = jax.jit(jax.grad(lambda q: jnp.sum(o_j.synthesize_real(q) ** 2)))(x.numpy())
    g_t = torch.func.grad(lambda q: torch.sum(o.synthesize_real(q) ** 2))(x)
    _close(g_t, g_j, RTOL_OTF)


def test_float32_recurrence_keeps_values_below_the_diagonal_range():
    """At lmax 300 the diagonal λ_mm underflows float32 near the poles while
    the rows grow back to O(1); the port's scaled recurrence keeps them."""
    lmax = 300
    alm = _alm(ts.n_alm(lmax), lmax, 10)
    want = ts.SphericalHarmonicTransformOnTheFly(lmax, dtype=torch.float64).alm2map(
        torch.from_numpy(alm)).numpy()
    got = ts.SphericalHarmonicTransformOnTheFly(lmax, dtype=torch.float32).alm2map(
        torch.from_numpy(alm.astype(np.complex64))).numpy()
    ref32 = np.asarray(jax.jit(js.SphericalHarmonicTransformOnTheFly(
        lmax, dtype=jnp.float32).alm2map)(alm.astype(np.complex64)))

    def rel(a):
        return float(np.linalg.norm(a - want) / np.linalg.norm(want))

    msg = (f"port float32 off its float64 by {rel(got):.3e}; the JAX package's float32 by "
           f"{rel(ref32):.3e}")
    assert rel(got) < 1e-4, msg
    assert rel(ref32) > 100 * rel(got), msg
    # in float64 the scaled recurrence is the JAX package's
    ref64 = np.asarray(jax.jit(js.SphericalHarmonicTransformOnTheFly(
        lmax, dtype=jnp.float64).alm2map)(alm))
    _close(want, ref64)
