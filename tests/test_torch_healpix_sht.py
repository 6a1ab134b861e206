"""Parity of the port's HEALPix spherical harmonic synthesis
(``nifty_tpu_torch.ops.healpix_sht``) and of the plain versions of its
longitude stage (``nifty_tpu_torch.ops.hp_longitude``, K10) with
``nifty_tpu.ops.healpix_sht`` on the same numpy inputs, at (lmax 6, nside 4)
and (lmax 15, nside 8), float64.

Tolerances, relative to the largest entry of the JAX package's output:
1e-12 for the transforms, their adjoints, the ring weights and the plain
longitude pair (one matrix product, phases made from φ instead of stored
tables: rounding only); 1e-10 for the CG analysis, whose iterations
amplify that rounding; the adjoint identity <Ax, y> = <x, A^T y> to 1e-12
of |<Ax, y>|.  On the CPU the wrappers run the plain versions; the kernels
themselves are held to them on the card (``test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase 22).
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import healpix_sht as jh  # noqa: E402
from nifty_tpu_torch.ops import healpix as thp  # noqa: E402
from nifty_tpu_torch.ops import healpix_sht as th  # noqa: E402
from nifty_tpu_torch.ops import hp_longitude as hl  # noqa: E402

torch.set_num_threads(1)

CONFIGS = [(6, 4), (15, 8)]
IDS = ["lmax6_nside4", "lmax15_nside8"]
RTOL = 1e-12


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
    lmax, nside = request.param
    return jh.HEALPixSHT(lmax, nside, dtype=jnp.float64), th.HEALPixSHT(lmax, nside)


def test_ring_table_matches(pair):
    j, t = pair
    assert t.nrings == j._nrings == 4 * t.nside - 1
    np.testing.assert_array_equal(t.rings.ring_theta, j._ring_theta)
    np.testing.assert_array_equal(t.rings.ring_of_pix.numpy(), np.asarray(j._ring_of_pix))
    theta, phi = thp.pix2ang(t.nside, np.arange(t.npix))
    np.testing.assert_allclose(t.rings.phi.numpy(), phi, rtol=0, atol=1e-13)
    _close(t.lam, j._lam)
    # rings that are not contiguous (the NESTED order) are refused
    with pytest.raises(ValueError, match="contiguous"):
        hl.HPRings(*thp.pix2ang(t.nside, np.arange(t.npix), nest=True))


def test_synthesis_and_adjoint_match(pair):
    j, t = pair
    alm = _alm(j.n_alm, j.lmax, 1)
    m_j = np.array(jax.jit(j.alm2map)(alm))
    _close(t.alm2map(torch.from_numpy(alm)), m_j)
    _close(t.map2alm_adjoint(torch.from_numpy(m_j)), jax.jit(j.map2alm_adjoint)(m_j))
    x = np.random.default_rng(2).standard_normal(t.layout.n_real)
    _close(t.synthesize_real(torch.from_numpy(x)), jax.jit(j.synthesize_real)(x))


def test_ring_weights_and_analyses_match(pair):
    j, t = pair
    _close(t._get_ring_weights(), j._get_ring_weights())
    alm = _alm(j.n_alm, j.lmax, 3)
    m_j = np.array(jax.jit(j.alm2map)(alm))
    _close(t.map2alm_weighted(torch.from_numpy(m_j)), jax.jit(j.map2alm_weighted)(m_j))
    got = t.map2alm(torch.from_numpy(m_j))
    _close(got, jax.jit(j.map2alm)(m_j), 1e-10)


def test_synthesis_against_direct_spherical_harmonics():
    try:
        from scipy.special import sph_harm_y

        def Y(l, m, th_, ph):
            return sph_harm_y(l, m, th_, ph)
    except ImportError:
        from scipy.special import sph_harm

        def Y(l, m, th_, ph):
            return sph_harm(m, l, ph, th_)

    lmax, nside = 6, 4
    sht = th.HEALPixSHT(lmax, nside)
    alm = _alm(sht.n_alm, lmax, 4)
    mp = sht.alm2map(torch.from_numpy(alm)).numpy()
    theta, phi = thp.pix2ang(nside, np.arange(sht.npix))
    for p in np.random.default_rng(5).integers(0, sht.npix, size=6):
        v = sum((alm[l + m * (2 * lmax + 1 - m) // 2] * Y(l, m, theta[p], phi[p])).real
                * (1 if m == 0 else 2) for l in range(lmax + 1) for m in range(l + 1))
        np.testing.assert_allclose(mp[p], v, atol=1e-11)


@pytest.mark.parametrize("lmax,nside", CONFIGS, ids=IDS)
def test_plain_longitude_pair_matches_the_jax_primitives(lmax, nside):
    j = jh.HEALPixSHT(lmax, nside, dtype=jnp.float64)
    rings = hl.healpix_rings(nside)
    nm = lmax + 1
    rng = np.random.default_rng(6)
    F = np.zeros((2, j._m_padded, j._nrings))
    F[:, :nm] = rng.standard_normal((2, nm, j._nrings))
    c = j.consts
    want = jh._hp_fwd_impl(jnp.asarray(F), c["cos"], c["sin"], c["ring_of_pix"], chunk=j._chunk)
    _close(hl.hp_longitude_plain(torch.from_numpy(F[None, :, :nm]), rings)[0], want)
    ct = rng.standard_normal(j.npix)
    want = jh._hp_adj_impl(jnp.asarray(ct), c["cos"], c["sin"], c["ring_of_pix"],
                           chunk=j._chunk, nrings=j._nrings)[:, :nm]
    _close(hl.hp_longitude_adjoint_plain(torch.from_numpy(ct[None]), rings, nm)[0], want)


@pytest.mark.parametrize("lmax,nside", CONFIGS, ids=IDS)
def test_stored_phase_tables_and_error_scale(lmax, nside):
    """The whole phase tables equal the JAX package's stored tables, the
    plain pair reading them equals the pair making its chunks, and the
    per-output sum of |term| bounds every output."""
    j = jh.HEALPixSHT(lmax, nside, dtype=jnp.float64)
    rings = hl.healpix_rings(nside)
    nm = lmax + 1
    cos, sin = hl.phase_tables(rings, nm, torch.float64)
    _close(cos.T, _np(j.consts["cos"])[:, :nm])
    _close(sin.T, _np(j.consts["sin"])[:, :nm])
    rng = np.random.default_rng(8)
    F = torch.from_numpy(rng.standard_normal((2, 2, nm, rings.nrings)))
    ct = torch.from_numpy(rng.standard_normal((2, rings.npix)))
    y, g = hl.hp_longitude_plain(F, rings), hl.hp_longitude_adjoint_plain(ct, rings, nm)
    assert torch.equal(hl.hp_longitude_plain(F, rings, (cos, sin)), y)
    assert torch.equal(hl.hp_longitude_adjoint_plain(ct, rings, nm, (cos, sin)), g)
    assert bool(torch.all(y.abs() <= hl.sum_abs_terms(rings, F=F) * (1 + RTOL)))
    assert bool(torch.all(g.abs() <= hl.sum_abs_terms(rings, ct=ct) * (1 + RTOL)))


@pytest.mark.parametrize("lmax,nside", CONFIGS, ids=IDS)
def test_longitude_pair_adjoint_identity_and_rows(lmax, nside):
    rings = hl.healpix_rings(nside)
    nm = lmax + 1
    rng = np.random.default_rng(7)
    F = torch.from_numpy(rng.standard_normal((3, 2, nm, rings.nrings)))
    ct = torch.from_numpy(rng.standard_normal((3, rings.npix)))
    out = hl.hp_longitude(F, rings)
    back = hl.hp_longitude_adjoint(ct, rings, nm)
    lhs, rhs = float(torch.sum(out * ct)), float(torch.sum(F * back))
    assert abs(lhs - rhs) <= RTOL * abs(lhs)
    for b in range(3):
        _close(out[b:b + 1], hl.hp_longitude(F[b:b + 1].contiguous(), rings))
        _close(back[b:b + 1], hl.hp_longitude_adjoint(ct[b:b + 1].contiguous(), rings, nm))
    with pytest.raises(ValueError):
        hl.hp_longitude(F[:, :, :, :-1].contiguous(), rings)
    with pytest.raises(ValueError):
        hl.hp_longitude_adjoint(ct.t(), rings, nm)


def test_autograd_pair_jvp_vmap_and_double_backward():
    nside, nm = 4, 7
    rings = hl.healpix_rings(nside)
    rng = np.random.default_rng(8)
    F = torch.from_numpy(rng.standard_normal((2, 2, nm, rings.nrings)))
    dF = torch.from_numpy(rng.standard_normal(F.shape))
    ct = torch.from_numpy(rng.standard_normal((2, rings.npix)))
    dct = torch.from_numpy(rng.standard_normal(ct.shape))
    # jvp: each is linear, so its tangent is itself applied to the tangent
    _, t1 = torch.func.jvp(lambda f: hl.HpLongitude.apply(f, rings), (F,), (dF,))
    _close(t1, hl.hp_longitude(dF, rings))
    _, t2 = torch.func.jvp(lambda c: hl.HpLongitudeAdjoint.apply(c, rings, nm), (ct,), (dct,))
    _close(t2, hl.hp_longitude_adjoint(dct, rings, nm))
    # vjp: the other one
    _, vjp = torch.func.vjp(lambda f: hl.HpLongitude.apply(f, rings), F)
    _close(vjp(ct)[0], hl.hp_longitude_adjoint(ct, rings, nm))
    _, vjp = torch.func.vjp(lambda c: hl.HpLongitudeAdjoint.apply(c, rings, nm), ct)
    _close(vjp(F)[0], hl.hp_longitude(F, rings))
    # vmap over a leading axis of rows
    Fv = torch.stack([F, 2 * F, -F])
    out = torch.func.vmap(lambda f: hl.HpLongitude.apply(f, rings))(Fv)
    _close(out[1], 2 * hl.hp_longitude(F, rings))
    cv = torch.stack([ct, -ct])
    back = torch.func.vmap(lambda c: hl.HpLongitudeAdjoint.apply(c, rings, nm))(cv)
    _close(back[1], -hl.hp_longitude_adjoint(ct, rings, nm))
    # double backward: the gradient of |A F|^2 is 2 A^T A F, and its
    # derivative along dF runs both Functions again
    Fg = F.clone().requires_grad_(True)
    y = hl.HpLongitude.apply(Fg, rings)
    (h,) = torch.autograd.grad(torch.sum(y ** 2), Fg, create_graph=True)
    (hv,) = torch.autograd.grad(h, Fg, dF)
    _close(hv, 2 * hl.hp_longitude_adjoint(hl.hp_longitude(dF, rings), rings, nm))
