"""The ring FFT form of the HEALPix longitude stage (K10) on the CPU.

``hp_longitude_fft_route`` / ``hp_longitude_adjoint_fft_route`` (``torch.fft``,
one batched transform a distinct ring length) against the plain versions
and against the JAX package's primitives (``nifty_tpu.ops.healpix_sht``,
float64, numpy inputs from a seed), at nside 4 and 8 with nm below and
above the smallest ring's length (the fold modulo n), at nside 3 and 6
(equatorial rings of 12 and 24 pixels, not powers of two), and on
synthetic rings of prime lengths (7, 13, 97; against the plain versions
only, since the JAX primitives are tied to a HEALPix grid).  Tolerance:
1e-12 of the per-output sum of |term| (``sum_abs_terms``), 1e-5 in float32.

The tables ``HPRings`` builds for the kernel: the chirps and roots of unity
against ``exp`` in numpy's extended precision (``np.longdouble``) at 1e-15
(the same expression in float64 rounds ``π·q/n`` first, an error of that
size for phases near 2π), and the kernel's algorithm written in numpy from
exactly those tables (in-place radix-2² passes, Bluestein's chirp-z through
a decimation-in-frequency and a decimation-in-time transform) against
``np.fft.fft`` at 1e-13 of the largest output, for every ring of nside 256,
every ring length of nside 2048 (Bluestein's L up to 16384) and the prime
lengths; and where the kernel runs each ring: in shared memory up to
``MAX_SHARED_LEN``, else in the workspace.
"""

import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import healpix_sht as jh  # noqa: E402
from nifty_tpu_torch.ops import hp_longitude as hl  # noqa: E402

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
PRIMES = (7, 13, 97)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def prime_rings(lengths=PRIMES):
    """Evenly spaced rings of the given lengths at made-up colatitudes."""
    theta = np.repeat(np.linspace(0.5, 2.5, len(lengths)), lengths)
    phi = np.concatenate([0.1 * (i + 1) + 2 * np.pi * np.arange(n) / n
                          for i, n in enumerate(lengths)])
    return hl.HPRings(theta, phi)


def _within(got, want, scale, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= RTOL[dtype] * np.asarray(scale))


def _inputs(rings, nm, nrows, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    F = torch.from_numpy(rng.standard_normal((nrows, 2, nm, rings.nrings))).to(dtype)
    ct = torch.from_numpy(rng.standard_normal((nrows, rings.npix))).to(dtype)
    return F, ct


def _against_plain(rings, F, ct, nm):
    y, g = hl.hp_longitude_fft_route(F, rings), hl.hp_longitude_adjoint_fft_route(ct, rings, nm)
    assert y.dtype == g.dtype == F.dtype
    _within(y, hl.hp_longitude_plain(F, rings), hl.sum_abs_terms(rings, F=F), F.dtype)
    _within(g, hl.hp_longitude_adjoint_plain(ct, rings, nm), hl.sum_abs_terms(rings, ct=ct),
            F.dtype)
    return y, g


# nside 4 and 8: nm below and above the smallest ring's 4 pixels; nside 3
# and 6: rings of 12 and 24 pixels
@pytest.mark.parametrize("nside,nm", [(4, 3), (4, 7), (8, 4), (8, 16), (3, 5), (6, 30)])
def test_fft_route_matches_plain_and_jax(nside, nm):
    rings = hl.healpix_rings(nside)
    j = jh.HEALPixSHT(nm - 1, nside, dtype=jnp.float64)
    F, ct = _inputs(rings, nm, 2, seed=nside * 100 + nm)
    y, g = _against_plain(rings, F, ct, nm)
    c = j.consts
    F2 = np.zeros((2, j._m_padded, j._nrings))
    for b in range(2):
        F2[:, :nm] = F[b].numpy()
        want = jh._hp_fwd_impl(jnp.asarray(F2), c["cos"], c["sin"], c["ring_of_pix"],
                               chunk=j._chunk)
        _within(y[b], want, hl.sum_abs_terms(rings, F=F[b:b + 1])[0], torch.float64)
        want = jh._hp_adj_impl(jnp.asarray(ct[b].numpy()), c["cos"], c["sin"], c["ring_of_pix"],
                               chunk=j._chunk, nrings=j._nrings)[:, :nm]
        _within(g[b], want, hl.sum_abs_terms(rings, ct=ct[b:b + 1])[0], torch.float64)


@pytest.mark.parametrize("nm", [5, 20, 120])
def test_fft_route_on_prime_rings(nm):
    rings = prime_rings()
    assert rings.ring_len.tolist() == list(PRIMES)
    _against_plain(rings, *_inputs(rings, nm, 3, seed=nm), nm)


@pytest.mark.parametrize("grid", [8, "primes"])
def test_fft_route_in_float32(grid):
    rings = prime_rings() if grid == "primes" else hl.healpix_rings(grid)
    _against_plain(rings, *_inputs(rings, 40, 2, seed=1, dtype=torch.float32), 40)


# -- the kernel's tables and its algorithm, in numpy --------------------------


def _complex(t):
    return t.numpy().view(np.complex128).ravel()


def _cis_ld(q, d):
    """``e^{iπ q/d}`` in numpy's extended precision."""
    ang = np.arccos(np.longdouble(-1)) * np.asarray(q).astype(np.longdouble) / d
    return np.cos(ang) + 1j * np.sin(ang)


def _dif(buf, roots):
    """The kernel's ``fft_dif``: in place, natural order in, bit-reversed
    out; radix-2² passes (spans 2h and h), then span 1 where log2 L is odd."""
    L = buf.shape[-1]
    lh = L.bit_length() - 3
    while lh >= 0:
        h = 1 << lh
        t = np.arange(L >> 2)
        j = t & (h - 1)
        base = ((t >> lh) << (lh + 2)) + j
        a, b = roots[2 * h - 1 + j], roots[h - 1 + j]
        x0, x1, x2, x3 = (buf[..., base + q * h] for q in range(4))
        y0, y2 = x0 + x2, (x0 - x2) * a
        y1, y3 = x1 + x3, (x1 - x3) * -1j * a
        buf[..., base], buf[..., base + h] = y0 + y1, (y0 - y1) * b
        buf[..., base + 2 * h], buf[..., base + 3 * h] = y2 + y3, (y2 - y3) * b
        lh -= 2
    if lh == -1:
        x0, x1 = buf[..., 0::2].copy(), buf[..., 1::2].copy()
        buf[..., 0::2], buf[..., 1::2] = x0 + x1, x0 - x1


def _dit(buf, roots):
    """The kernel's ``fft_dit``: bit-reversed order in, natural out; span 1
    first where log2 L is odd, then radix-2² passes (spans h and 2h)."""
    L = buf.shape[-1]
    log_len = L.bit_length() - 1
    lh = 0
    if log_len & 1:
        x0, x1 = buf[..., 0::2].copy(), buf[..., 1::2].copy()
        buf[..., 0::2], buf[..., 1::2] = x0 + x1, x0 - x1
        lh = 1
    while lh + 2 <= log_len:
        h = 1 << lh
        t = np.arange(L >> 2)
        j = t & (h - 1)
        base = ((t >> lh) << (lh + 2)) + j
        a, b = roots[2 * h - 1 + j], roots[h - 1 + j]
        x0, x1, x2, x3 = (buf[..., base + q * h] for q in range(4))
        y0, y1 = x0 + x1 * b, x0 - x1 * b
        y2, y3 = x2 + x3 * b, x2 - x3 * b
        u, v = y2 * a, y3 * a * -1j
        buf[..., base], buf[..., base + 2 * h] = y0 + u, y0 - u
        buf[..., base + h], buf[..., base + 3 * h] = y1 + v, y1 - v
        lh += 2


def _kernel_dft(x, rings, r):
    """``DFT_n(x)`` along the last axis for ring ``r``, as the kernel runs
    it from the ring's tables."""
    n, at = int(rings.ring_len[r]), int(rings.chirp_at[r])
    section = None if at < 0 else _complex(rings.chirp)[at:at + n + int(rings.fft_len_np[r])]
    return _dft_from_tables(x, _complex(rings.roots), section)


def _dft_from_tables(x, roots, section=None):
    """``DFT_n(x)`` along the last axis as the kernel runs it from the roots
    of unity and, for a length not a power of two, its
    :func:`chirp_section` (the kernel runs the innermost stages, whose
    twiddles are 1, and Bluestein's filter as one step without the
    multiplications by 1)."""
    n = x.shape[-1]
    L = hl.fft_length(n)
    buf = np.zeros(x.shape[:-1] + (L,), dtype=complex)
    if section is None:
        buf[..., hl.bit_reversed(L)] = x
        _dit(buf, roots)
        return buf
    w, filt = section[:n], section[n:]
    buf[..., :n] = x * w.conj()
    _dif(buf, roots)
    buf = (buf * filt).conj()
    _dit(buf, roots)
    return (w * buf[..., :n]).conj()


@pytest.mark.parametrize("grid", ["nside256", "primes"])
def test_tables_match_numpy(grid):
    rings = hl.healpix_rings(256) if grid == "nside256" else prime_rings(PRIMES + (1, 2, 64))
    n, L = rings.ring_len, rings.fft_len_np
    pow2 = (n & (n - 1)) == 0
    assert np.array_equal(L[pow2], n[pow2])
    assert np.all(L[~pow2] >= 2 * n[~pow2] - 1) and np.all(L[~pow2] < 4 * n[~pow2] - 2)
    assert np.all((L & (L - 1)) == 0)
    assert np.all(rings.chirp_at.numpy()[pow2] == -1)
    roots = _complex(rings.roots)
    assert roots.size == L.max() - 1
    M = 2
    while M <= L.max():
        j = np.arange(M // 2)
        assert np.max(np.abs(roots[M // 2 - 1 + j] - _cis_ld(-2 * j, M))) <= 1e-15
        M *= 2
    chirp = _complex(rings.chirp)
    for length in np.unique(n[~pow2]):
        at = {int(a) for a in rings.chirp_at.numpy()[n == length]}
        assert len(at) == 1
        at = at.pop()
        t = np.arange(length, dtype=np.int64)
        assert np.max(np.abs(chirp[at:at + length] - _cis_ld(t * t % (2 * length), length))) \
            <= 1e-15
    assert rings.smem_bytes(1, adjoint=True) == 16 * L.max()
    # the blocks take the rings costliest first, every ring once
    order = rings.block_ring.numpy()
    assert np.array_equal(np.sort(order), np.arange(rings.nrings))
    assert np.all(np.diff((L * (1 + ~pow2))[order]) <= 0)


@pytest.mark.parametrize("grid", ["nside256", "primes"])
def test_kernel_algorithm_from_the_tables_matches_numpy_fft(grid):
    rings = hl.healpix_rings(256) if grid == "nside256" else prime_rings(PRIMES + (1, 2, 64))
    rng = np.random.default_rng(11)
    for r, length in enumerate(rings.ring_len):
        x = rng.standard_normal((2, length)) + 1j * rng.standard_normal((2, length))
        want = np.fft.fft(x)
        assert np.max(np.abs(_kernel_dft(x, rings, r) - want)) <= 1e-13 * np.max(np.abs(want))


def test_shared_memory_of_the_fold_and_its_limit():
    rings = hl.healpix_rings(256)
    # synthesis at nm 512: rings of fewer pixels (L <= 1024) add nm for the
    # fold, still below the 2048 of the longest Bluestein transform
    assert rings.smem_bytes(512, adjoint=False) == rings.smem_bytes(512, adjoint=True) == 32768
    assert rings.smem_bytes(2000, adjoint=False) == 16 * (2048 + 2000)


def test_kernel_algorithm_is_nearer_the_exact_sums_than_the_plain_versions():
    """On an equatorial ring (256 pixels) and a polar one (252, Bluestein)
    at nside 64, nm 256, the kernel's algorithm from the tables is within
    1e-14 of the per-output sum of |term| of the sums taken in extended
    precision, closer than the plain versions, which round ``m·φ_p``: the
    kernel's difference from them is theirs."""
    rings, nm = hl.healpix_rings(64), 256
    F, ct = _inputs(rings, nm, 1, seed=5)
    y_plain = hl.hp_longitude_plain(F, rings)[0].numpy()
    g_plain = hl.hp_longitude_adjoint_plain(ct, rings, nm)[0].numpy()
    pi_ld = np.arccos(np.longdouble(-1))
    m = np.arange(nm)
    for r in (127, 62):
        p0, n = int(rings.ring_start[r]), int(rings.ring_len[r])
        phi0 = float(rings.phi0[r])
        phi = np.longdouble(phi0) + 2 * pi_ld * np.arange(n, dtype=np.longdouble) / n
        arg = m.astype(np.longdouble)[:, None] * phi[None, :]
        f = F[0, :, :, r].numpy()
        c = ct[0, p0:p0 + n].numpy()
        y_exact = (f[0][:, None] * np.cos(arg) - f[1][:, None] * np.sin(arg)).sum(0)
        g_exact = np.stack([(np.cos(arg) * c).sum(1), -(np.sin(arg) * c).sum(1)])
        # the synthesis: turn, fold modulo n, transform conj(H); the adjoint:
        # transform, read bin m mod n, turn back
        turn = np.exp(1j * (m * phi0))
        h = np.zeros(n, dtype=complex)
        np.add.at(h, m % n, (f[0] + 1j * f[1]) * turn)
        y = _kernel_dft(h.conj(), rings, r).real
        x = _kernel_dft(c.astype(complex), rings, r)[m % n] * turn.conj()
        g = np.stack([x.real, x.imag])
        terms_y, terms_g = np.abs(f[0] + 1j * f[1]).sum(), np.abs(c).sum()
        err_y, err_g = np.abs(y - y_exact).max(), np.abs(g - g_exact).max()
        assert err_y <= 1e-14 * terms_y and err_g <= 1e-14 * terms_g
        assert err_y < np.abs(y_plain[p0:p0 + n] - y_exact).max()
        assert err_g < np.abs(g_plain[:, :, r] - g_exact).max()


def _healpix_ring_lengths(nside):
    """The pixels of each ring of a HEALPix grid, north to south: 4i on the
    polar caps (i < nside), 4 nside on the 2 nside + 1 rings between."""
    cap = 4 * np.arange(1, nside)
    return np.concatenate([cap, np.full(2 * nside + 1, 4 * nside), cap[::-1]])


def test_tables_and_algorithm_at_every_ring_length_of_nside_2048():
    """Every distinct ring length of nside 2048 (polar rings up to 8188
    pixels, Bluestein's L up to 16384, and the 8192 of the equatorial belt):
    the chirp against extended precision at 1e-15, and the kernel's
    algorithm from the tables against ``np.fft.fft`` at 1e-13."""
    for nside in (3, 8):
        assert np.array_equal(_healpix_ring_lengths(nside), hl.healpix_rings(nside).ring_len)
    lengths = np.unique(_healpix_ring_lengths(2048))
    assert lengths.size == 2048 and lengths.max() == 8192
    L = np.array([hl.fft_length(n) for n in lengths])
    assert L.max() == 16384 and np.sum(L > hl.MAX_SHARED_LEN) == np.sum(lengths > 4096) - 1
    roots = hl.fft_roots(L.max())
    rng = np.random.default_rng(2048)
    for n in lengths:
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        section = None
        if hl.fft_length(n) != n:
            section = hl.chirp_section(n)
            t = np.arange(n, dtype=np.int64)
            assert np.max(np.abs(section[:n] - _cis_ld(t * t % (2 * n), n))) <= 1e-15
        want = np.fft.fft(x)
        assert np.max(np.abs(_dft_from_tables(x, roots, section) - want)) \
            <= 1e-13 * np.max(np.abs(want))


def test_long_transforms_run_in_the_workspace():
    """Transforms longer than ``MAX_SHARED_LEN`` (the Bluestein rings of more
    than 4096 pixels, a power of two above 8192) each take their own slice
    of a row's workspace; the others, and the fold's slab, stay in shared
    memory, within what a thread block holds."""
    rings = prime_rings((7, 4097, 13, 8192, 8188, 16384))
    L = rings.fft_len_np
    assert L.tolist() == [16, 16384, 32, 8192, 16384, 16384]
    ws_at = rings.ws_at.numpy()
    assert ws_at.tolist() == [-1, 0, -1, -1, 16384, 32768]
    assert rings.ws_row == 3 * 16384
    assert rings.smem_bytes(1, adjoint=True) == rings.smem_bytes(20, adjoint=False) == 16 * 8192
    # nm above 8192 folds into the ring of 8192 pixels too: its transform
    # and the slab of FOLD_SLAB turned coefficients
    assert rings.smem_bytes(9000, adjoint=False) == 16 * (8192 + hl.FOLD_SLAB) <= hl.MAX_SMEM
    assert rings.smem_bytes(9000, adjoint=True) == 16 * 8192
    assert hl.healpix_rings(8).ws_row == 0
    assert np.all(hl.healpix_rings(8).ws_at.numpy() == -1)
