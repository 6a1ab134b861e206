"""Spherical harmonic transforms on Gauss-Legendre grids (counterpart of
:mod:`nifty_tpu.ops.sht`).

The transform is dense linear algebra in two stages:

- the Legendre stage ``F[m, θ] = Σ_l λ_lm(θ) a_lm``, an m-batched matrix
  product (``torch.bmm``) of the precomputed table ``λ (mmax+1, nlat,
  lmax+1)`` against the real and imaginary planes of the coefficients, the
  rows of a batch side by side as ``2 B`` columns;
- the longitude stage, ``torch.fft.irfft`` / ``rfft`` along φ.

Synthesis: ``map = irfft(nphi · F)``; analysis on a Gauss-Legendre grid is
exact for band-limited maps: ``a_lm = Σ_θ (2π / nphi) w_θ λ_lm(θ)
rfft(map)[θ, m]``.

Coefficients are packed as in the JAX package (healpy's order, m-major):
complex ``alm`` of :func:`n_alm` entries, or ``(lmax+1)^2`` real
coefficients (:func:`real2alm`).  Inside the transforms they travel as
dense real planes ``(..., 2, mmax+1, lmax+1)`` (real part, imaginary part;
zero for ``l < m``), reached from either packing by one index map
(:class:`AlmLayout`), so autograd and ``torch.func.jvp`` meet no complex
view on the path of :meth:`SphericalHarmonicTransform.synthesize_real`.

The Legendre table is host precompute in float64 (stable diagonal and
three-term recurrences, Condon-Shortley phase) held as a buffer of the
transform; a call in float32 reads a float32 copy made once.

:class:`SphericalHarmonicTransformOnTheFly` builds the Legendre rows inside
a Python loop over ``l`` instead of storing the table, carrying the
diagonal's exponent apart from its mantissa so that float32 keeps the
values that grow back from below its range.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import config


def gauss_legendre_quadrature(nlat: int) -> Tuple[np.ndarray, np.ndarray]:
    """Colatitudes (ascending) and quadrature weights for ∫ dcosθ."""
    x, w = np.polynomial.legendre.leggauss(nlat)
    return np.arccos(x[::-1]), w[::-1]


def n_alm(lmax: int, mmax: Optional[int] = None) -> int:
    mmax = lmax if mmax is None else mmax
    return (mmax + 1) * (lmax + 1) - (mmax * (mmax + 1)) // 2


def alm_index(l, m, lmax: int):
    """healpy-compatible index of (l, m) in the packed alm array."""
    return (m * (2 * lmax + 1 - m)) // 2 + l


def n_real(lmax: int, mmax: Optional[int] = None) -> int:
    """Real coefficients of a band limit: the m = 0 column and two an (l, m > 0)."""
    mmax = lmax if mmax is None else mmax
    return 2 * n_alm(lmax, mmax) - (lmax + 1)


def normalized_legendre_table(lmax: int, theta: np.ndarray,
                              mmax: Optional[int] = None) -> np.ndarray:
    """λ_lm(θ) with Y_lm = λ_lm e^{imφ}; shape (mmax+1, nlat, lmax+1).

    Stable recurrences in float64:
      λ_00 = 1/sqrt(4π)
      λ_mm = -sqrt(1 + 1/(2m)) sinθ λ_{m-1,m-1}            (diagonal, CS phase)
      λ_lm = a_l [cosθ λ_{l-1,m} - b_l λ_{l-2,m}],
      a_l = sqrt((4l²-1)/(l²-m²)), b_l = sqrt(((l-1)²-m²)/(4(l-1)²-1)).

    The l recurrence runs for every m at once; each entry is computed by
    the same operations as one m at a time.
    """
    mmax = lmax if mmax is None else mmax
    theta = np.asarray(theta, dtype=np.float64)
    nlat = theta.size
    ct, st = np.cos(theta), np.sin(theta)
    lam = np.zeros((mmax + 1, nlat, lmax + 1))
    diag = np.empty((mmax + 1, nlat))
    row = np.full(nlat, 1.0 / np.sqrt(4.0 * np.pi))
    for m in range(mmax + 1):
        if m > 0:
            row = -np.sqrt(1.0 + 1.0 / (2.0 * m)) * st * row
        diag[m] = row
        lam[m, :, m] = row
    ms = np.arange(mmax + 1, dtype=np.float64)
    prev = np.zeros((mmax + 1, nlat))
    prev2 = np.zeros((mmax + 1, nlat))
    for l in range(1, lmax + 1):
        # rows m < l continue their recurrence; row m == l starts at its
        # diagonal (its predecessors are zero)
        k = min(l, mmax + 1)
        if l - 1 <= mmax:
            prev[l - 1], prev2[l - 1] = diag[l - 1], 0.0
        m = ms[:k]
        a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
        b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
        cur = a[:, None] * (ct[None, :] * prev[:k] - b[:, None] * prev2[:k])
        lam[:k, :, l] = cur
        prev2[:k], prev[:k] = prev[:k], cur
    return lam


def _packed_positions(lmax: int, mmax: int):
    """Host map: (m, l) dense cell -> packed alm position (or -1)."""
    pos = np.full((mmax + 1, lmax + 1), -1, dtype=np.int64)
    ofs = 0
    for m in range(mmax + 1):
        n = lmax + 1 - m
        pos[m, m:] = np.arange(ofs, ofs + n)
        ofs += n
    return pos


def _gather(x, src):
    """``cat([x, 0], -1)[..., src]``: ``src == x.shape[-1]`` reads a zero."""
    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)
    return x.index_select(-1, src)


class IndexMap(torch.autograd.Function):
    """``y = cat([x, 0], -1)[..., index] * scale`` (last axis) for an
    ``index`` that reads every entry of ``x`` at most once, and its adjoint,
    the index map ``(inverse, inverse_scale)`` back: each is the other's
    derivative, so both directions are gathers.  (Autograd's own adjoint of
    a gather is ``index_add_``, whose atomics on the card all land on the
    one zero entry that the planes' ``l < m`` cells read.)"""

    @staticmethod
    def forward(x, fwd, bwd):
        index, scale = fwd
        return _gather(x, index) * scale.to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.maps = (inputs[1], inputs[2])

    @staticmethod
    def backward(ctx, grad):
        return IndexMap.apply(grad, ctx.maps[1], ctx.maps[0]), None, None

    @staticmethod
    def jvp(ctx, x_dot, _fwd_dot, _bwd_dot):
        return IndexMap.apply(x_dot, *ctx.maps)

    @staticmethod
    def vmap(info, in_dims, x, fwd, bwd):
        x = x.movedim(in_dims[0], 0) if in_dims[0] is not None else x
        return IndexMap.apply(x, fwd, bwd), 0 if in_dims[0] is not None else None


class AlmLayout(nn.Module):
    """Index maps between the three layouts of a band limit's coefficients:
    packed complex ``alm`` (:func:`n_alm`), the real packing (:func:`n_real`;
    m = 0 column, then per m > 0 interleaved (Re, Im) pairs scaled by
    ``1/sqrt(2)``) and dense real planes ``(2, mmax+1, lmax+1)``.

    Every map is a gather (``index_select`` through an index whose last
    value points at an appended zero) times a constant scale, all in real
    arithmetic; the buffers are non-persistent (they follow from the band
    limit).  Only :meth:`real2planes` lies on a field's differentiated path,
    so only it is an :class:`IndexMap`, whose adjoint is a gather too; the
    other maps serve the complex-alm entry points, and autograd takes their
    adjoint as ``index_add_``.
    """

    def __init__(self, lmax: int, mmax: Optional[int] = None):
        super().__init__()
        self.lmax = int(lmax)
        self.mmax = self.lmax if mmax is None else int(mmax)
        lmax, mmax = self.lmax, self.mmax
        self.n_alm, self.n_real = n_alm(lmax, mmax), n_real(lmax, mmax)
        pos = _packed_positions(lmax, mmax)
        # real packing -> (Re, Im) of each packed alm entry
        re_src = np.empty(self.n_alm, dtype=np.int64)
        im_src = np.full(self.n_alm, self.n_real, dtype=np.int64)  # the zero
        scale = np.full(self.n_alm, 1.0 / np.sqrt(2.0))
        re_src[: lmax + 1] = np.arange(lmax + 1)
        scale[: lmax + 1] = 1.0
        ofs, k = lmax + 1, lmax + 1
        for m in range(1, mmax + 1):
            n = lmax + 1 - m
            re_src[k:k + n] = ofs + 2 * np.arange(n)
            im_src[k:k + n] = ofs + 2 * np.arange(n) + 1
            ofs, k = ofs + 2 * n, k + n
        # the real packing from (Re, Im) of the packed entries: entry i of
        # cat([Re, Im]) times sqrt(2) for m > 0
        real_src = np.empty(self.n_real, dtype=np.int64)
        real_src[re_src] = np.arange(self.n_alm)
        real_src[im_src[lmax + 1:]] = self.n_alm + np.arange(lmax + 1, self.n_alm)
        real_scale = np.where(np.arange(self.n_real) < lmax + 1, 1.0, np.sqrt(2.0))
        # dense planes from the packed entries: (Re, Im) of pos[m, l], zero
        # (index 2 n_alm) where l < m
        plane_src = np.where(pos >= 0, pos, 2 * self.n_alm)
        plane_src = np.stack([plane_src, np.where(pos >= 0, pos + self.n_alm, 2 * self.n_alm)])
        # dense planes straight from the real packing
        real_plane_src = np.where(pos >= 0, re_src[np.maximum(pos, 0)], self.n_real)
        real_plane_src = np.stack(
            [real_plane_src, np.where(pos >= 0, im_src[np.maximum(pos, 0)], self.n_real)])
        real_plane_scale = np.broadcast_to(np.where(pos >= 0, scale[np.maximum(pos, 0)], 0.0),
                                           (2,) + pos.shape).reshape(-1)
        # its adjoint: the plane cell of every real coefficient
        real_plane_inv = np.empty(self.n_real, dtype=np.int64)
        flat_src = real_plane_src.reshape(-1)
        hit = flat_src < self.n_real
        real_plane_inv[flat_src[hit]] = np.nonzero(hit)[0]
        real_plane_inv_scale = real_plane_scale[real_plane_inv]
        # packed entries from the planes: flat (c, m, l) positions
        m_of, l_of = np.nonzero(pos >= 0)
        order = np.argsort(pos[m_of, l_of])
        flat = m_of[order] * (lmax + 1) + l_of[order]
        packed_src = np.concatenate([flat, (mmax + 1) * (lmax + 1) + flat])
        for name, arr in (("re_src", re_src), ("im_src", im_src), ("real_src", real_src),
                          ("plane_src", plane_src.reshape(-1)),
                          ("real_plane_src", real_plane_src.reshape(-1)),
                          ("packed_src", packed_src), ("real_plane_inv", real_plane_inv)):
            self.register_buffer(name, torch.from_numpy(arr), persistent=False)
        for name, arr in (("scale", scale), ("real_scale", real_scale),
                          ("real_plane_scale", real_plane_scale),
                          ("real_plane_inv_scale", real_plane_inv_scale)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    def _scale(self, name, x):
        return self._buffers[name].to(x.dtype)

    def real2alm(self, x):
        """``(..., n_real)`` real coefficients -> ``(..., n_alm)`` complex alm."""
        s = self._scale("scale", x)
        return torch.complex(_gather(x, self.re_src) * s, _gather(x, self.im_src) * s)

    def alm2real(self, alm):
        """``(..., n_alm)`` complex alm -> ``(..., n_real)`` real coefficients."""
        both = torch.cat([alm.real, alm.imag], -1)
        return both.index_select(-1, self.real_src) * self._scale("real_scale", both)

    def real2planes(self, x):
        """``(..., n_real)`` -> planes ``(..., 2, mmax+1, lmax+1)``, an
        :class:`IndexMap` (its adjoint a gather too)."""
        shape = x.shape[:-1] + (2, self.mmax + 1, self.lmax + 1)
        b = self._buffers
        return IndexMap.apply(x, (b["real_plane_src"], b["real_plane_scale"]),
                              (b["real_plane_inv"], b["real_plane_inv_scale"])).reshape(shape)

    def alm2planes(self, alm):
        """``(..., n_alm)`` complex -> planes ``(..., 2, mmax+1, lmax+1)``."""
        both = torch.cat([alm.real, alm.imag], -1)
        shape = alm.shape[:-1] + (2, self.mmax + 1, self.lmax + 1)
        return _gather(both, self.plane_src).reshape(shape)

    def planes2alm(self, planes):
        """Planes ``(..., 2, mmax+1, lmax+1)`` -> ``(..., n_alm)`` complex."""
        flat = planes.reshape(planes.shape[:-3] + (-1,)).index_select(-1, self.packed_src)
        return torch.complex(flat[..., : self.n_alm], flat[..., self.n_alm:])


def real2alm(x, lmax: int, mmax: Optional[int] = None):
    """(lmax+1)^2 real coefficients -> packed complex alm.

    Layout: m=0 column (lmax+1 reals), then per m>0 interleaved (Re, Im)
    pairs scaled by 1/sqrt(2) so a band-limited map built from white real
    coefficients has unit covariance per coefficient.
    """
    x = torch.as_tensor(x)
    return AlmLayout(lmax, mmax).to(x.device).real2alm(x)


def alm2real(alm, lmax: int, mmax: Optional[int] = None):
    alm = torch.as_tensor(alm)
    return AlmLayout(lmax, mmax).to(alm.device).alm2real(alm)


def _pack_matrix_to_alm(A, lmax, mmax):
    """(..., mmax+1, lmax+1) dense (zero for l<m) -> packed 1-D alm."""
    return torch.cat([A[..., m, m:] for m in range(mmax + 1)], -1)


def _unpack_alm_to_matrix(alm, lmax, mmax):
    """Packed alm -> (..., mmax+1, lmax+1) dense, zero for l < m."""
    rows, ofs = [], 0
    for m in range(mmax + 1):
        n = lmax + 1 - m
        rows.append(torch.cat([alm.new_zeros(alm.shape[:-1] + (m,)), alm[..., ofs:ofs + n]], -1))
        ofs += n
    return torch.stack(rows, -2)


def legendre(lam, planes):
    """The Legendre stage: planes ``(B, 2, M, L)`` -> ``(B, 2, M, T)``,
    ``out[b, c, m, t] = Σ_l lam[m, t, l] planes[b, c, m, l]``, as one
    ``torch.bmm`` over m with the ``2 B`` planes as columns."""
    nrows, _, nm, nl = planes.shape
    x = planes.permute(2, 3, 1, 0).reshape(nm, nl, 2 * nrows)
    out = torch.bmm(lam, x)
    return out.reshape(nm, -1, 2, nrows).permute(3, 2, 0, 1)


def legendre_transpose(lam, f):
    """The transpose of :func:`legendre`: ``(B, 2, M, T)`` -> ``(B, 2, M, L)``."""
    nrows, _, nm, nt = f.shape
    x = f.permute(2, 3, 1, 0).reshape(nm, nt, 2 * nrows)
    out = torch.bmm(lam.transpose(1, 2), x)
    return out.reshape(nm, -1, 2, nrows).permute(3, 2, 0, 1)


def _synthesize_longitude(f, nphi, lead):
    """The Gauss-Legendre longitude stage: planes ``(B, 2, M, nlat)`` ->
    maps ``(*lead, nlat, nphi)``, ``irfft(nphi · F)`` along φ."""
    n_half = nphi // 2 + 1
    f = torch.nn.functional.pad(f, (0, 0, 0, n_half - f.shape[2]))
    g = torch.complex(f[:, 0], f[:, 1]).transpose(-1, -2)
    out = torch.fft.irfft(nphi * g, n=nphi, dim=-1)
    return out.reshape(lead + tuple(out.shape[1:]))


def _analysis_planes(maps, nm, w):
    """The quadrature's longitude stage: maps ``(B, nlat, nphi)`` -> planes
    ``(B, 2, nm, nlat)`` of ``(2π / nphi) w_θ rfft(map)[θ, m]``."""
    f = torch.fft.rfft(maps, dim=-1)[..., :nm]
    f = f * (2.0 * np.pi / maps.shape[-1])
    f = f * w.to(maps.dtype)[:, None]
    return torch.stack([f.real, f.imag], 1).transpose(-1, -2)


def _rows(x, ndim):
    """``x`` with its leading axes (all but the last ``ndim``) flattened
    into one, and those axes."""
    lead = tuple(x.shape[: x.ndim - ndim])
    return x.reshape((-1,) + tuple(x.shape[x.ndim - ndim:])), lead


class _TableCache:
    """A float table in other dtypes, converted once per (dtype, device, storage)."""

    def __init__(self):
        self._copies = {}

    def get(self, table, dtype):
        if table.dtype == dtype:
            return table
        key = (dtype, table.device, table.data_ptr())
        if key not in self._copies:
            self._copies.clear()
            self._copies[key] = table.to(dtype)
        return self._copies[key]


def _resolve_device(device):
    return torch.device(device) if device is not None else config.default_device()


class SphericalHarmonicTransform(nn.Module):
    """Exact SHT between packed complex alm and a Gauss-Legendre grid.

    Parameters
    ----------
    lmax : int
        Band limit.
    nlat, nphi : int, optional
        Grid resolution; defaults (exactness): ``nlat = lmax + 1``,
        ``nphi = 2 lmax + 2``.
    mmax : int, optional
        Largest m (default ``lmax``).
    dtype : torch.dtype, optional
        Type of the Legendre buffer (default float64; a call in another
        float type converts it once).
    device : optional
        Where the buffers live (default: the configured device).

    Maps have shape ``(..., nlat, nphi)``; leading axes are a batch.
    """

    def __init__(self, lmax: int, nlat: Optional[int] = None, nphi: Optional[int] = None,
                 mmax: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        self.lmax = int(lmax)
        self.mmax = int(mmax) if mmax is not None else self.lmax
        self.nlat = int(nlat) if nlat is not None else self.lmax + 1
        self.nphi = int(nphi) if nphi is not None else 2 * self.lmax + 2
        if self.nphi < 2 * self.mmax + 1:
            raise ValueError("nphi must be at least 2*mmax+1")
        theta, w = gauss_legendre_quadrature(self.nlat)
        self.theta, self.quad_weights = theta, w
        dtype = dtype if dtype is not None else config.default_float_dtype()
        lam = normalized_legendre_table(self.lmax, theta, self.mmax)
        self.register_buffer("lam", torch.from_numpy(lam).to(dtype), persistent=False)
        self.register_buffer("w", torch.from_numpy(np.ascontiguousarray(w)).to(dtype),
                             persistent=False)
        self.layout = AlmLayout(self.lmax, self.mmax)
        self._tables = _TableCache()
        self.to(_resolve_device(device))

    @property
    def n_alm(self) -> int:
        return n_alm(self.lmax, self.mmax)

    @property
    def grid_shape(self):
        return (self.nlat, self.nphi)

    def _lam(self, dtype):
        return self._tables.get(self.lam, dtype)

    def alm2map(self, alm):
        """Synthesis: packed complex alm ``(..., n_alm)`` -> real maps."""
        alm, lead = _rows(alm, 1)
        planes = self.layout.alm2planes(alm)
        return _synthesize_longitude(legendre(self._lam(planes.dtype), planes), self.nphi, lead)

    def map2alm(self, m_arr):
        """Analysis (exact on the GL grid): real maps -> packed alm."""
        maps, lead = _rows(m_arr, 2)
        planes = legendre_transpose(self._lam(maps.dtype),
                                    _analysis_planes(maps, self.mmax + 1, self.w))
        return self.layout.planes2alm(planes).reshape(lead + (self.n_alm,))

    def real2alm(self, x):
        """(lmax+1)^2 real coefficients -> packed complex alm."""
        return self.layout.real2alm(x)

    def alm2real(self, alm):
        return self.layout.alm2real(alm)

    def synthesize_real(self, x):
        """Real LMSpace coefficients ``(..., n_real)`` -> maps (the harmonic
        transform of spherical correlated fields): the real packing goes to
        the planes by one index map, with no complex view."""
        x, lead = _rows(x, 1)
        planes = self.layout.real2planes(x)
        return _synthesize_longitude(legendre(self._lam(planes.dtype), planes), self.nphi, lead)


# -- on-the-fly formulation ---------------------------------------------------


def _diagonal_mantissa_exponent(lmax: int, theta: np.ndarray):
    """λ_mm(θ) for m = 0 .. lmax as mantissa (float64, |.| in [0.5, 1)) and
    integer exponent: the diagonal recurrence with the mantissa renormalized
    after every step, so that no row underflows.  Multiplying by a power of
    two is exact, so mantissa · 2^exponent equals the plain float64
    recurrence wherever that is representable."""
    st = np.sin(theta)
    mant = np.empty((lmax + 1, theta.size))
    expo = np.empty((lmax + 1, theta.size), dtype=np.int64)
    row = np.full(theta.size, 1.0 / np.sqrt(4.0 * np.pi))
    e = np.zeros(theta.size, dtype=np.int64)
    for m in range(lmax + 1):
        if m > 0:
            row = -np.sqrt(1.0 + 1.0 / (2.0 * m)) * st * row
        row, de = np.frexp(row)
        e = e + de
        mant[m], expo[m] = row, e
    return mant, expo


class SphericalHarmonicTransformOnTheFly(nn.Module):
    """Exact GL-grid SHT without a stored Legendre table.

    The rows ``λ_lm(θ)`` are made inside a Python loop over ``l`` that
    carries the two previous rows of the upward three-term recurrence (as
    the JAX package's ``lax.scan`` does); memory is O((mmax+1)·nlat).
    Synthesis and analysis run their own loops; each is the other's adjoint
    by construction, and autograd differentiates either.

    The diagonal ``λ_mm`` is carried as a mantissa in the compute type and
    an integer exponent per (m, θ): the recurrence runs on values scaled by
    ``2^-e`` and gives an exponent back as soon as a value reaches 1, until
    it is representable unscaled.  So float32 keeps the values that grow
    back to O(1) from a diagonal below its range (near the poles at large
    m), which a diagonal cast to float32 flushes to zero.  Scaling by powers
    of two is exact, so where nothing underflows the result is that of the
    unscaled recurrence.
    """

    def __init__(self, lmax: int, nlat: Optional[int] = None, nphi: Optional[int] = None,
                 mmax: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        self.lmax = int(lmax)
        self.mmax = int(mmax) if mmax is not None else self.lmax
        self.nlat = int(nlat) if nlat is not None else self.lmax + 1
        self.nphi = int(nphi) if nphi is not None else 2 * self.lmax + 2
        if self.nphi < 2 * self.mmax + 1:
            raise ValueError("nphi must be at least 2*mmax+1")
        theta, w = gauss_legendre_quadrature(self.nlat)
        self.theta, self.quad_weights = theta, w
        dtype = dtype if dtype is not None else config.default_float_dtype()
        self.dtype = dtype
        mant, expo = _diagonal_mantissa_exponent(self.lmax, theta)
        for name, arr, dt in (("ct", np.cos(theta), dtype), ("w", w, dtype),
                              ("diag_mantissa", mant, dtype),
                              ("diag_exponent", expo.astype(np.int32), torch.int32)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)).to(dt),
                                 persistent=False)
        self.layout = AlmLayout(self.lmax, self.mmax)
        self.to(_resolve_device(device))

    @property
    def n_alm(self) -> int:
        return n_alm(self.lmax, self.mmax)

    @property
    def grid_shape(self):
        return (self.nlat, self.nphi)

    def _rows_of_l(self):
        """Yield ``(l, rows)``: ``rows (mmax+1, nlat)`` are λ_lm(θ) for every
        m at this l (zero for m > l)."""
        ct = self.ct
        dtype, device = ct.dtype, ct.device
        nm, nlat = self.mmax + 1, self.nlat
        m = torch.arange(nm, device=device)
        mf = m.to(dtype)
        prev = ct.new_zeros((nm, nlat))
        prev2 = ct.new_zeros((nm, nlat))
        scale = torch.zeros((nm, nlat), dtype=torch.int32, device=device)
        for l in range(self.lmax + 1):
            # factored forms of the coefficients, as in the JAX package
            lf = float(l)
            active = m < l
            den_a = torch.where(active, (lf - mf) * (lf + mf), torch.ones_like(mf))
            a = torch.sqrt((2.0 * lf - 1.0) * (2.0 * lf + 1.0) / den_a)
            num_b = torch.where(active, (lf - 1.0 - mf) * (lf - 1.0 + mf), torch.zeros_like(mf))
            den_b = (2.0 * lf - 3.0) * (2.0 * lf - 1.0) if l >= 2 else 1.0
            b = torch.sqrt(torch.clamp_min(num_b / den_b, 0.0))
            cur = a[:, None] * (ct[None, :] * prev - b[:, None] * prev2)
            cur = torch.where(active[:, None], cur, torch.zeros_like(cur))
            if l <= self.mmax:
                cur[l] = self.diag_mantissa[l]
                scale[l] = self.diag_exponent[l]
            # while a value is scaled (exponent below 0), give exponent back
            # as soon as it reaches 1; the previous row moves with it
            _, ex = torch.frexp(cur)
            shift = torch.minimum(torch.clamp_min(ex, 0), -scale)
            cur = torch.ldexp(cur, (-shift).to(dtype))
            prev = torch.ldexp(prev, (-shift).to(dtype))
            scale = scale + shift
            yield l, torch.ldexp(cur, scale.to(dtype))
            prev2, prev = prev, cur

    def _synth(self, planes):
        """planes ``(B, 2, M, L)`` -> ``(B, 2, M, nlat)``."""
        acc = planes.new_zeros(planes.shape[:3] + (self.nlat,))
        for l, rows in self._rows_of_l():
            acc = acc + planes[..., l, None] * rows.to(planes.dtype)
        return acc

    def _synth_t(self, f):
        """The transpose: ``(B, 2, M, nlat)`` -> ``(B, 2, M, L)``."""
        out = []
        for _, rows in self._rows_of_l():
            out.append(torch.sum(rows.to(f.dtype) * f, -1))
        return torch.stack(out, -1)

    def alm2map(self, alm):
        """Synthesis: packed complex alm -> real maps ``(..., nlat, nphi)``."""
        alm, lead = _rows(alm, 1)
        planes = self.layout.alm2planes(alm).to(self.dtype)
        return _synthesize_longitude(self._synth(planes), self.nphi, lead)

    def map2alm(self, m_arr):
        """Analysis (exact on the GL grid): real maps -> packed alm."""
        maps, lead = _rows(m_arr, 2)
        planes = self._synth_t(_analysis_planes(maps, self.mmax + 1, self.w))
        return self.layout.planes2alm(planes).reshape(lead + (self.n_alm,))

    def real2alm(self, x):
        return self.layout.real2alm(x)

    def alm2real(self, alm):
        return self.layout.alm2real(alm)

    def synthesize_real(self, x):
        x, lead = _rows(x, 1)
        return _synthesize_longitude(self._synth(self.layout.real2planes(x)), self.nphi, lead)
