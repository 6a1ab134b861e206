"""Spherical harmonic synthesis on HEALPix grids (counterpart of
:mod:`nifty_tpu.ops.healpix_sht`).

Two stages: the Legendre stage evaluates ``F[m, ring] = Σ_l λ_lm(θ_ring)
a_lm`` for the 4·nside−1 iso-latitude rings as one m-batched ``torch.bmm``
(:func:`~.sht.legendre`), and the longitude stage evaluates ``map[p] = Re
Σ_m c_m F[m, ring(p)] e^{i m φ_p}`` (``c_0 = 1``, ``c_m = 2``: the ±m
pairs of a real map folded) with the hand-written kernel pair K10
(:mod:`.hp_longitude`), one FFT a ring: no ``(npix, mmax+1)`` phase
table is stored.

``map2alm_adjoint`` is the exact adjoint, quadrature-weighted, so an
analysis is available by CG on ``adjoint ∘ synthesis`` (``map2alm``, the
strategy of healpy's iterative ``map2alm``; HEALPix has no exact
quadrature) or in one shot with per-ring quadrature weights
(``map2alm_weighted``).

The transform is an ``nn.Module``: the Legendre table (``lam``, ``(mmax+1,
nrings, lmax+1)``, 2.15 GB in float64 at nside 256, lmax 511) and the ring
table are buffers on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import config
from . import healpix as hpx
from .hp_longitude import HpLongitude, HpLongitudeAdjoint, healpix_rings
from .sht import (
    AlmLayout,
    _resolve_device,
    _rows,
    _TableCache,
    legendre,
    legendre_transpose,
    n_alm,
    normalized_legendre_table,
)


class HEALPixSHT(nn.Module):
    """Synthesis (and adjoint) between packed alm and a HEALPix map in RING
    order; maps have shape ``(..., npix)``, leading axes a batch."""

    def __init__(self, lmax: int, nside: int, mmax: Optional[int] = None, dtype=None,
                 device=None):
        super().__init__()
        self.lmax = int(lmax)
        self.mmax = int(mmax) if mmax is not None else self.lmax
        self.nside = int(nside)
        self.npix = hpx.npix(nside)
        dtype = dtype if dtype is not None else config.default_float_dtype()
        self.rings = healpix_rings(self.nside)
        lam = normalized_legendre_table(self.lmax, self.rings.ring_theta, self.mmax)
        self.register_buffer("lam", torch.from_numpy(lam).to(dtype), persistent=False)
        c = np.full(self.mmax + 1, 2.0)
        c[0] = 1.0
        self.register_buffer("fold", torch.from_numpy(c).to(dtype), persistent=False)
        self.layout = AlmLayout(self.lmax, self.mmax)
        # quadrature weight: equal-area pixels
        self._w = 4.0 * np.pi / self.npix
        self._ring_weights = None  # lazy (host solve)
        self._tables = _TableCache()
        self.to(_resolve_device(device))

    @property
    def n_alm(self):
        return n_alm(self.lmax, self.mmax)

    @property
    def nrings(self):
        return self.rings.nrings

    def _lam(self, dtype):
        return self._tables.get(self.lam, dtype)

    def _fold(self, f):
        return f * self.fold.to(f.dtype)[:, None]

    def _synthesis(self, planes, lead):
        """Planes ``(B, 2, M, L)`` -> maps ``(*lead, npix)``."""
        f = self._fold(legendre(self._lam(planes.dtype), planes))
        return HpLongitude.apply(f.contiguous(), self.rings).reshape(lead + (self.npix,))

    def _phase_analysis(self, mw):
        """The longitude stage's adjoint: weighted maps ``(B, npix)`` ->
        planes ``(B, 2, M, nrings)``."""
        return HpLongitudeAdjoint.apply(mw.contiguous(), self.rings, self.mmax + 1)

    def alm2map(self, alm):
        """Synthesis: packed complex alm ``(..., n_alm)`` -> HEALPix maps."""
        alm, lead = _rows(alm, 1)
        return self._synthesis(self.layout.alm2planes(alm), lead)

    def synthesize_real(self, x):
        """Real LMSpace coefficients ``(..., n_real)`` -> HEALPix maps (the
        harmonic transform of spherical correlated fields)."""
        x, lead = _rows(x, 1)
        return self._synthesis(self.layout.real2planes(x), lead)

    def map2alm_adjoint(self, m_arr):
        """Exact adjoint of synthesis, quadrature-weighted: ≈ analysis for
        band-limited maps; feed into CG for iterative exact analysis."""
        maps, lead = _rows(m_arr, 1)
        f = self._fold(self._phase_analysis(maps * self._w))
        planes = legendre_transpose(self._lam(maps.dtype), f)
        return self.layout.planes2alm(planes).reshape(lead + (self.n_alm,))

    def map2alm(self, m_arr, maxiter: int = 20, tol: float = 1e-8):
        """Iterative analysis of one map: solve ``synth(alm) = map`` in the
        least-squares sense by CG on the normal equations."""
        from ..solvers.cg import _static_cg

        def normal_op(alm):
            return self.map2alm_adjoint(self.alm2map(alm))

        j = self.map2alm_adjoint(m_arr)
        return _static_cg(normal_op, j, resnorm=tol, maxiter=maxiter).x

    def _get_ring_weights(self):
        if self._ring_weights is None:
            self._ring_weights = healpix_ring_weights(
                self.rings.ring_theta, self.rings.ring_of_pix_np, self.npix, 2 * self.nside)
        return self._ring_weights

    def map2alm_weighted(self, m_arr):
        """One-shot analysis with exact-quadrature ring weights.

        Per-ring corrections to the equal-area pixel weight are solved on
        the host so that the HEALPix quadrature integrates all Legendre
        polynomials up to ~2·nside exactly.  For maps band-limited well
        below that, this matches the CG analysis without any iteration.
        No (1, 2, 2, ...) fold here: that belongs to the synthesis."""
        maps, lead = _rows(m_arr, 1)
        rw = torch.as_tensor(self._get_ring_weights(), dtype=maps.dtype, device=maps.device)
        mw = maps * rw[self.rings.ring_of_pix] * self._w
        planes = legendre_transpose(self._lam(maps.dtype), self._phase_analysis(mw))
        return self.layout.planes2alm(planes).reshape(lead + (self.n_alm,))

    def real2alm(self, x):
        return self.layout.real2alm(x)

    def alm2real(self, alm):
        return self.layout.alm2real(alm)


def healpix_ring_weights(ring_theta, ring_of_pix, npix, lmax_quad):
    """Per-ring quadrature correction factors (host, float64).

    Find w_r with Σ_p (4π/npix)·w_{r(p)}·P_l(z_p) = 4π·δ_{l0} for all even
    l ≤ lmax_quad (odd l vanish by the N–S ring symmetry): a small dense
    least-squares problem over the ~4·nside−1 rings, the minimum-norm
    deviation from unit weights, solved once in numpy.
    """
    nr = ring_theta.size
    n_per_ring = np.bincount(ring_of_pix, minlength=nr).astype(np.float64)
    z = np.cos(ring_theta)
    ls = np.arange(0, int(lmax_quad) + 1)
    P = np.zeros((ls.size, nr))
    P[0] = 1.0
    if ls.size > 1:
        P[1] = z
    for l in range(2, ls.size):
        P[l] = ((2 * l - 1) * z * P[l - 1] - (l - 1) * P[l - 2]) / l
    even = ls % 2 == 0
    A = P[even] * n_per_ring[None, :] * (4.0 * np.pi / npix)
    b = np.zeros(even.sum())
    b[0] = 4.0 * np.pi
    resid = b - A @ np.ones(nr)
    dw, *_ = np.linalg.lstsq(A, resid, rcond=None)
    return 1.0 + dw
