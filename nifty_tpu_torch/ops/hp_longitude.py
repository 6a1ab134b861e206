"""The longitude stage of the HEALPix spherical harmonic synthesis, K10, and
its adjoint.

On HEALPix the synthesis runs in two stages (:mod:`.healpix_sht`): the
Legendre stage gives, for every iso-latitude ring ``r``, the coefficient
planes ``F[b, :, m, r]`` (real and imaginary part), and the longitude stage
sums them over m with each pixel's phase:

    map[b, p]   = Σ_m (F[b, 0, m, r(p)] cos mφ_p − F[b, 1, m, r(p)] sin mφ_p)
    G[b, 0, m, r] =  Σ_{p ∈ ring r} ct[b, p] cos mφ_p
    G[b, 1, m, r] = −Σ_{p ∈ ring r} ct[b, p] sin mφ_p      (the adjoint)

The JAX package computes this stage in XLA (``nifty_tpu/ops/
healpix_sht.py:47-193``, the primitives ``_hp_fwd_p`` / ``_hp_adj_p``): an
m-chunked scan of matrix products against stored ``(npix, mmax+1)`` phase
tables and, for the adjoint, a segment sum over rings.  Here the pair is a
hand-written CUDA kernel pair (``csrc/hp_longitude.cu``) that makes the
phases on the fly, so it reads only the coefficient planes and writes the
map: at nside 256, lmax 511 in float64 a row moves 14.7 MB (0.0044 ms at
3.35 TB/s).  The direct sum needs two multiply-adds a (pixel, m), 1.6
GFLOP a row (0.024 ms at the card's 67 TFLOP/s float64 peak), so summed
directly the stage is bound by operations; a ring FFT would need far fewer
and be bound by the bytes.

:class:`HPRings` holds the ring table the kernels read: where each ring
starts in the RING order (rings must be contiguous there, which the host
checks), its first pixel's φ and its step ``2π / nphi``; each pixel's
``φ_p = φ0 + j · dφ``.  The plain versions (:func:`hp_longitude_plain`,
:func:`hp_longitude_adjoint_plain`) are the JAX formulation: phase chunks of
``CHUNK`` m made from φ by ``torch.cos`` / ``torch.sin`` (in float64, cast
to the values' type, as the JAX package casts its float64 tables) and the
adjoint's per-ring sums by ``index_add_`` over ``ring_of_pix``; given the
whole tables of :func:`phase_tables` they read their chunks from there, as
the JAX package does.  :func:`sum_abs_terms` is the error scale the kernels
are held to against them.

:func:`hp_longitude` and :func:`hp_longitude_adjoint` run the kernels for a
CUDA tensor and the plain versions for a CPU tensor only.  Their
``launches`` count the calls that take the kernel route, in total, by rows
(``launches_by_rows``) and by (npix, nm, rows) (``launches_by_shape``).
:class:`HpLongitude` and :class:`HpLongitudeAdjoint` are the
``torch.autograd.Function`` pair, each the other's derivative, with
``setup_context``, ``jvp`` and ``vmap``.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch
from torch import nn

from .cuda_build import load_library

_FLOAT_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_MAX_ROWS = 65535  # gridDim.y
#: m an adjoint kernel's thread and a synthesis thread advance by rotation
#: before they reseed the phase with ``sincos`` (``kReseed`` in the ``.cu``;
#: :func:`_kernels` checks that they agree).
RESEED = 32
#: m of a phase chunk in the plain versions (the JAX package's ``M_CHUNK``).
CHUNK = 64


class HPRings(nn.Module):
    """The iso-latitude rings of a HEALPix grid in RING order, from the
    pixel centres ``theta``, ``phi`` (host numpy, float64): rings are the
    distinct colatitudes (rounded to 14 decimals, as the JAX package groups
    them), which must each be one contiguous run of pixels.

    Buffers (non-persistent: they follow from the pixelization):
    ``ring_start`` (int64, nrings + 1, CSR offsets), ``phi0`` and ``dphi``
    (float64, a ring each), ``ring_of_pix`` (int64) and ``phi`` (float64,
    ``phi0 + j * dphi`` a pixel, for the plain versions).  ``ring_theta`` is
    the rings' colatitudes (host numpy).
    """

    def __init__(self, theta, phi):
        super().__init__()
        theta = np.asarray(theta, dtype=np.float64)
        phi = np.asarray(phi, dtype=np.float64)
        ring_theta, ring_of_pix = np.unique(np.round(theta, 14), return_inverse=True)
        ring_of_pix = ring_of_pix.reshape(-1)
        if np.any(np.diff(ring_of_pix) < 0):
            raise ValueError("the pixels of each ring must be contiguous (RING order)")
        nrings = ring_theta.size
        counts = np.bincount(ring_of_pix, minlength=nrings)
        start = np.zeros(nrings + 1, dtype=np.int64)
        np.cumsum(counts, out=start[1:])
        phi0 = phi[start[:-1]]
        dphi = 2.0 * np.pi / counts
        j = np.arange(phi.size) - start[ring_of_pix]
        phi_pix = phi0[ring_of_pix] + j * dphi[ring_of_pix]
        if np.max(np.abs(phi_pix - phi)) > 1e-12:
            raise ValueError("pixels within a ring are not equally spaced in phi")
        self.ring_theta = ring_theta
        self.ring_of_pix_np = ring_of_pix
        self.nrings, self.npix = int(nrings), int(phi.size)
        for name, arr in (("ring_start", start), ("phi0", phi0), ("dphi", dphi),
                          ("ring_of_pix", ring_of_pix.astype(np.int64)), ("phi", phi_pix)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    def extra_repr(self):
        return f"nrings={self.nrings}, npix={self.npix}"


# -- plain versions -------------------------------------------------------


def _phase_chunk(rings: HPRings, m0: int, m1: int, dtype):
    """cos and sin of ``m φ_p`` for m in [m0, m1): ``(m1 - m0, npix)`` each,
    made in float64 and cast to ``dtype``."""
    phi = rings.phi
    m = torch.arange(m0, m1, dtype=torch.float64, device=phi.device)
    arg = m[:, None] * phi[None, :]
    return torch.cos(arg).to(dtype), torch.sin(arg).to(dtype)


def phase_tables(rings: HPRings, nm: int, dtype):
    """The whole phase tables, cos and sin of ``m φ_p`` for m < ``nm``,
    ``(nm, npix)`` each (the JAX package's stored tables, transposed), made
    a chunk at a time as :func:`_phase_chunk` makes them."""
    cos = rings.phi.new_empty((nm, rings.npix), dtype=dtype)
    sin = torch.empty_like(cos)
    for m0 in range(0, nm, CHUNK):
        m1 = min(m0 + CHUNK, nm)
        cos[m0:m1], sin[m0:m1] = _phase_chunk(rings, m0, m1, dtype)
    return cos, sin


def _chunk(rings: HPRings, m0: int, m1: int, dtype, tables):
    if tables is None:
        return _phase_chunk(rings, m0, m1, dtype)
    return tables[0][m0:m1], tables[1][m0:m1]


def hp_longitude_plain(F, rings: HPRings, tables=None):
    """The synthesis for planes ``(B, 2, nm, nrings)`` -> ``(B, npix)``, in
    chunks of :data:`CHUNK` m as the JAX package's scan runs; the phases
    made a chunk at a time, or read from ``tables`` (:func:`phase_tables`)."""
    nrows, _, nm, _ = F.shape
    rp = rings.ring_of_pix
    out = F.new_zeros((nrows, rings.npix))
    for m0 in range(0, nm, CHUNK):
        m1 = min(m0 + CHUNK, nm)
        cos, sin = _chunk(rings, m0, m1, F.dtype, tables)
        fre = F[:, 0, m0:m1].index_select(-1, rp)
        fim = F[:, 1, m0:m1].index_select(-1, rp)
        out = out + torch.einsum("bkp,kp->bp", fre, cos) - torch.einsum("bkp,kp->bp", fim, sin)
    return out


def hp_longitude_adjoint_plain(ct, rings: HPRings, nm: int, tables=None):
    """The adjoint for a cotangent ``(B, npix)`` -> ``(B, 2, nm, nrings)``:
    phase chunks (or ``tables``), then per-ring sums by ``index_add_`` over
    ``ring_of_pix``."""
    nrows = ct.shape[0]
    rp = rings.ring_of_pix
    out = ct.new_zeros((nrows, 2, nm, rings.nrings))
    for m0 in range(0, nm, CHUNK):
        m1 = min(m0 + CHUNK, nm)
        cos, sin = _chunk(rings, m0, m1, ct.dtype, tables)
        out[:, 0, m0:m1].index_add_(-1, rp, cos[None] * ct[:, None, :])
        out[:, 1, m0:m1].index_add_(-1, rp, -(sin[None] * ct[:, None, :]))
    return out


def sum_abs_terms(rings: HPRings, F=None, ct=None):
    """The per-output sum of |term| of the synthesis of ``F`` ``(B, 2, nm,
    nrings)`` or of the adjoint of ``ct`` ``(B, npix)``, a term's modulus
    taken as a complex number: ``|F_m e^{imφ}| = |F_m|``, ``|ct_p
    e^{-imφ_p}| = |ct_p|``.  The phases' rounding is absolute, so an output
    whose terms cancel to zero in exact arithmetic is held to the size of
    its terms."""
    if F is not None:
        return torch.linalg.vector_norm(F, dim=1).sum(1)[:, rings.ring_of_pix]
    ring_sums = ct.new_zeros((ct.shape[0], rings.nrings)).index_add_(1, rings.ring_of_pix,
                                                                     ct.abs())
    return ring_sums[:, None, None, :]


# -- kernel wrappers ------------------------------------------------------

_KERNELS: dict = {}


def _kernels():
    """The library's C entries, loaded (and built) at first use."""
    if _KERNELS:
        return _KERNELS
    lib = load_library("hp_longitude")
    lib.hp_longitude_reseed.argtypes, lib.hp_longitude_reseed.restype = [], ctypes.c_int
    if lib.hp_longitude_reseed() != RESEED:
        raise RuntimeError(f"hp_longitude built with a reseed of {lib.hp_longitude_reseed()}; "
                           f"the host uses {RESEED}")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dtype, sfx in _FLOAT_DTYPES.items():
        for kind, name in (("synth", f"hp_longitude_{sfx}"),
                           ("adjoint", f"hp_longitude_adjoint_{sfx}")):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 5 + [ci, ci, cll, ci, ci, vp]
            fn.restype = ci
            _KERNELS[kind, dtype] = fn
    return _KERNELS


def _check(x, rings: HPRings, shape, what: str):
    if tuple(x.shape[1:]) != tuple(shape) or x.ndim != len(shape) + 1:
        raise ValueError(f"{what} must have shape (B, {', '.join(map(str, shape))}); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{what} must be float32 or float64; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != rings.phi0.device:
        raise ValueError(f"{what} on {x.device} but the ring table on {rings.phi0.device}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows; got {x.shape[0]}")


def _launch(kind, x, out, rings: HPRings, nm: int):
    fn = _kernels()[kind, x.dtype]
    dev = x.get_device()
    rc = fn(x.data_ptr(), out.data_ptr(), rings.ring_start.data_ptr(), rings.phi0.data_ptr(),
            rings.dphi.data_ptr(), rings.nrings, nm, rings.npix, x.shape[0], dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")


def _count(wrapper, rings: HPRings, nm: int, nrows: int):
    wrapper.launches += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_shape[rings.npix, nm, nrows] += 1


def hp_longitude(F, rings: HPRings):
    """The synthesis, planes ``(B, 2, nm, nrings)`` -> maps ``(B, npix)``:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if F.ndim != 4:
        raise ValueError(f"coefficient planes must have shape (B, 2, nm, nrings); got "
                         f"{tuple(F.shape)}")
    nm = F.shape[2]
    _check(F, rings, (2, nm, rings.nrings), "coefficient planes")
    if not F.is_cuda:
        if F.device.type == "cpu":
            return hp_longitude_plain(F, rings)
        raise RuntimeError(f"no hp_longitude kernel for device {F.device}")
    out = F.new_empty((F.shape[0], rings.npix))
    _launch("synth", F, out, rings, nm)
    _count(hp_longitude, rings, nm, F.shape[0])
    return out


def hp_longitude_adjoint(ct, rings: HPRings, nm: int):
    """The adjoint, maps ``(B, npix)`` -> planes ``(B, 2, nm, nrings)``: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    _check(ct, rings, (rings.npix,), "cotangent")
    if not ct.is_cuda:
        if ct.device.type == "cpu":
            return hp_longitude_adjoint_plain(ct, rings, nm)
        raise RuntimeError(f"no hp_longitude kernel for device {ct.device}")
    out = ct.new_empty((ct.shape[0], 2, nm, rings.nrings))
    _launch("adjoint", ct, out, rings, nm)
    _count(hp_longitude_adjoint, rings, nm, ct.shape[0])
    return out


def reset_launch_counts():
    for fn in (hp_longitude, hp_longitude_adjoint):
        fn.launches = 0
        fn.launches_by_rows, fn.launches_by_shape = Counter(), Counter()


reset_launch_counts()


# -- autograd pair --------------------------------------------------------


class HpLongitude(torch.autograd.Function):
    """planes (B, 2, nm, nrings) -> maps (B, npix); derivative: the adjoint."""

    @staticmethod
    def forward(F, rings):
        return hp_longitude(F, rings)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rings = inputs[1]
        ctx.nm = inputs[0].shape[2]

    @staticmethod
    def backward(ctx, grad_out):
        return HpLongitudeAdjoint.apply(grad_out.contiguous(), ctx.rings, ctx.nm), None

    @staticmethod
    def jvp(ctx, F_dot, _rings_dot):
        return HpLongitude.apply(F_dot.contiguous(), ctx.rings)

    @staticmethod
    def vmap(info, in_dims, F, rings):
        if in_dims[0] is None:
            return HpLongitude.apply(F, rings), None
        f = F.movedim(in_dims[0], 0)
        n, nrows = f.shape[0], f.shape[1]
        out = HpLongitude.apply(f.reshape(n * nrows, *f.shape[2:]).contiguous(), rings)
        return out.reshape(n, nrows, -1), 0


class HpLongitudeAdjoint(torch.autograd.Function):
    """maps (B, npix) -> planes (B, 2, nm, nrings); derivative: the synthesis."""

    @staticmethod
    def forward(ct, rings, nm):
        return hp_longitude_adjoint(ct, rings, nm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rings = inputs[1]
        ctx.nm = inputs[2]

    @staticmethod
    def backward(ctx, grad_out):
        return HpLongitude.apply(grad_out.contiguous(), ctx.rings), None, None

    @staticmethod
    def jvp(ctx, ct_dot, _rings_dot, _nm_dot):
        return HpLongitudeAdjoint.apply(ct_dot.contiguous(), ctx.rings, ctx.nm)

    @staticmethod
    def vmap(info, in_dims, ct, rings, nm):
        if in_dims[0] is None:
            return HpLongitudeAdjoint.apply(ct, rings, nm), None
        c = ct.movedim(in_dims[0], 0)
        n, nrows = c.shape[0], c.shape[1]
        out = HpLongitudeAdjoint.apply(c.reshape(n * nrows, -1).contiguous(), rings, nm)
        return out.reshape(n, nrows, *out.shape[1:]), 0


def healpix_rings(nside: int) -> HPRings:
    """The ring table of a HEALPix grid at ``nside`` (host precompute)."""
    from . import healpix as hpx

    theta, phi = hpx.pix2ang(nside, np.arange(hpx.npix(nside)))
    return HPRings(theta, phi)

