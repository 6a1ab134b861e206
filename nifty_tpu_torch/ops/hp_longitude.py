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
tables and, for the adjoint, a segment sum over rings.

A ring's pixels are evenly spaced, ``φ_j = φ0 + 2πj/n`` for its ``n``
pixels, so the stage is one length-n DFT a ring (the ring FFT form):

    H_k = Σ_{m < nm, m ≡ k (mod n)} (F_0m + i F_1m) e^{imφ0},   map_j = Re Σ_k H_k e^{2πikj/n}
    X_k = Σ_j ct_j e^{−2πikj/n},   G_0m + i G_1m = e^{−imφ0} X_{m mod n}

O(n log n + nm) work a ring instead of the direct sum's O(n · nm).  The
hand-written kernel pair (``csrc/hp_longitude.cu``) runs it with one thread
block a ring and row and the ring's transform in shared memory (in a
slice of a global workspace where it is longer than :data:`MAX_SHARED_LEN`,
as for the Bluestein rings of more than 4096 pixels from nside 2048 on): a
length that is a power of two by in-place radix-2² passes, any other by
Bluestein's chirp-z through a power-of-two transform of length ``L =
2^⌈log2(2n − 1)⌉``.  Its operations are few (about 2.5 n log2 n a ring), so
the bytes bound it: a row reads the coefficient planes and writes the map
(or the reverse), 14.7 MB at nside 256, lmax 511 in float64 (0.0044 ms at
3.35 TB/s).  :func:`hp_longitude_fft_route` and
:func:`hp_longitude_adjoint_fft_route` compute the same form with
``torch.fft``, one batched call a distinct ring length (the library route
the kernels are timed against, and the CPU oracle of the algorithm).

:class:`HPRings` holds the ring table and the transforms' tables the
kernels read, all built once on the host in float64 (:func:`fft_length`,
:func:`fft_roots`, :func:`chirp_section`).  The plain versions
(:func:`hp_longitude_plain`, :func:`hp_longitude_adjoint_plain`) are the
JAX formulation: phase chunks of ``CHUNK`` m made from ``φ_p = φ0 + j·dφ``
by ``torch.cos`` / ``torch.sin`` (in float64, cast to the values' type, as
the JAX package casts its float64 tables) and the adjoint's per-ring sums by
``index_add_`` over ``ring_of_pix``; given the whole tables of
:func:`phase_tables` they read their chunks from there, as the JAX package
does.  :func:`sum_abs_terms` is the error scale the kernels are held to
against them.

:func:`hp_longitude` and :func:`hp_longitude_adjoint` run the kernels for a
CUDA tensor and the plain versions for a CPU tensor only.  Their
``launches`` count the calls that take the kernel route, in total, by rows
(``launches_by_rows``), by (npix, nm, rows) (``launches_by_shape``) and by
the values' float type (``launches_by_dtype``, "f32" / "f64").
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
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_MAX_ROWS = 65535  # gridDim.y
#: bytes of shared memory a thread block can hold on an H100
MAX_SMEM = 232448
#: the longest transform K10 holds in shared memory (128 KB); a longer one
#: runs in a slice of a global workspace
MAX_SHARED_LEN = 8192
#: the m a K10 synthesis block turns at once for its fold (``kFoldSlab``)
FOLD_SLAB = 2048
#: m of a phase chunk in the plain versions (the JAX package's ``M_CHUNK``).
CHUNK = 64


# -- the ring transforms' tables (host, float64) ---------------------------


def fft_length(n: int) -> int:
    """The length of the power-of-two transform that a ring of ``n`` pixels
    runs: ``n`` where it is a power of two, else Bluestein's ``L =
    2^⌈log2(2n − 1)⌉``."""
    n = int(n)
    return n if n & (n - 1) == 0 else 1 << (2 * n - 2).bit_length()


def cispi(q, d: int):
    """``e^{iπ q/d}`` for integers ``q`` (an array) and ``d > 0``: ``q`` is
    reduced in integer arithmetic to the nearest quarter turn ``k`` and a
    rest of at most π/4, whose ``cos`` and ``sin`` are turned by ``i^k`` (a
    ``sincospi``; the phase error does not grow with ``q``)."""
    q = np.asarray(q, dtype=np.int64) % (2 * d)
    k = (4 * q + d) // (2 * d)
    rest = np.pi * (2 * q - k * d).astype(np.float64) / (2 * d)
    c, s = np.cos(rest), np.sin(rest)
    k = k % 4
    return np.choose(k, [c, -s, -c, s]) + 1j * np.choose(k, [s, c, -s, -c])


def bit_reversed(length: int):
    """The bit-reversal permutation of ``range(length)`` (a power of two)."""
    bits = int(length).bit_length() - 1
    p = np.arange(length, dtype=np.int64)
    r = np.zeros_like(p)
    for i in range(bits):
        r |= ((p >> i) & 1) << (bits - 1 - i)
    return r


def fft_roots(max_len: int):
    """The roots of unity of every power-of-two length ``M`` from 2 to
    ``max_len``, ``e^{−2πij/M}`` for ``j < M/2``, one section a length, that
    of length ``M`` from row ``M/2 − 1``: ``(max_len − 1,)`` complex128."""
    lengths = [1 << e for e in range(1, int(max_len).bit_length())]
    return np.concatenate([np.zeros(0, complex)]
                          + [cispi(-2 * np.arange(M // 2), M) for M in lengths])


def chirp_section(n: int):
    """Bluestein's tables of a ring of ``n`` pixels (not a power of two),
    ``L = fft_length(n)``: the chirp ``w_t = e^{iπ t²/n}`` for ``t < n`` (``t²
    mod 2n`` taken in integers), then the transform over ``L`` of the chirp
    filter ``b`` (``b_t = b_{L−t} = w_t`` for ``t < n``, 0 between), divided
    by ``L`` and in bit-reversed order: ``(n + L,)`` complex128."""
    L = fft_length(n)
    t = np.arange(n, dtype=np.int64)
    w = cispi(t * t % (2 * n), n)
    b = np.zeros(L, dtype=complex)
    b[:n] = w
    b[L - n + 1:] = w[:0:-1]
    return np.concatenate([w, (np.fft.fft(b) / L)[bit_reversed(L)]])


class HPRings(nn.Module):
    """The iso-latitude rings of a HEALPix grid in RING order, from the
    pixel centres ``theta``, ``phi`` (host numpy, float64): rings are the
    distinct colatitudes (rounded to 14 decimals, as the JAX package groups
    them), which must each be one contiguous run of evenly spaced pixels.

    Buffers (non-persistent: they follow from the pixelization):
    ``ring_start`` (int64, nrings + 1, CSR offsets), ``phi0`` (float64, a
    ring's first pixel), ``ring_of_pix`` (int64) and ``phi`` (float64, ``phi0
    + j * 2π/n`` a pixel, for the plain versions); the kernels' transform
    tables: ``fft_len`` (int32, a ring's :func:`fft_length`), ``chirp_at``
    (int64, where its :func:`chirp_section` starts in ``chirp``; −1 where
    its length is a power of two), ``chirp`` and ``roots``
    (:func:`fft_roots` of the longest transform), both float64 ``(·, 2)``
    (real, imaginary), ``block_ring`` (int32, the ring each thread block
    of a row takes: the costliest transforms first, Bluestein's counted
    twice, so that none is left to trail the last wave of blocks) and
    ``ws_at`` (int64, where a ring whose transform is longer than
    :data:`MAX_SHARED_LEN` runs in a row's workspace of ``ws_row`` complex
    doubles, in complex doubles; −1 for the rings held in shared memory).
    Host attributes: ``ring_theta`` (the colatitudes), ``ring_len`` and
    ``fft_len_np`` (numpy), ``ws_row``.
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
        self.ring_len = counts
        self.fft_len_np = np.array([fft_length(n) for n in counts], dtype=np.int32)
        chirp, chirp_of, at = [np.zeros(0, complex)], {}, 0
        for n in np.unique(counts):
            if fft_length(n) != n:
                chirp.append(chirp_section(n))
                chirp_of[n], at = at, at + chirp[-1].size
        chirp_at = np.array([chirp_of.get(n, -1) for n in counts], dtype=np.int64)
        bluestein = self.fft_len_np != counts
        block_ring = np.argsort(-self.fft_len_np.astype(np.int64) * (1 + bluestein),
                                kind="stable")
        in_work = self.fft_len_np > MAX_SHARED_LEN
        ws_at = np.full(nrings, -1, dtype=np.int64)
        ws_at[in_work] = np.cumsum(self.fft_len_np[in_work]) - self.fft_len_np[in_work]
        self.ws_row = int(self.fft_len_np[in_work].sum())
        self._smem, self._route = {}, {}
        for name, arr in (
                ("ring_start", start), ("phi0", phi0),
                ("ring_of_pix", ring_of_pix.astype(np.int64)), ("phi", phi_pix),
                ("fft_len", self.fft_len_np), ("chirp_at", chirp_at),
                ("block_ring", block_ring.astype(np.int32)),
                ("chirp", np.concatenate(chirp).view(np.float64).reshape(-1, 2)),
                ("roots", fft_roots(self.fft_len_np.max()).view(np.float64).reshape(-1, 2)),
                ("ws_at", ws_at)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    def smem_bytes(self, nm: int, adjoint: bool) -> int:
        """Shared memory of a K10 thread block, the most any ring needs: its
        transform (``L`` complex doubles) unless that runs in the workspace
        and, for the synthesis of a ring of fewer pixels than ``nm``, the
        slab of at most :data:`FOLD_SLAB` turned coefficients it folds; at
        most ``16 (MAX_SHARED_LEN + FOLD_SLAB)`` bytes.  Kept for each
        (nm, direction)."""
        key = int(nm), bool(adjoint)
        if key not in self._smem:
            shared = np.where(self.fft_len_np <= MAX_SHARED_LEN, self.fft_len_np, 0)
            fold = 0 if adjoint else np.where(self.ring_len < nm, min(nm, FOLD_SLAB), 0)
            self._smem[key] = int(16 * np.max(shared + fold))
        return self._smem[key]

    def by_length(self):
        """For :func:`hp_longitude_fft_route`: the rings and the pixels
        ordered by ring length (int64 tensors on the table's device) and
        ``(n, first ring, rings, first pixel)`` a distinct length; built at
        first use on each device."""
        device = self.phi0.device
        if device not in self._route:
            counts = self.ring_len
            rings = np.argsort(counts, kind="stable")
            rank = np.empty(self.nrings, dtype=np.int64)
            rank[rings] = np.arange(self.nrings)
            pix = np.argsort(rank[self.ring_of_pix_np], kind="stable")
            lengths, first, nper = np.unique(counts[rings], return_index=True,
                                             return_counts=True)
            pix_first = np.concatenate([[0], np.cumsum(counts[rings])])[first]
            groups = [(int(n), int(r0), int(c), int(p0))
                      for n, r0, c, p0 in zip(lengths, first, nper, pix_first)]
            self._route[device] = (torch.from_numpy(rings).to(device),
                                   torch.from_numpy(pix).to(device), groups)
        return self._route[device]

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


def _turns(rings: HPRings, nm: int, dtype):
    """``e^{imφ0}`` for m < ``nm`` and every ring, ``(nm, nrings)``: the
    product ``m φ0`` and its phase made in float64, as :func:`_phase_chunk`
    makes them, and cast to the complex type of ``dtype``."""
    m = torch.arange(nm, dtype=torch.float64, device=rings.phi0.device)
    arg = m[:, None] * rings.phi0[None, :]
    return torch.polar(torch.ones_like(arg), arg).to(_COMPLEX[dtype])


def hp_longitude_fft_route(F, rings: HPRings):
    """The synthesis ``(B, 2, nm, nrings)`` -> ``(B, npix)`` in the ring FFT
    form with ``torch.fft``: the coefficients turned by ``e^{imφ0}``, folded
    modulo each ring's length and transformed by one batched ``ifft`` a
    distinct ring length.  The library route the kernel is timed against;
    nothing on the main path calls it."""
    nrows, _, nm, _ = F.shape
    rings_by_length, pix_by_length, groups = rings.by_length()
    coef = (torch.complex(F[:, 0], F[:, 1]) * _turns(rings, nm, F.dtype)).index_select(
        -1, rings_by_length)
    out = F.new_empty((nrows, rings.npix))
    for n, r0, count, p0 in groups:
        c = coef[..., r0:r0 + count]
        folds = -(-nm // n)
        if folds * n != nm:
            c = torch.cat([c, c.new_zeros((nrows, folds * n - nm, count))], 1)
        y = torch.fft.ifft(c.reshape(nrows, folds, n, count).sum(1), dim=1, norm="forward")
        out[:, p0:p0 + count * n] = y.real.transpose(1, 2).reshape(nrows, count * n)
    return torch.empty_like(out).index_copy_(1, pix_by_length, out)


def hp_longitude_adjoint_fft_route(ct, rings: HPRings, nm: int):
    """The adjoint ``(B, npix)`` -> ``(B, 2, nm, nrings)`` in the ring FFT
    form with ``torch.fft``: one batched ``fft`` a distinct ring length, bin
    ``m mod n`` read for every m and turned by ``e^{−imφ0}``."""
    nrows = ct.shape[0]
    rings_by_length, pix_by_length, groups = rings.by_length()
    cs = ct.index_select(1, pix_by_length)
    G = ct.new_empty((nrows, nm, rings.nrings), dtype=_COMPLEX[ct.dtype])
    m = torch.arange(nm, device=ct.device)
    for n, r0, count, p0 in groups:
        X = torch.fft.fft(cs[:, p0:p0 + count * n].reshape(nrows, count, n), dim=-1)
        G[..., r0:r0 + count] = X[:, :, m % n].transpose(1, 2)
    G = torch.empty_like(G).index_copy_(-1, rings_by_length, G)
    G = G * _turns(rings, nm, ct.dtype).conj()
    return torch.stack([G.real, G.imag], 1)


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
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dtype, sfx in _FLOAT_DTYPES.items():
        for kind, name in (("synth", f"hp_longitude_{sfx}"),
                           ("adjoint", f"hp_longitude_adjoint_{sfx}")):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 11 + [ci, ci, cll, cll, ci, ci, ci, vp]
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
    """One launch; the transforms longer than :data:`MAX_SHARED_LEN` run in
    a workspace of ``ws_row`` complex doubles a row, allocated here."""
    smem = rings.smem_bytes(nm, kind == "adjoint")
    work = (x.new_empty((x.shape[0], rings.ws_row, 2), dtype=torch.float64) if rings.ws_row
            else None)
    fn = _kernels()[kind, x.dtype]
    dev = x.get_device()
    rc = fn(x.data_ptr(), out.data_ptr(), rings.block_ring.data_ptr(),
            rings.ring_start.data_ptr(), rings.phi0.data_ptr(),
            rings.fft_len.data_ptr(), rings.chirp_at.data_ptr(), rings.chirp.data_ptr(),
            rings.roots.data_ptr(), rings.ws_at.data_ptr(),
            None if work is None else work.data_ptr(), rings.nrings, nm, rings.npix,
            rings.ws_row, x.shape[0], smem, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")


def _count(wrapper, rings: HPRings, nm: int, nrows: int, dtype):
    wrapper.launches += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_shape[rings.npix, nm, nrows] += 1
    wrapper.launches_by_dtype[_FLOAT_DTYPES[dtype]] += 1


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
    _count(hp_longitude, rings, nm, F.shape[0], F.dtype)
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
    _count(hp_longitude_adjoint, rings, nm, ct.shape[0], ct.dtype)
    return out


def reset_launch_counts():
    for fn in (hp_longitude, hp_longitude_adjoint):
        fn.launches = 0
        fn.launches_by_rows, fn.launches_by_shape = Counter(), Counter()
        fn.launches_by_dtype = Counter()


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

