"""Harmonic-space primitives: the Hartley transform and the host-side
Fourier-mode helpers (counterpart of :mod:`nifty_tpu.ops.harmonic`).

The Hartley transform of a real field is a real FFT (``torch.fft.rfftn``)
plus a Hermitian-symmetry unfold onto the full grid; autograd supplies its
adjoint.  The mode helpers are host numpy code, copied from the JAX
package because importing that package imports jax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import config


def _axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    return tuple(a % x.ndim for a in axes)


def hartley_via_c2c(x, axes: Optional[Tuple[int, ...]] = None):
    """Hartley transform via a complex FFT (works for complex input too)."""
    tmp = torch.fft.fftn(x, dim=_axes(x, axes))
    if config.get("hartley_convention") == "non_canonical_hartley":
        return tmp.real + tmp.imag
    return tmp.real - tmp.imag


def _unfold_hermitian(half, full_shape, axes):
    """Reconstruct the full-grid Hartley combination from an rfft half.

    For real input ``F(-k) = conj(F(k))``: the missing tail along the rfft
    axis is the stored half index-reversed (``k -> -k mod n``) on every
    transformed axis, with the sign of the imaginary part flipped.
    """
    ax_last = axes[-1]
    n_last = full_shape[ax_last]
    n_half = half.shape[ax_last]

    sgn = 1.0 if config.get("hartley_convention") == "non_canonical_hartley" else -1.0
    h_stored = half.real + sgn * half.imag

    tail = half.narrow(ax_last, 1, n_last - n_half).flip(ax_last)
    for ax in axes[:-1]:
        # k -> (-k) mod n along a fully stored axis
        tail = torch.roll(tail.flip(ax), 1, dims=ax)
    h_tail = tail.real - sgn * tail.imag
    return torch.cat([h_stored, h_tail], dim=ax_last)


def hartley(x, axes: Optional[Tuple[int, ...]] = None):
    """Hartley transform; real-FFT path for real inputs.

    The JAX package pins the transpose to the forward program under
    ``deterministic_reductions`` to make it mesh independent; with one
    device and autograd's fixed adjoint there is nothing to pin here.
    """
    axes = _axes(x, axes)
    if x.is_complex():
        return hartley_via_c2c(x, axes=axes)
    half = torch.fft.rfftn(x, dim=axes)
    return _unfold_hermitian(half, tuple(x.shape), axes)


def fftn(x, axes: Optional[Tuple[int, ...]] = None):
    """The FFT over ``axes`` (``None``: every axis)."""
    return torch.fft.fftn(x, dim=axes)


def ifftn(x, axes: Optional[Tuple[int, ...]] = None):
    """The inverse FFT over ``axes`` (``None``: every axis)."""
    return torch.fft.ifftn(x, dim=axes)


def fourier_mode_lengths(shape, distances) -> np.ndarray:
    """|k| for every mode of an fft-ordered full grid (host precompute)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = np.broadcast_to(np.asarray(distances, dtype=np.float64), (len(shape),))
    mspc_dist = 1.0 / (np.array(shape) * distances)

    m2 = np.zeros(shape, dtype=np.float64)
    for i, (n, d) in enumerate(zip(shape, mspc_dist)):
        k = np.arange(n, dtype=np.float64)
        k = np.minimum(k, n - k) * d
        sl = [None] * len(shape)
        sl[i] = slice(None)
        m2 = m2 + (k ** 2)[tuple(sl)]
    return np.sqrt(m2)


def fourier_mode_index_quarter(shape, distances, unique_lengths) -> np.ndarray:
    """Power-distributor index map on the per-axis folded quarter grid.

    ``|k|`` depends on each fft-ordered axis index ``i`` only through
    ``min(i, n - i)``, so ``idx_full[i0, i1, ...] = idx_q[fold(i0),
    fold(i1), ...]`` with quarter axes of length ``n//2 + 1``.
    ``unique_lengths`` must be the table of :func:`fourier_mode_distributor`
    so the indices agree with the full map exactly.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = np.broadcast_to(
        np.asarray(distances, dtype=np.float64), (len(shape),)
    )
    mspc_dist = 1.0 / (np.array(shape) * distances)
    q_shape = tuple(n // 2 + 1 for n in shape)
    m2 = np.zeros(q_shape, dtype=np.float64)
    for i, (n, d) in enumerate(zip(shape, mspc_dist)):
        k = np.arange(n // 2 + 1, dtype=np.float64) * d
        sl = [None] * len(shape)
        sl[i] = slice(None)
        m2 = m2 + (k ** 2)[tuple(sl)]
    mq = np.sqrt(m2)
    um = np.asarray(unique_lengths)
    binbounds = 0.5 * (um[:-1] + um[1:])
    return np.searchsorted(binbounds, mq).astype(np.int32)


def fourier_mode_distributor(shape, distances):
    """Unique mode lengths, bin index per mode, and bin multiplicity.

    Returns ``(mode_length_idx [int32 ndarray shape], unique_lengths,
    multiplicity)``.
    """
    m_length = fourier_mode_lengths(shape, distances)
    um = np.unique(m_length)
    tol = 1e-12 * um[-1]
    um = um[np.diff(np.append(um, 2 * um[-1])) > tol]
    binbounds = 0.5 * (um[:-1] + um[1:])
    m_length_idx = np.searchsorted(binbounds, m_length).astype(np.int32)
    m_count = np.bincount(m_length_idx.ravel(), minlength=um.size)
    if np.any(m_count == 0) or um.shape != m_count.shape:
        raise RuntimeError("invalid harmonic mode(s) encountered")
    return m_length_idx, um, m_count
