"""Distributed (pencil-decomposed) FFT and Hartley transform over a mesh
axis (counterpart of :mod:`nifty_tpu.ops.distributed_fft`).

A field is sharded along its first spatial axis over the mesh's
``field`` group: each rank holds a block of rows.  The transform

1. transforms every axis but the sharded one locally,
2. transposes against the innermost axis with an all-to-all (rows ->
   column slabs; the partner axis zero-padded to a multiple of the group
   size, the pad columns sliced away after the return),
3. transforms the now whole first axis locally,
4. transposes back.

A 1-D field takes the four-step FFT (two local FFTs, a twiddle and three
all-to-alls).  The real Hartley transform runs at rfft cost: only
``n_last / 2 + 1`` columns are transformed and sent, and the other half
is rebuilt from Hermitian symmetry, with the index negation along the
sharded axis a block reversal between ranks plus a one-row edge exchange
(point to point).  No stage gathers the whole field.

Leading axes before the spatial ones (``axes``) are batch axes: the
stacked samples of the lockstep stages ride through every stage.  Both
transforms are ``torch.autograd.Function`` s whose derivatives run the
same program: the Hartley transform is symmetric, so its adjoint *is* the
forward (bitwise, the JAX package's pin under ``deterministic_reductions``),
and the FFT's adjoint is the conjugate of the forward of the conjugate.
Forward and adjoint are therefore independent of the number of ranks
wherever the local FFTs are.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..parallel import collectives as coll


def _complex(x):
    """``x`` as a complex tensor of its precision."""
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64)


def _spatial(x, axes):
    """The number of leading batch axes; the spatial axes must be the
    trailing ones."""
    if axes is None:
        return 0
    axes = tuple(sorted(a % x.ndim for a in axes))
    lead = x.ndim - len(axes)
    if axes != tuple(range(lead, x.ndim)):
        raise ValueError(f"the transformed axes must be the trailing ones; got {axes}")
    return lead


def _transpose_fft_axis0(f, group, axis: int, local_fft):
    """``local_fft`` (a 1-D transform along ``axis``) of the sharded axis
    ``axis`` of ``f``, by transposing against the innermost axis."""
    p = coll.group_size(group)
    last = f.ndim - 1
    n_t = f.shape[last]
    pad = (-n_t) % p
    if pad:
        f = torch.nn.functional.pad(f, (0, pad))
    f = coll.all_to_all(f, group, split_dim=last, concat_dim=axis)
    f = local_fft(f)
    f = coll.all_to_all(f, group, split_dim=axis, concat_dim=last)
    if pad:
        f = f[..., :n_t]
    return f


def _four_step_fft1d(x, group):
    """Distributed 1-D FFT of a block-sharded (L, m) batch of vectors
    (global length p * m): a length-p DFT across ranks, a twiddle, a
    length-m DFT, and a redistribution from interleaved to blocks."""
    p, i = coll.group_size(group), coll.group_rank(group)
    nl, m = x.shape
    if m % p:
        raise ValueError(f"the distributed 1-D FFT needs the local block ({m}) divisible by "
                         f"the ranks ({p})")
    n = p * m
    x = _complex(x)
    # global a = a1 * m + a2 with a1 the rank; bring an a2 chunk's rows together
    z = coll.all_to_all(x.reshape(nl, p, m // p), group, split_dim=1, concat_dim=1)
    z = torch.fft.fft(z, dim=1)  # over a1 -> b1
    b1 = torch.arange(p, device=x.device)[:, None]
    a2 = i * (m // p) + torch.arange(m // p, device=x.device)[None, :]
    rdt = z.real.dtype
    phase = (-2.0 * math.pi / n) * (b1 * a2).to(rdt)
    z = z * torch.polar(torch.ones_like(phase), phase)
    z = coll.all_to_all(z, group, split_dim=1, concat_dim=2)[:, 0]  # row b1 = i, by a2
    z = torch.fft.fft(z, dim=1)  # over a2 -> b2; y[b2 * p + b1] = z[b2]
    z = coll.all_to_all(z.reshape(nl, p, 1, m // p), group, split_dim=1, concat_dim=2)[:, 0]
    return z.transpose(1, 2).reshape(nl, m)  # local l = r * p + b1


def _mirror_axis0(a, group, axis: int):
    """Global index negation ``g -> (-g) mod n`` along the sharded axis:
    block reversal between ranks, a local flip, a one-row roll."""
    p, i = coll.group_size(group), coll.group_rank(group)
    a = coll.exchange(a, group, p - 1 - i, p - 1 - i)
    a = a.flip(axis)  # now A1[g] = A[n - 1 - g]
    edge = coll.exchange(a.narrow(axis, a.shape[axis] - 1, 1), group, (i + 1) % p,
                         (i - 1) % p)
    return torch.cat([edge, a.narrow(axis, 0, a.shape[axis] - 1)], dim=axis)


def _combine(re, im):
    if config.get("hartley_convention") == "non_canonical_hartley":
        return re + im
    return re - im


def _fft_along(v, axis: int):
    """The 1-D FFT along ``axis``, computed on contiguous rows with the
    axis innermost: a strided transform's bits depend on how many others
    share its batch (measured with the CPU's FFT), a contiguous row's do
    not, so every world size transforms each column alike."""
    return torch.fft.fft(v.movedim(axis, -1).contiguous(), dim=-1).movedim(-1, axis)


def _middle_axes(f, lead: int):
    """The 1-D FFTs along the axes between the sharded one and the last,
    each on contiguous rows (:func:`_fft_along`), as the sharded axis's:
    a 2-D transform of a slab's planes may pick its plan by the number of
    planes a rank holds."""
    for ax in range(lead + 1, f.ndim - 1):
        f = _fft_along(f, ax)
    return f


def _fftn_sharded(x, group, lead: int):
    """Complex n-D FFT of a field sharded along axis ``lead``."""
    x = _complex(x)
    if x.ndim - lead == 1:
        shape = x.shape
        return _four_step_fft1d(x.reshape(-1, shape[-1]), group).reshape(shape)
    f = _middle_axes(torch.fft.fftn(x, dim=(x.ndim - 1,)), lead)
    return _transpose_fft_axis0(f, group, lead, lambda v: _fft_along(v, lead))


def _hartley_sharded(x, group, lead: int):
    """Real Hartley transform of a field sharded along axis ``lead``, at
    rfft cost."""
    nd = x.ndim - lead
    if nd == 1:
        shape = x.shape
        f = _four_step_fft1d(x.reshape(-1, shape[-1]), group).reshape(shape)
        return _combine(f.real, f.imag)
    n_last = x.shape[-1]
    f = _middle_axes(torch.fft.rfftn(x, dim=(x.ndim - 1,)), lead)
    f = _transpose_fft_axis0(f, group, lead, lambda v: _fft_along(v, lead))
    h_low = _combine(f.real, f.imag)
    # the redundant half, F[k] = conj(F[-k]): the mirrored columns 1 ..
    # ceil(n_last / 2) - 1 negated along the sharded axis (across ranks),
    # the middle axes (locally) and the last axis (a reversed slice)
    hi = n_last - n_last // 2
    g = _mirror_axis0(f[..., 1:hi], group, lead)
    for ax in range(lead + 1, x.ndim - 1):
        g = torch.roll(g.flip(ax), 1, dims=ax)
    g = g.flip(-1)
    return torch.cat([h_low, _combine(g.real, -g.imag)], dim=-1)


class _DistributedHartley(torch.autograd.Function):
    """Self-adjoint: the derivative runs the forward program."""

    @staticmethod
    def forward(x, group, lead):
        return _hartley_sharded(x.contiguous(), group, lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.lead = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _DistributedHartley.apply(g, ctx.group, ctx.lead), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _DistributedHartley.apply(t, ctx.group, ctx.lead)

    @staticmethod
    def vmap(info, in_dims, x, group, lead):
        return _DistributedHartley.apply(x.movedim(in_dims[0], 0), group, lead + 1), 0


class _DistributedFFT(torch.autograd.Function):
    """Linear in ``x``; the adjoint is ``conj(F conj(g))`` (the DFT matrix
    is symmetric)."""

    @staticmethod
    def forward(x, group, lead):
        return _fftn_sharded(x.contiguous(), group, lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.lead = inputs[1], inputs[2]
        ctx.real_input = not inputs[0].is_complex()

    @staticmethod
    def backward(ctx, g):
        adj = _DistributedFFT.apply(g.conj(), ctx.group, ctx.lead).conj().resolve_conj()
        return (adj.real if ctx.real_input else adj), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _DistributedFFT.apply(t, ctx.group, ctx.lead)

    @staticmethod
    def vmap(info, in_dims, x, group, lead):
        return _DistributedFFT.apply(x.movedim(in_dims[0], 0), group, lead + 1), 0


def _group(mesh, axis_name):
    return None if mesh is None else mesh.group(axis_name)


def distributed_fftn(x, mesh, axis_name: str = "field", axes=None):
    """n-D complex FFT of a field sharded along its first spatial axis over
    ``mesh``'s ``axis_name`` group; ``axes`` (trailing) are the spatial
    axes, any before them batch axes (default: every axis)."""
    return _DistributedFFT.apply(x, _group(mesh, axis_name), _spatial(x, axes))


def distributed_hartley(x, mesh, axis_name: str = "field", axes=None):
    """Hartley transform of a real field sharded along its first spatial
    axis, at rfft cost (only ``n_last / 2 + 1`` spectral columns are
    transformed and sent).  Forward and adjoint are one program, so they
    agree bitwise and do not depend on the world size.  A correlated field
    takes it as ``finalize(hartley_fn=lambda x, axes=None:
    distributed_hartley(x, mesh, axes=axes))``."""
    return _DistributedHartley.apply(x, _group(mesh, axis_name), _spatial(x, axes))


__all__ = ["distributed_fftn", "distributed_hartley"]
