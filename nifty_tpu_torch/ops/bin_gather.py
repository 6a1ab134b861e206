"""The power distributor: a small-table gather and its per-bin segment sum
(counterpart of :mod:`nifty_tpu.ops.pallas_gather`).

The correlated field spreads a small amplitude table onto every harmonic
mode, ``amp_full = table[idx]``, with a constant index map; the adjoint is
the per-bin segment sum.  Both are hand-written CUDA kernels
(``csrc/bin_gather.cu``) with a plain PyTorch version beside each:

- :func:`bin_gather` replaces the TPU kernels ``_pallas_gather``
  (``nifty_tpu/ops/pallas_gather.py:184``, select loop) and
  ``_pallas_gather_mxu`` (``:369``, one-hot MXU chunks).  It stages the
  row's table in shared memory and copies one element per thread; it is
  bound by the 4 B index read plus the ``itemsize`` B store per element.
- :func:`bin_segment_sum` replaces ``_pallas_scatter`` (``:228``) and
  ``_pallas_scatter_mxu`` (``:406``), and computes what the XLA sorted
  route (``sorted_bin_gather``, ``:1013``) does for grid-scale maps.  It
  reduces each bin's CSR segment of a host-precomputed stable sort
  (:func:`sorted_scatter_aux`) in a fixed order, with no atomics, so one
  kernel serves both ``deterministic_reductions`` settings.  It is bound by
  the 4 B permutation plus ``itemsize`` B cotangent read per element, and
  with one block per bin by the largest bin.

Each wrapper runs the plain version for a CPU tensor only; for a CUDA
tensor it launches its kernel or raises.  ``bin_gather.launches`` and
``bin_segment_sum.launches`` count kernel launches (never plain runs).

:class:`BinGather` and :class:`BinSegmentSum` are the
``torch.autograd.Function`` pair: each one's derivative is the other, with
``setup_context``, ``jvp`` and ``vmap`` so that ``torch.func.jvp``,
``vjp``, ``linearize`` and ``vmap`` compose with them, and autograd's
double backward (which the metric's hoisted linearization uses) reaches
both kernels.  The index map is always one shared buffer
(:class:`BinIndex`); the JAX package's per-sample index maps
(``batched_idx``) and ``StaticIndexMap`` primitives are tracing artefacts
with no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from .cuda_build import load_library

_FLOAT_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_MAX_ROWS = 65535  # gridDim.y


def sorted_scatter_aux(idx, nb: int) -> dict:
    """Host precompute for the segment sum: the stable sort permutation of
    the flat index map and the CSR offsets of each bin's segment in it."""
    flat = np.asarray(idx).ravel()
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=nb)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return {"perm": perm, "offsets": offsets}


class BinIndex(nn.Module):
    """A constant index map with its sort permutation and CSR offsets, as
    buffers (``.to(device)`` moves them)."""

    def __init__(self, idx, nb=None):
        super().__init__()
        idx = np.asarray(idx)
        if not np.issubdtype(idx.dtype, np.integer):
            raise TypeError(f"index map must be integer; got {idx.dtype}")
        nb = int(idx.max()) + 1 if nb is None else int(nb)
        if idx.size and (idx.min() < 0 or idx.max() >= nb):
            raise ValueError(f"index map entries must lie in [0, {nb})")
        if idx.size >= 2**31:
            raise ValueError("index maps of 2^31 entries or more are not supported")
        aux = sorted_scatter_aux(idx, nb)
        self.shape = tuple(idx.shape)
        self.nb = nb
        self.n = int(idx.size)
        self.register_buffer("idx", torch.from_numpy(idx.ravel().astype(np.int32)))
        self.register_buffer("perm", torch.from_numpy(aux["perm"]))
        self.register_buffer("offsets", torch.from_numpy(aux["offsets"]))

    def extra_repr(self):
        return f"shape={self.shape}, nb={self.nb}"


# -- plain versions -------------------------------------------------------


def bin_gather_plain(table, idx):
    """``table[:, idx]`` for a (B, nb) table and a flat int32 index map."""
    return table.index_select(1, idx)


def bin_segment_sum_plain(cot, perm, offsets):
    """Per-bin sums of a (B, n) cotangent: gather through the sort
    permutation, then a sorted segment reduction over the CSR offsets."""
    nrows = cot.shape[0]
    vals = cot.index_select(1, perm)
    offs = offsets.expand(nrows, offsets.shape[0]).contiguous()
    return torch.segment_reduce(vals, "sum", offsets=offs, axis=1)


# -- kernel wrappers ------------------------------------------------------

_KERNELS: dict = {}


def _kernels():
    if not _KERNELS:
        lib = load_library("bin_gather")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for sfx in ("f32", "f64"):
            g = getattr(lib, f"bin_gather_{sfx}")
            g.argtypes = [vp, vp, vp, ll, ci, ci, vp]
            g.restype = ci
            s = getattr(lib, f"bin_segment_sum_{sfx}")
            s.argtypes = [vp, vp, vp, vp, ll, ci, ci, vp]
            s.restype = ci
            _KERNELS[f"gather_{sfx}"] = g
            _KERNELS[f"segment_sum_{sfx}"] = s
    return _KERNELS


def _check_values(x, dist: BinIndex, width: int, what: str):
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{what} must have shape (B, {width}); got {tuple(x.shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{what} must be float32 or float64; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dist.idx.device != x.device:
        raise ValueError(
            f"{what} on {x.device} but the index map on {dist.idx.device}"
        )
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows; got {x.shape[0]}")


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {rc}")


def bin_gather(table, dist: BinIndex):
    """``out[b, j] = table[b, dist.idx[j]]`` for a (B, nb) table."""
    _check_values(table, dist, dist.nb, "table")
    if table.device.type == "cpu":
        return bin_gather_plain(table, dist.idx)
    if table.device.type != "cuda":
        raise RuntimeError(f"no bin_gather kernel for device {table.device}")
    fn = _kernels()["gather_" + _FLOAT_DTYPES[table.dtype]]
    out = torch.empty((table.shape[0], dist.n), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        _launch(fn, table.data_ptr(), dist.idx.data_ptr(), out.data_ptr(),
                dist.n, dist.nb, table.shape[0], stream)
    bin_gather.launches += 1
    return out


bin_gather.launches = 0


def bin_segment_sum(cot, dist: BinIndex):
    """``out[b, k] = sum_{j: dist.idx[j] = k} cot[b, j]`` for a (B, n)
    cotangent; deterministic on every device."""
    _check_values(cot, dist, dist.n, "cotangent")
    if cot.device.type == "cpu":
        return bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    if cot.device.type != "cuda":
        raise RuntimeError(f"no bin_segment_sum kernel for device {cot.device}")
    fn = _kernels()["segment_sum_" + _FLOAT_DTYPES[cot.dtype]]
    out = torch.empty((cot.shape[0], dist.nb), dtype=cot.dtype, device=cot.device)
    with torch.cuda.device(cot.device):
        stream = torch.cuda.current_stream(cot.device).cuda_stream
        _launch(fn, cot.data_ptr(), dist.perm.data_ptr(), dist.offsets.data_ptr(),
                out.data_ptr(), dist.n, dist.nb, cot.shape[0], stream)
    bin_segment_sum.launches += 1
    return out


bin_segment_sum.launches = 0


def reset_launch_counts():
    bin_gather.launches = 0
    bin_segment_sum.launches = 0


# -- autograd pair --------------------------------------------------------


class BinGather(torch.autograd.Function):
    """(B, nb) table -> (B, n) gathered values; derivative: the segment sum."""

    @staticmethod
    def forward(table, dist):
        return bin_gather(table, dist)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dist = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return BinSegmentSum.apply(grad_out.contiguous(), ctx.dist), None

    @staticmethod
    def jvp(ctx, table_dot, _dist_dot):
        return BinGather.apply(table_dot.contiguous(), ctx.dist)

    @staticmethod
    def vmap(info, in_dims, table, dist):
        if in_dims[0] is None:
            return BinGather.apply(table, dist), None
        t = table.movedim(in_dims[0], 0)
        nv, nrows, nb = t.shape
        out = BinGather.apply(t.reshape(nv * nrows, nb).contiguous(), dist)
        return out.reshape(nv, nrows, -1), 0


class BinSegmentSum(torch.autograd.Function):
    """(B, n) cotangent -> (B, nb) per-bin sums; derivative: the gather."""

    @staticmethod
    def forward(cot, dist):
        return bin_segment_sum(cot, dist)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dist = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return BinGather.apply(grad_out.contiguous(), ctx.dist), None

    @staticmethod
    def jvp(ctx, cot_dot, _dist_dot):
        return BinSegmentSum.apply(cot_dot.contiguous(), ctx.dist)

    @staticmethod
    def vmap(info, in_dims, cot, dist):
        if in_dims[0] is None:
            return BinSegmentSum.apply(cot, dist), None
        c = cot.movedim(in_dims[0], 0)
        nv, nrows, n = c.shape
        out = BinSegmentSum.apply(c.reshape(nv * nrows, n).contiguous(), dist)
        return out.reshape(nv, nrows, -1), 0


def distribute_power(table, dist: BinIndex):
    """Spread a (..., nb) amplitude table onto ``(..., *dist.shape)``."""
    lead = tuple(table.shape[:-1])
    t2 = table.reshape(-1, table.shape[-1]).contiguous()
    return BinGather.apply(t2, dist).reshape(*lead, *dist.shape)


def segment_sum(cot, dist: BinIndex):
    """Adjoint of :func:`distribute_power`: ``(..., *dist.shape)`` ->
    ``(..., nb)``."""
    lead = tuple(cot.shape[: cot.ndim - len(dist.shape)])
    c2 = cot.reshape(-1, dist.n).contiguous()
    return BinSegmentSum.apply(c2, dist).reshape(*lead, dist.nb)
