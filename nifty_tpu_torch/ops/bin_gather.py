"""The power distributor: a small-table gather and its per-bin segment sum
(counterpart of :mod:`nifty_tpu.ops.pallas_gather`).

The correlated field spreads a small amplitude table onto every harmonic
mode, ``amp_full = table[idx]``, with a constant index map; the adjoint is
the per-bin segment sum.  Both are hand-written CUDA kernels
(``csrc/bin_gather.cu``) with a plain PyTorch version beside each:

- :func:`bin_gather` replaces the TPU kernels ``_pallas_gather``
  (``nifty_tpu/ops/pallas_gather.py:184``, K1, select loop) and
  ``_pallas_gather_mxu`` (``:369``, K3, one-hot MXU chunks).  At the
  4096^2 ``n_bins=128`` shape (a (1, 113) table over the 2049^2 quarter
  map) the device time is bound by memory writes: the kernel reads the
  index map at the narrowest width that holds the bin count
  (:attr:`BinIndex.idx_narrow`: uint8, int16 or int32), so a float64
  entry moves 9 B instead of 12, and writes 16 B per lane with streaming
  stores, every warp instruction on one contiguous span.  At the 128^2
  shape (an (8, 1621) table over 128^2 entries) the device moves 1 MB in
  a few microseconds and the host's launch path bounds the call, so the
  wrapper does no per-call work beyond the checks, one allocation and the
  ``ctypes`` call, and the C launcher caches each device's constants.
  Each block stages the tables of a tile of rows in shared memory, and
  one index load serves every row of the tile.
- :func:`bin_segment_sum` replaces ``_pallas_scatter`` (``:228``) and
  ``_pallas_scatter_mxu`` (``:406``), and computes what the XLA sorted
  route (``sorted_bin_gather``, ``:1013``) does for grid-scale maps.  It
  reduces each bin's CSR segment of a host-precomputed stable sort
  (:func:`sorted_scatter_aux`) with no atomics, so one kernel serves both
  ``deterministic_reductions`` settings.  The order of its additions is
  fixed by the map alone: :func:`segment_work_items` cuts the segments
  into work items from the CSR offsets and :data:`SEGMENT_CHUNK`, a warp
  for each bin of at most 32 entries and a block for each chunk of a
  longer bin, with a second pass over the chunk partials of split bins.
  It is bound by the 4 B permutation plus ``itemsize`` B cotangent read
  per entry at 4096^2, and by latency at 128^2, where the data sits in
  L2; a block loads each permutation entry once for a tile of rows.

Each wrapper runs the plain version for a CPU tensor only; for a CUDA
tensor it launches its kernel or raises.  ``bin_gather.launches`` and
``bin_segment_sum.launches`` count calls that take the kernel route
(never plain runs); ``bin_segment_sum.kernel_launches`` counts the
kernels those calls launched.

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
_INDEX_DTYPES = {torch.uint8: "u8", torch.int16: "i16", torch.int32: "i32"}
_MAX_ROWS = 65535  # gridDim.y
#: Entries of a segment-sum block's work item at most, and of a segment that
#: one warp sums (one lane each).  The kernel fixes both (``kChunk`` and
#: ``kShort`` in ``csrc/bin_gather.cu``); :func:`_kernels` checks that they
#: agree.
SEGMENT_CHUNK = 2048
SHORT_SEGMENT = 32


def sorted_scatter_aux(idx, nb: int) -> dict:
    """Host precompute for the segment sum: the stable sort permutation of
    the flat index map and the CSR offsets of each bin's segment in it."""
    flat = np.asarray(idx).ravel()
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=nb)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return {"perm": perm, "offsets": offsets}


def segment_work_items(offsets) -> dict:
    """The segment-sum kernel's work items, from the CSR offsets and
    :data:`SEGMENT_CHUNK` alone (so the order of its additions never
    depends on the card, the grid or the number of rows).

    ``items`` (int32, (n_items, 4)) holds ``{bin, lo, hi, slot}``: first one
    item per bin of at most :data:`SHORT_SEGMENT` entries, empty bins too,
    in bin order (a warp each); then each longer bin cut into chunks
    ``[lo + c * C, min(lo + (c + 1) * C, hi))`` of ``C =``
    :data:`SEGMENT_CHUNK` in bin and chunk order (a block each).  A chunk of a bin cut into more than one
    (a split bin) writes its partial sum to ``slot``, numbered over split
    bins and chunks in order; every other item has slot -1 and writes the
    bin's sum.  ``split`` (int32, (n_split, 4)) holds ``{bin, first slot,
    chunks, 0}`` for the second pass.  ``n_short`` and ``n_slots`` are the
    counts of short items and of slots."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lo, hi = offsets[:-1], offsets[1:]
    lens = hi - lo
    short = lens <= SHORT_SEGMENT
    bins = np.flatnonzero(~short)
    chunks = -(-lens[bins] // SEGMENT_CHUNK)
    first = np.cumsum(chunks) - chunks  # each long bin's first chunk
    cbin = np.repeat(bins, chunks)
    c = np.arange(cbin.size) - np.repeat(first, chunks)
    clo = lo[cbin] + c * SEGMENT_CHUNK
    split = chunks > 1
    # slots count the chunks of split bins only
    in_split = np.repeat(split, chunks)
    slot = np.where(in_split, np.cumsum(in_split) - 1, -1)
    short_bins = np.flatnonzero(short)
    items = np.concatenate([
        np.stack([short_bins, lo[short], hi[short], np.full(short_bins.size, -1)], axis=1),
        np.stack([cbin, clo, np.minimum(clo + SEGMENT_CHUNK, hi[cbin]), slot], axis=1),
    ]).astype(np.int32)
    nsplit = chunks[split]
    split_table = np.stack([bins[split], np.cumsum(nsplit) - nsplit, nsplit,
                            np.zeros_like(nsplit)], axis=1).astype(np.int32)
    return {"items": items.reshape(-1, 4), "split": split_table.reshape(-1, 4),
            "n_short": int(short_bins.size), "n_slots": int(nsplit.sum())}


def narrow_index_dtype(nb: int) -> torch.dtype:
    """The narrowest integer type that holds every bin of ``nb``."""
    if nb <= 256:
        return torch.uint8
    return torch.int16 if nb <= 32768 else torch.int32


class BinIndex(nn.Module):
    """A constant index map with its sort permutation and CSR offsets, as
    buffers (``.to(device)`` moves them).

    ``idx`` is the map as int32 (the plain versions and the host
    precompute use it); ``idx_narrow`` holds the same values at
    :func:`narrow_index_dtype` width for the gather kernel; ``seg_items``
    and ``seg_split`` are the segment-sum kernel's work items
    (:func:`segment_work_items`).  Those three are derived from the map, so
    they stay out of ``state_dict``."""

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
        idx_t = torch.from_numpy(idx.ravel().astype(np.int32))
        self.register_buffer("idx", idx_t)
        self.register_buffer("idx_narrow", idx_t.to(narrow_index_dtype(nb)), persistent=False)
        self.register_buffer("perm", torch.from_numpy(aux["perm"]))
        self.register_buffer("offsets", torch.from_numpy(aux["offsets"]))
        work = segment_work_items(aux["offsets"])
        self.n_items = len(work["items"])
        self.n_short = work["n_short"]
        self.n_split = len(work["split"])
        self.n_slots = work["n_slots"]
        self.register_buffer("seg_items", torch.from_numpy(work["items"]), persistent=False)
        self.register_buffer("seg_split", torch.from_numpy(work["split"]), persistent=False)

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
        for dtype, sfx in _FLOAT_DTYPES.items():
            for itype, isfx in _INDEX_DTYPES.items():
                g = getattr(lib, f"bin_gather_{sfx}_{isfx}")
                g.argtypes = [vp, vp, vp, ll, ci, ci, ci, vp]
                g.restype = ci
                _KERNELS[dtype, itype] = g
            s = getattr(lib, f"bin_segment_sum_{sfx}")
            s.argtypes = [vp, vp, vp, vp, vp, vp, ll, *[ci] * 7, vp]
            s.restype = ci
            _KERNELS["segment_sum", dtype] = s
        built = (lib.bin_segment_sum_chunk(), lib.bin_segment_sum_short())
        if built != (SEGMENT_CHUNK, SHORT_SEGMENT):
            _KERNELS.clear()
            raise RuntimeError(
                f"segment-sum kernel built for items of at most {built} entries (block, "
                f"warp); the work items use {(SEGMENT_CHUNK, SHORT_SEGMENT)}"
            )
    return _KERNELS


def _check_values(x, dist: BinIndex, width: int, what: str):
    shape = x.shape
    if len(shape) != 2 or shape[1] != width:
        raise ValueError(f"{what} must have shape (B, {width}); got {tuple(shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{what} must be float32 or float64; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    # buffers read through _buffers: Module.__getattr__ costs more than
    # all of these checks together
    if x.device != dist._buffers["idx"].device:
        raise ValueError(
            f"{what} on {x.device} but the index map on {dist.idx.device}"
        )
    if shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows; got {shape[0]}")


def bin_gather(table, dist: BinIndex):
    """``out[b, j] = table[b, dist.idx[j]]`` for a (B, nb) table."""
    _check_values(table, dist, dist.nb, "table")
    if not table.is_cuda:
        if table.device.type == "cpu":
            return bin_gather_plain(table, dist.idx)
        raise RuntimeError(f"no bin_gather kernel for device {table.device}")
    idx = dist._buffers["idx_narrow"]
    fn = (_KERNELS or _kernels())[table.dtype, idx.dtype]
    nrows = table.shape[0]
    out = table.new_empty((nrows, dist.n))
    # The C launcher switches to the tensors' device only if it is not
    # current.  The stream is PyTorch's current one on that device, as a raw
    # handle (``torch.cuda.current_stream(dev).cuda_stream`` without
    # building a Stream object).
    dev = table.get_device()
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), dist.n, dist.nb, nrows,
            dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {rc}")
    bin_gather.launches += 1
    return out


bin_gather.launches = 0


def bin_segment_sum(cot, dist: BinIndex):
    """``out[b, k] = sum_{j: dist.idx[j] = k} cot[b, j]`` for a (B, n)
    cotangent; deterministic on every device.

    ``bin_segment_sum.launches`` counts calls that take the kernel route,
    one each, whatever the number of kernels a call launches, so that the
    count compares across kernel designs.  ``bin_segment_sum.
    kernel_launches`` counts the kernels those calls launched, as the C
    entry reports them: one a call, two where the map has split bins (the
    chunks, then the second pass over the split bins' partials)."""
    _check_values(cot, dist, dist.n, "cotangent")
    if not cot.is_cuda:
        if cot.device.type == "cpu":
            return bin_segment_sum_plain(cot, dist.perm, dist.offsets)
        raise RuntimeError(f"no bin_segment_sum kernel for device {cot.device}")
    fn = (_KERNELS or _kernels())["segment_sum", cot.dtype]
    nrows = cot.shape[0]
    out = cot.new_empty((nrows, dist.nb))
    # the split bins' chunk partials: scratch from the caching allocator
    # (so the call can be captured in a CUDA graph)
    partials = cot.new_empty((nrows, dist.n_slots)) if dist.n_split else None
    b = dist._buffers
    dev = cot.get_device()
    rc = fn(cot.data_ptr(), b["perm"].data_ptr(), b["seg_items"].data_ptr(),
            b["seg_split"].data_ptr(), None if partials is None else partials.data_ptr(),
            out.data_ptr(), dist.n, dist.nb,
            dist.n_short, dist.n_items, dist.n_split, dist.n_slots, nrows, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    bin_segment_sum.launches += 1
    bin_segment_sum.kernel_launches += rc
    return out


bin_segment_sum.launches = 0
bin_segment_sum.kernel_launches = 0


def reset_launch_counts():
    bin_gather.launches = 0
    bin_segment_sum.launches = 0
    bin_segment_sum.kernel_launches = 0


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
