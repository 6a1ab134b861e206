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
  one index load serves every row of the tile.  At grid-scale unbinned
  maps (82,799 modes at 1024^2, 1.2 million at 4096^2) the table is too
  large for shared memory and is read from L2, a 32-byte sector for every
  8-byte entry: one row a tile and one 16-byte group a thread with one or
  two rows, and from :data:`ROWS_INNERMOST_MIN` rows on through a
  rows-innermost (nb, B) copy of the table, so that one entry's rows are
  one or two sectors (:func:`rows_innermost_columns`; two kernels a call).
- :func:`bin_segment_sum` replaces ``_pallas_scatter`` (``:228``) and
  ``_pallas_scatter_mxu`` (``:406``), and computes what the XLA sorted
  route (``sorted_bin_gather``, ``:1013``) does for grid-scale maps.  It
  reduces each bin's CSR segment of a host-precomputed stable sort
  (:func:`sorted_scatter_aux`) with no atomics, so one kernel serves both
  ``deterministic_reductions`` settings.  The order of its additions is
  fixed by the map alone: :func:`segment_work_items` cuts the segments
  into work from the CSR offsets and a few constants.  A bin of at most
  32 entries is summed by 4, 8 or 32 adjacent lanes, as its length alone
  decides (:data:`SHORT_WIDTHS`), so that a warp serves up to eight of the
  short bins that make up an unbinned map, with the bits that a whole
  warp a bin would give; a longer bin is cut into chunks of
  :data:`SEGMENT_CHUNK`, a block each, with a second pass over the chunk
  partials of split bins.  It is bound by the 4 B permutation plus
  ``itemsize`` B cotangent read per entry at 4096^2 with 128 bins, by
  latency at 128^2, where the data sits in L2, and by scattered 8-byte
  cotangent reads (a 32-byte sector each) at the unbinned quarter maps; a
  block loads each permutation entry once for a tile of rows.

Each wrapper runs the plain version for a CPU tensor only; for a CUDA
tensor it launches its kernel or raises.  ``bin_gather.launches`` and
``bin_segment_sum.launches`` count calls that take the kernel route
(never plain runs); each wrapper's ``kernel_launches`` counts the kernels
those calls launched; ``launches_by_rows`` and ``kernel_launches_by_rows``
hold the same two counts by the number of rows B the calls served, and
``launches_by_map`` and ``kernel_launches_by_map`` by the map (its shape
and bin count) and B, for runs that distribute onto several maps, and
``launches_by_dtype`` the calls by the values' float type.

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
from collections import Counter

import numpy as np
import torch
from torch import nn

from .cuda_build import load_library

_FLOAT_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_INDEX_DTYPES = {torch.uint8: "u8", torch.int16: "i16", torch.int32: "i32"}
_MAX_ROWS = 65535  # gridDim.y
#: Entries of a segment-sum block's work item at most; of a short bin at
#: most (longer bins are cut into block items); and the classes of short
#: bins: a bin of at most ``w`` entries is summed by ``w`` adjacent lanes, for
#: the least such ``w`` here.  The kernel fixes all three (``kChunk``,
#: ``kShort`` and ``kWidths`` in ``csrc/bin_gather.cu``); :func:`_kernels`
#: checks that they agree.
SEGMENT_CHUNK = 2048
SHORT_SEGMENT = 32
SHORT_WIDTHS = (4, 8, 32)
_MAX_WIDTHS = 4  # class counts a C entry takes
_BLOCK_THREADS = 256  # threads of a segment-sum block (kSegThreads)
#: A class's list of short bins is cut into pieces of ``SHORT_VALUES * 256 /
#: w`` bins (``kShortValues``; 256 threads a block), which the kernel's
#: blocks take in the order of the pieces' first bins.
SHORT_VALUES = 2
#: A table too large for a block's shared memory is copied rows-innermost
#: before the gather from this many rows on, if the copy fits in half of the
#: card's L2 (:func:`rows_innermost_columns`; the kernel takes the copy's
#: route where it is given scratch for it).
ROWS_INNERMOST_MIN = 3


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
    """The segment-sum kernel's work, from the CSR offsets,
    :data:`SEGMENT_CHUNK` and :data:`SHORT_WIDTHS` alone (so the order of
    its additions never depends on the card, the grid or the number of
    rows).

    A bin of at most :data:`SHORT_SEGMENT` entries, empty bins too, is a
    short bin, of the class ``c`` with the least width ``SHORT_WIDTHS[c]``
    that holds its entries.  ``short_bins`` (int32, (n_short,)) lists the
    short bins' numbers class after class, each class in bin order,
    ``short_los`` (int32) and ``short_lens`` (uint8) their segments' starts
    and lengths in the same order, and ``short_counts`` the bins in each
    class.  ``pieces`` (int32) holds where in those lists each piece of :data:`SHORT_VALUES` ``* 256
    / w`` bins of a class starts, in the order of the pieces' first bins:
    the order in which the kernel's blocks take them.

    ``items`` (int32, (n, 4)) holds ``{bin, lo, hi, slot}`` for the longer
    bins, each cut into chunks ``[lo + c * C, min(lo + (c + 1) * C, hi))``
    of ``C =`` :data:`SEGMENT_CHUNK` in bin and chunk order (a block each).
    A chunk of a bin cut into more than one (a split bin) writes its partial
    sum to ``slot``, numbered over split bins and chunks in order; every
    other item has slot -1 and writes the bin's sum.  ``split`` (int32,
    (n_split, 4)) holds ``{bin, first slot, chunks, 0}`` for the second
    pass.  ``n_short`` and ``n_slots`` are the counts of short bins and of
    slots."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lo, hi = offsets[:-1], offsets[1:]
    lens = hi - lo
    # class of each bin; len(SHORT_WIDTHS) for the longer ones
    cls = np.searchsorted(np.asarray(SHORT_WIDTHS), lens)
    by_class = [np.flatnonzero(cls == c) for c in range(len(SHORT_WIDTHS))]
    short_bins = np.concatenate(by_class).astype(np.int32)
    first_of_class = np.cumsum([0] + [len(b) for b in by_class[:-1]])
    pieces = np.concatenate([
        start + np.arange(0, len(b), SHORT_VALUES * _BLOCK_THREADS // w)
        for start, b, w in zip(first_of_class, by_class, SHORT_WIDTHS)]).astype(np.int32)
    # bins next to each other share cotangent sectors: class after class, a
    # map too large for L2 would fetch them once for each class
    pieces = pieces[np.argsort(short_bins[pieces], kind="stable")]
    bins = np.flatnonzero(lens > SHORT_SEGMENT)
    chunks = -(-lens[bins] // SEGMENT_CHUNK)
    first = np.cumsum(chunks) - chunks  # each long bin's first chunk
    cbin = np.repeat(bins, chunks)
    c = np.arange(cbin.size) - np.repeat(first, chunks)
    clo = lo[cbin] + c * SEGMENT_CHUNK
    split = chunks > 1
    # slots count the chunks of split bins only
    in_split = np.repeat(split, chunks)
    slot = np.where(in_split, np.cumsum(in_split) - 1, -1)
    items = np.stack([cbin, clo, np.minimum(clo + SEGMENT_CHUNK, hi[cbin]), slot],
                     axis=1).astype(np.int32)
    nsplit = chunks[split]
    split_table = np.stack([bins[split], np.cumsum(nsplit) - nsplit, nsplit,
                            np.zeros_like(nsplit)], axis=1).astype(np.int32)
    return {"short_bins": short_bins, "short_counts": tuple(len(b) for b in by_class),
            "short_los": lo[short_bins].astype(np.int32),
            "short_lens": lens[short_bins].astype(np.uint8), "pieces": pieces,
            "items": items.reshape(-1, 4), "split": split_table.reshape(-1, 4),
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
    :func:`narrow_index_dtype` width for the gather kernel; ``seg_bins``,
    ``seg_los``, ``seg_lens``, ``seg_pieces``, ``seg_items`` and
    ``seg_split`` are the segment-sum kernel's work
    (:func:`segment_work_items`: the short bins by class with their
    segments' starts and lengths, the pieces of the classes, the block items
    and the split bins).  Those seven are derived from the map, so they stay
    out of ``state_dict``."""

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
        self.n_short = work["n_short"]
        self.short_counts = work["short_counts"]
        # as the C entries take them: one count for each class they have room for
        self._counts_c = self.short_counts + (0,) * (_MAX_WIDTHS - len(self.short_counts))
        self.n_block_items = len(work["items"])
        self.n_items = self.n_short + self.n_block_items
        self.n_split = len(work["split"])
        self.n_slots = work["n_slots"]
        self.n_pieces = len(work["pieces"])
        for name, key in (("seg_bins", "short_bins"), ("seg_los", "short_los"),
                          ("seg_lens", "short_lens"), ("seg_pieces", "pieces"),
                          ("seg_items", "items"), ("seg_split", "split")):
            self.register_buffer(name, torch.from_numpy(work[key]), persistent=False)

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
#: device index -> (the largest table row in bytes that a block stages in
#: shared memory, the bytes of L2)
_DEVICE_LIMITS: dict = {}


def _kernels():
    """The library's C entries, loaded (and built) at first use, after
    checking that it was built for the host's constants."""
    if _KERNELS:
        return _KERNELS
    lib = load_library("bin_gather")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    widths = (ci * _MAX_WIDTHS)()
    n_widths = lib.bin_segment_sum_widths(widths)
    built = (lib.bin_segment_sum_chunk(), lib.bin_segment_sum_short(),
             tuple(widths[:n_widths]), lib.bin_segment_sum_values())
    mine = (SEGMENT_CHUNK, SHORT_SEGMENT, SHORT_WIDTHS, SHORT_VALUES)
    if built != mine:
        raise RuntimeError(
            f"kernels built for {built} (block item, short bin, short widths, values a "
            f"lane); the host uses {mine}"
        )
    for dtype, sfx in _FLOAT_DTYPES.items():
        for itype, isfx in _INDEX_DTYPES.items():
            g = getattr(lib, f"bin_gather_{sfx}_{isfx}")
            g.argtypes = [vp, vp, vp, vp, ll, ci, ci, ci, vp]
            g.restype = ci
            _KERNELS[dtype, itype] = g
        s = getattr(lib, f"bin_segment_sum_{sfx}")
        s.argtypes = [*[vp] * 10, ll, *[ci] * (7 + _MAX_WIDTHS), vp]
        s.restype = ci
        _KERNELS["segment_sum", dtype] = s
    _KERNELS["device_limits"] = lib.bin_gather_device_limits
    return _KERNELS


def _device_limits(dev: int):
    """(The largest table row in bytes that the gather stages in shared
    memory, the bytes of L2) on device ``dev``; asked of the library once a
    device."""
    limits = _DEVICE_LIMITS.get(dev)
    if limits is None:
        out = (ctypes.c_int * 2)()
        rc = _kernels()["device_limits"](dev, out)
        if rc != 0:
            raise RuntimeError(f"device query failed with cudaError {rc}")
        limits = _DEVICE_LIMITS[dev] = tuple(out)
    return limits


def rows_innermost_columns(nb: int, nrows: int, itemsize: int, dev: int) -> int:
    """The columns of the rows-innermost copy (nb, columns) that the gather
    of an (nrows, nb) table goes through on device ``dev``: the rows rounded
    up to a 16-byte group; or 0 where it reads the table as it is (a table
    that a block stages, fewer than :data:`ROWS_INNERMOST_MIN` rows, or a
    copy above half of L2, which would not stay there beside the output)."""
    if nrows < ROWS_INNERMOST_MIN:
        return 0
    staged, l2 = _DEVICE_LIMITS.get(dev) or _device_limits(dev)
    if nb * itemsize <= staged:
        return 0
    group = 16 // itemsize
    columns = -(-nrows // group) * group
    return columns if nb * columns * itemsize <= l2 // 2 else 0


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
    """``out[b, j] = table[b, dist.idx[j]]`` for a (B, nb) table.

    ``bin_gather.launches`` counts calls that take the kernel route, one
    each; ``bin_gather.kernel_launches`` the kernels those calls launched,
    as the C entry reports them: one a call, two where a table too large to
    stage is first copied rows-innermost."""
    _check_values(table, dist, dist.nb, "table")
    if not table.is_cuda:
        if table.device.type == "cpu":
            return bin_gather_plain(table, dist.idx)
        raise RuntimeError(f"no bin_gather kernel for device {table.device}")
    idx = dist._buffers["idx_narrow"]
    fn = _kernels()[table.dtype, idx.dtype]
    nrows = table.shape[0]
    out = table.new_empty((nrows, dist.n))
    # The C launcher switches to the tensors' device only if it is not
    # current.  The stream is PyTorch's current one on that device, as a raw
    # handle (``torch.cuda.current_stream(dev).cuda_stream`` without
    # building a Stream object).
    dev = table.get_device()
    # the rows-innermost copy of a table too large to stage: (nb, B rounded
    # up to 16 bytes), scratch from the caching allocator (so the call can
    # be captured in a CUDA graph)
    columns = rows_innermost_columns(dist.nb, nrows, table.element_size(), dev)
    scratch = table.new_empty((dist.nb, columns)) if columns else None
    rc = fn(table.data_ptr(), idx.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), dist.n, dist.nb, nrows, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    _count(bin_gather, dist, nrows, rc, table.dtype)
    return out


def _count(wrapper, dist: BinIndex, nrows: int, kernels: int, dtype: torch.dtype):
    """One call of ``wrapper``'s kernel route on ``dtype`` values, which
    launched ``kernels``."""
    by_map = (dist.shape, dist.nb, nrows)
    wrapper.launches += 1
    wrapper.launches_by_dtype[_FLOAT_DTYPES[dtype]] += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_map[by_map] += 1
    wrapper.kernel_launches += kernels
    wrapper.kernel_launches_by_rows[nrows] += kernels
    wrapper.kernel_launches_by_map[by_map] += kernels


def _launch_segment_sum(cot, dist: BinIndex, bins, los, lens, counts, pieces):
    """The segment-sum kernels on a CUDA cotangent, with the short bins
    ``bins`` (segments from ``los``, of ``lens`` entries) in classes of
    ``counts``, cut into ``pieces``; returns the sums and the number of
    kernels launched."""
    fn = _kernels()["segment_sum", cot.dtype]
    nrows = cot.shape[0]
    out = cot.new_empty((nrows, dist.nb))
    # the split bins' chunk partials: scratch from the caching allocator
    # (so the call can be captured in a CUDA graph)
    partials = cot.new_empty((nrows, dist.n_slots)) if dist.n_split else None
    b = dist._buffers
    dev = cot.get_device()
    rc = fn(cot.data_ptr(), b["perm"].data_ptr(), bins.data_ptr(), los.data_ptr(),
            lens.data_ptr(), pieces.data_ptr(), b["seg_items"].data_ptr(),
            b["seg_split"].data_ptr(), None if partials is None else partials.data_ptr(),
            out.data_ptr(), dist.n, dist.nb, *counts, pieces.shape[0],
            dist.n_block_items, dist.n_split, dist.n_slots, nrows, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    return out, rc


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
    b = dist._buffers
    out, kernels = _launch_segment_sum(cot, dist, b["seg_bins"], b["seg_los"], b["seg_lens"],
                                       dist._counts_c, b["seg_pieces"])
    _count(bin_segment_sum, dist, cot.shape[0], kernels, cot.dtype)
    return out


def bin_segment_sum_whole_warps(cot, dist: BinIndex):
    """The segment sum of a CUDA cotangent with every short bin summed by a
    whole warp (all of them in the widest class), for checks only: the
    narrower classes' butterflies must give the same bits.  Not counted as
    a launch, and nothing in the port calls it."""
    _check_values(cot, dist, dist.n, "cotangent")
    if not cot.is_cuda:
        raise RuntimeError("the whole-warp order exists only in the CUDA kernel")
    lens = dist.offsets[1:] - dist.offsets[:-1]
    bins = torch.nonzero(lens <= SHORT_SEGMENT).ravel()
    counts = [0] * _MAX_WIDTHS
    counts[len(SHORT_WIDTHS) - 1] = dist.n_short
    pieces = torch.arange(0, dist.n_short, SHORT_VALUES * _BLOCK_THREADS // SHORT_SEGMENT,
                          dtype=torch.int32, device=cot.device)
    return _launch_segment_sum(cot, dist, bins.to(torch.int32), dist.offsets[bins].to(torch.int32),
                               lens[bins].to(torch.uint8), counts, pieces)[0]


def reset_launch_counts():
    for fn in (bin_gather, bin_segment_sum):
        fn.launches = fn.kernel_launches = 0
        fn.launches_by_rows, fn.kernel_launches_by_rows = Counter(), Counter()
        fn.launches_by_map, fn.kernel_launches_by_map = Counter(), Counter()
        fn.launches_by_dtype = Counter()


reset_launch_counts()


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


# -- the field-sharded distributor --------------------------------------------


def row_bin_index(rows, nb: int) -> BinIndex:
    """The (row, bin) map of a block of rows of an index map: entry ``j``
    of row ``i`` goes to bin ``idx[i, j] + i * nb`` of ``rows.shape[0] *
    nb``, so that one segment sum gives every row's per-bin partials (the
    ``_deterministic_scatter`` of the JAX package, one launch).  A
    segment's additions depend on its length alone, never on where it
    starts (:func:`segment_work_items`), so a rank's block of rows sums
    each (row, bin) as the whole map does."""
    rows = np.asarray(rows)
    n0 = rows.shape[0]
    flat = rows.reshape(n0, -1).astype(np.int64)
    shifted = flat + (np.arange(n0, dtype=np.int64) * nb)[:, None]
    return BinIndex(shifted.reshape(rows.shape), nb=n0 * nb)


class SlabGather(torch.autograd.Function):
    """A replicated (B, nb) table -> the rank's slab of its field,
    ``bin_gather`` on the slab's rows of the full-grid map; derivative:
    :class:`SlabSegmentSum`."""

    @staticmethod
    def forward(table, slab, rowbin, group, det):
        return bin_gather(table, slab)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad_out):
        return (SlabSegmentSum.apply(grad_out.contiguous(), *ctx.args),) + (None,) * 4

    @staticmethod
    def jvp(ctx, table_dot, *_):
        return SlabGather.apply(table_dot.contiguous(), *ctx.args)

    @staticmethod
    def vmap(info, in_dims, table, slab, rowbin, group, det):
        if in_dims[0] is None:
            return SlabGather.apply(table, slab, rowbin, group, det), None
        t = table.movedim(in_dims[0], 0)
        nv, nrows, nb = t.shape
        out = SlabGather.apply(t.reshape(nv * nrows, nb).contiguous(), slab, rowbin, group, det)
        return out.reshape(nv, nrows, -1), 0


class SlabSegmentSum(torch.autograd.Function):
    """The ranks' slab cotangents (B, n_slab) -> the replicated (B, nb)
    per-bin sums over the whole field; derivative: :class:`SlabGather`.

    Under ``deterministic_reductions`` (``det``): one segment sum over the
    (row, bin) map (:func:`row_bin_index`) gives each row's per-bin
    partials, the field group gathers them (B, rows, nb), and the rows are
    folded in halves, an order fixed by the global row count, so every
    world size gives the bits of one rank.  Otherwise the segment sum of
    the slab is all-reduced."""

    @staticmethod
    def forward(cot, slab, rowbin, group, det):
        from ..parallel import collectives as coll
        from ..tree import _fold_halving

        if not det:
            return coll.all_reduce(bin_segment_sum(cot, slab), group)
        part = bin_segment_sum(cot, rowbin)
        part = part.reshape(cot.shape[0], -1, slab.nb)
        return _fold_halving(coll.all_gather(part, group, dim=1))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad_out):
        return (SlabGather.apply(grad_out.contiguous(), *ctx.args),) + (None,) * 4

    @staticmethod
    def jvp(ctx, cot_dot, *_):
        return SlabSegmentSum.apply(cot_dot.contiguous(), *ctx.args)

    @staticmethod
    def vmap(info, in_dims, cot, slab, rowbin, group, det):
        if in_dims[0] is None:
            return SlabSegmentSum.apply(cot, slab, rowbin, group, det), None
        c = cot.movedim(in_dims[0], 0)
        nv, nrows, n = c.shape
        out = SlabSegmentSum.apply(c.reshape(nv * nrows, n).contiguous(), slab, rowbin, group,
                                   det)
        return out.reshape(nv, nrows, -1), 0


def distribute_power_slab(table, slab: BinIndex, rowbin: BinIndex, group, det: bool):
    """:func:`distribute_power` of a replicated (..., nb) table onto the
    rank's slab ``(..., *slab.shape)`` of a field-sharded field; the
    adjoint reduces over the field ``group`` (see :class:`SlabSegmentSum`)."""
    lead = tuple(table.shape[:-1])
    t2 = table.reshape(-1, table.shape[-1]).contiguous()
    return SlabGather.apply(t2, slab, rowbin, group, det).reshape(*lead, *slab.shape)
