"""The ray integral of line-of-sight tomography, K11, and its transpose.

A ray ``r`` of :class:`~nifty_tpu_torch.responses.los.SamplingCartesianGridLOS`
samples the field at ``P`` equidistant points, each interpolated from the
``2^d`` corners of its cell (order 1) or from one cell (order 0), and sums
them times ``s_r = |end_r - start_r| / P``:

    y[b, r] = s_r · Σ_{e < E} w[r, e] · f[b, idx[r, e]]
    g[b, n] = Σ_{(r, e) : idx[r, e] = n} w[r, e] · (s_r · ȳ[b, r])     (the adjoint)

with ``E = P · 2^d`` entries a ray in (point, corner) order.  The JAX package
computes this with XLA: ``map_coordinates`` vmapped over rays
(``nifty_tpu/responses/los.py:39``) and the scatter-add autodiff makes of it;
structured kernel interpolation (``ski.py:85-96``) is the same pair with
``P = 1``, ``s = 1`` and clipped indices (:func:`LosTable.from_interpolation`).

:func:`los_tables` builds the tables on the host in numpy with the JAX
package's expressions, in its order and types (``jax/_src/scipy/ndimage.py``:
``_linear_indices_and_weights``, ``_nearest_indices_and_weights``,
``_map_coordinates``), so that ``floor`` lands on the same cells and the
weights are the same numbers.  A corner outside the grid has index -1: it
contributes nothing to the linear map, and its ray's value is NaN
(``cval=nan``), even where the corner's weight is 0 (a point at world
coordinate ``distances · n``).  The wrappers add :attr:`LosTable.nan_offset`
for that; the jvp and vjp, as in JAX, see the linear map alone.

:class:`LosTable` holds the tables as buffers, with the adjoint's CSR over
the touched cells (a bit mask, the cells, offsets, rays and weights).  The
hand-written kernels (``csrc/los_interp.cu``) run them for a CUDA tensor;
:func:`los_integrate_plain` and :func:`los_integrate_adjoint_plain` are the
plain versions, which :func:`los_integrate` / :func:`los_integrate_adjoint`
take for a CPU tensor only; :func:`forward_row_tile` picks the rows a
forward block serves from the grid's fill.  Their ``launches`` count the calls that take
the kernel route, in total, by rows (``launches_by_rows``), by (table
key, rows) (``launches_by_shape``) and by the values' float type
(``launches_by_dtype``, "f32" / "f64").  :class:`LosIntegrate` and
:class:`LosIntegrateAdjoint` are the ``torch.autograd.Function`` pair, each
the other's derivative, with ``setup_context``, ``jvp`` and ``vmap``.

On a mesh whose field axis shards the grid along its first axis, a rank
holds rows ``[r0, r1)``: :class:`LosSlab` keeps the entries in them
(:func:`integrate_slab`, with :class:`LosSlabIntegrate` and
:class:`LosSlabAdjoint`).  The adjoint runs the slab's CSR by cell and needs
no collective.  The forward's partials cross the field group: under
``deterministic_reductions`` one for each (ray, row), the sum of a
*virtual ray* (a ray's entries in one row), folded over the global rows in
halves (so a world of p ranks gives the bits of one, the order of
``bin_gather``'s ``SlabSegmentSum``); otherwise one a ray, all-reduced.
The virtual rays are kept compact, sorted by the lanes their entry count
gives them, and one launch of ``los_slab_forward``
(:func:`slab_row_partials`, its own launch counts) sums them all and
writes the partials, zeros included, each with the bits ``los_forward``
gives its entries.
"""

from __future__ import annotations

import ctypes
import itertools
from collections import Counter

import numpy as np
import torch
from torch import nn

from .cuda_build import load_library

_FLOAT_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
#: the most rows a kernel block serves (``kRowTile`` in the source)
ROW_TILE = 4
#: threads a block (``kThreads``)
THREADS = 256
#: entries a thread of the forward loads before it adds them (``kBatch``)
BATCH = 8
#: the lanes a thread of the slab forward may play (its kernel's cases);
#: each divides ``BATCH``, so a thread's n-th entry is always lane n % K's
SLAB_LANES_PER_THREAD = (1, 2, 4, 8)
#: the most rows a call takes: gridDim.y (65535) row tiles of ``ROW_TILE``.
#: :func:`forward_row_tile` picks a narrower tile only while the grid is
#: smaller than the card, so far below this.
MAX_ROWS = 65535 * ROW_TILE


# -- host tables ----------------------------------------------------------


def los_coordinates(start, end, shape, distances, n_sampling_points, dtype=np.float64):
    """The index coordinates of every ray's sampling points, ``(R, d, P)``,
    by ``_ray_integral``'s expressions in its order: the grid shape in the
    field's ``dtype``, ``start``, ``end`` and ``distances`` in their own
    types (numpy promotes them as JAX does), ``start`` / ``end`` ``(R, d)``
    already broadcast."""
    shape_arr = np.asarray(shape, dtype=dtype)
    loc_per_world = ((shape_arr - 1) / shape_arr) / np.asarray(distances)
    s = start * loc_per_world
    e = end * loc_per_world
    step = (e - s) / n_sampling_points
    t = np.arange(n_sampling_points, dtype=dtype) + 0.5
    return s[:, :, None] + step[:, :, None] * t[None, None, :]


def _round_half_away_from_zero(c):
    whole = np.trunc(c)
    return whole + np.where(np.abs(c - whole) >= 0.5, np.sign(c), 0)


def los_tables(start, end, shape, distances, n_sampling_points, order=1,
               dtype=np.float64):
    """The ray tables of a line-of-sight response on the host:
    ``(idx, w, scale, nan_rays)`` with ``idx`` int32 ``(R, E)`` (-1 for a
    corner outside the grid), ``w`` ``(R, E)`` in ``dtype``, ``scale`` the
    ``|end - start| / P`` of each ray in ``dtype`` and ``nan_rays`` (bool,
    ``(R,)``) the rays with a corner outside the grid.  Corners run in
    ``itertools.product`` order (last axis fastest), a corner's weight is
    the product of its axes' weights from the first axis on."""
    start, end = np.atleast_2d(np.asarray(start)), np.atleast_2d(np.asarray(end))
    nrays = max(start.shape[0], end.shape[0])
    start = np.broadcast_to(start, (nrays, start.shape[1]))
    end = np.broadcast_to(end, (nrays, end.shape[1]))
    shape = tuple(int(n) for n in shape)
    coords = los_coordinates(start, end, shape, distances, n_sampling_points, dtype)
    if order == 0:
        axes = [[(_round_half_away_from_zero(coords[:, a]).astype(np.int64), None)]
                for a in range(len(shape))]
    elif order == 1:
        lower = np.floor(coords)
        upper_w = coords - lower
        axes = [[(lower[:, a].astype(np.int64), 1 - upper_w[:, a]),
                 (lower[:, a].astype(np.int64) + 1, upper_w[:, a])]
                for a in range(len(shape))]
    else:
        raise NotImplementedError("interpolation_order must be 0 or 1")
    strides = np.cumprod((1,) + shape[:0:-1])[::-1]
    cells, weights = [], []
    for corner in itertools.product(*axes):
        flat = np.zeros(coords.shape[::2], dtype=np.int64)
        valid = np.ones(coords.shape[::2], dtype=bool)
        wgt = None
        for (index, w), n, stride in zip(corner, shape, strides):
            valid &= (index >= 0) & (index < n)
            flat += index * stride
            if w is not None:
                wgt = w if wgt is None else wgt * w
        cells.append(np.where(valid, flat, -1))
        weights.append(np.ones(flat.shape, dtype=coords.dtype) if wgt is None else wgt)
    # (R, P, C) -> (R, P * C): entries in (point, corner) order
    idx = np.stack(cells, -1).reshape(nrays, -1).astype(np.int32)
    w = np.stack(weights, -1).reshape(nrays, -1).astype(dtype)
    length = np.sqrt(np.sum((end - start) ** 2, axis=1))
    scale = (length / n_sampling_points).astype(dtype)
    return idx, w, scale, np.any(idx < 0, axis=1)


def adjoint_csr(idx, w, ncells: int) -> dict:
    """The adjoint's tables: the valid entries sorted by cell, stable in
    (ray, entry) order (``seg_ray`` int32, ``seg_w``), the CSR offsets of
    each touched cell's segment (``seg_off`` int32, ``(U + 1,)``), the
    touched cells in that order (``cells`` int64), and the bit mask of the
    touched cells, one uint32 word for 32 cells (``mask``)."""
    idx = np.asarray(idx)
    nrays, nent = idx.shape
    flat = idx.ravel()
    valid = np.flatnonzero(flat >= 0)
    order = np.argsort(flat[valid], kind="stable")
    entries = valid[order]
    sorted_cells = flat[entries].astype(np.int64)
    cells, counts = np.unique(sorted_cells, return_counts=True)
    seg_off = np.zeros(cells.size + 1, dtype=np.int64)
    np.cumsum(counts, out=seg_off[1:])
    if seg_off[-1] >= 2**31:
        raise ValueError("tables of 2^31 valid entries or more are not supported")
    nwords = -(-int(ncells) // 32)
    mask = np.zeros(nwords, dtype=np.uint32)
    np.bitwise_or.at(mask, cells >> 5, (np.uint32(1) << (cells & 31).astype(np.uint32)))
    return {"seg_ray": (entries // nent).astype(np.int32),
            "seg_w": np.asarray(w).ravel()[entries], "seg_off": seg_off.astype(np.int32),
            "cells": cells, "mask": mask.view(np.int32)}


class LosTable(nn.Module):
    """The tables of one ray integral (or one interpolation) over a grid of
    ``shape``, as buffers (``.to(device)`` moves them; none is persistent:
    they follow from the geometry).

    ``idx`` (int32, ``(R, E)``, -1 outside the grid), ``w`` and ``scale``
    (the rays' ``s_r``) are the forward's; ``seg_off``, ``seg_ray``,
    ``seg_w`` and ``mask`` (:func:`adjoint_csr`) the adjoint's, with
    ``cells_narrow``, the touched cells in CSR order as int32 (the sum
    blocks' list); ``cells`` is the same list as int64 (for the plain
    adjoint); ``nan_offset`` is NaN for the rays with a corner outside the
    grid and 0 elsewhere (``has_nan`` says whether any is NaN).  ``key`` = ``(shape, R, E)``
    names the table in the launch counts."""

    def __init__(self, idx, w, scale, shape, nan_rays=None):
        super().__init__()
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        w = np.ascontiguousarray(w)
        self.shape = tuple(int(n) for n in shape)
        self.ncells = int(np.prod(self.shape))
        if self.ncells >= 2**31:
            raise ValueError("grids of 2^31 cells or more are not supported")
        self.nrays, self.nent = idx.shape
        self.key = (self.shape, self.nrays, self.nent)
        nan_rays = np.zeros(self.nrays, bool) if nan_rays is None else np.asarray(nan_rays)
        self.has_nan = bool(nan_rays.any())
        csr = adjoint_csr(idx, w, self.ncells)
        self.n_touched = int(csr["cells"].size)
        self.n_valid = int(csr["seg_off"][-1])
        for name, arr in (("idx", idx), ("w", w), ("scale", np.asarray(scale, w.dtype)),
                          ("nan_offset", np.where(nan_rays, np.nan, 0).astype(w.dtype)),
                          ("cells_narrow", csr["cells"].astype(np.int32)),
                          *((k, csr[k]) for k in ("seg_off", "seg_ray", "seg_w", "cells",
                                                  "mask"))):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    @classmethod
    def from_interpolation(cls, indices, weights, shape):
        """The table of a multilinear interpolation from ``(C, n_points)``
        index and weight tables (:func:`~nifty_tpu_torch.responses.ski.
        interpolation_matrix`): a ray a point, its ``C`` corners its
        entries, ``s = 1``."""
        idx = np.asarray(indices).T
        w = np.asarray(weights).T
        return cls(idx, w, np.ones(idx.shape[0], dtype=w.dtype), shape)

    @property
    def dtype(self):
        return self.w.dtype

    def extra_repr(self):
        return f"shape={self.shape}, rays={self.nrays}, entries={self.nent}"


# -- plain versions -------------------------------------------------------


def _forward_plain(f, idx, w, scale):
    valid = idx >= 0
    vals = f.index_select(1, idx.clamp_min(0).reshape(-1)).reshape(f.shape[0], *idx.shape)
    return torch.where(valid, w * vals, 0).sum(-1) * scale


def _adjoint_plain(ybar, table, seg_w, scale):
    nrows = ybar.shape[0]
    vals = seg_w * (ybar * scale).index_select(1, table.seg_ray.long())
    offs = table.seg_off.long().expand(nrows, -1).contiguous()
    sums = torch.segment_reduce(vals, "sum", offsets=offs, axis=1)
    out = ybar.new_zeros((nrows, table.ncells))
    out[:, table.cells] = sums
    return out


def los_integrate_plain(f, table: LosTable):
    """The forward for fields ``(B, N)`` -> ``(B, R)``: ``(w · f[:, idx]).sum(-1)
    · s``, the entries outside the grid taken as 0."""
    return _forward_plain(f, table.idx, table.w, table.scale)


def los_integrate_adjoint_plain(ybar, table: LosTable):
    """The adjoint for cotangents ``(B, R)`` -> ``(B, N)``: each entry's term
    ``w · (s · ȳ)``, summed over its cell's CSR segment by a sorted segment
    reduction, and the sums put in the touched cells."""
    return _adjoint_plain(ybar, table, table.seg_w, table.scale)


def sum_abs_terms(table: LosTable, f=None, ybar=None):
    """The per-output sum of |term| of the forward of ``f`` or of the
    adjoint of ``ybar``: the scale the kernels' error is held to."""
    if f is not None:
        return _forward_plain(f.abs(), table.idx, table.w.abs(), table.scale.abs())
    return _adjoint_plain(ybar.abs(), table, table.seg_w.abs(), table.scale.abs())


# -- kernel wrappers ------------------------------------------------------

_KERNELS: dict = {}


def _kernels():
    """The library's C entries, loaded (and built) at first use."""
    if _KERNELS:
        return _KERNELS
    lib = load_library("los_interp")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dtype, sfx in _FLOAT_DTYPES.items():
        fwd = getattr(lib, f"los_forward_{sfx}")
        fwd.argtypes = [vp] * 5 + [ci, ci, cll, ci, ci, ci, vp]
        fwd.restype = ci
        adj = getattr(lib, f"los_adjoint_{sfx}")
        adj.argtypes = [vp] * 8 + [cll, ci, ci, ci, ci, vp]
        adj.restype = ci
        slab = getattr(lib, f"los_slab_forward_{sfx}")
        slab.argtypes = [vp] * 9 + [cll, cll, ci, ci, ci, ci, vp]
        slab.restype = ci
        _KERNELS["forward", dtype], _KERNELS["adjoint", dtype] = fwd, adj
        _KERNELS["slab", dtype] = slab
    lib.los_interp_row_tile.restype = lib.los_interp_batch.restype = ci
    if lib.los_interp_row_tile() != ROW_TILE:
        raise RuntimeError(f"kernels built for {lib.los_interp_row_tile()} rows a block; the "
                           f"host uses {ROW_TILE}")
    if lib.los_interp_batch() != BATCH:
        raise RuntimeError(f"kernels built for batches of {lib.los_interp_batch()} entries; the "
                           f"host uses {BATCH}")
    lib.los_interp_lanes_per_ray.argtypes, lib.los_interp_lanes_per_ray.restype = [ci], ci
    for nent in (1, 3, 8, 16, 17, 256, 257, 2048, 4096):
        if lib.los_interp_lanes_per_ray(nent) != lanes_per_ray(nent):
            raise RuntimeError(f"kernels built for {lib.los_interp_lanes_per_ray(nent)} lanes a "
                               f"ray of {nent} entries; the host uses {lanes_per_ray(nent)}")
    return _KERNELS


def lanes_per_ray(nent: int) -> int:
    """The lanes of the forward's group a ray (``lanes_per_ray`` in the
    source): ``E`` rounded up to a power of two while ``E <= 16``, else 32
    a warp for ``E / 256`` warps rounded up to a power of two, at most 8."""
    if nent <= 16:
        return 1 << max(nent - 1, 0).bit_length()
    warps = 1
    while warps < THREADS // 32 and warps * THREADS < nent:
        warps *= 2
    return 32 * warps


def slab_lanes_per_thread(group: int, nent: int) -> int:
    """The lanes of a group of ``group`` that one thread of the slab kernel
    plays for a virtual ray of ``nent`` entries: as many as leave the thread
    at most ``BATCH`` entries (one batch of loads), up to ``BATCH`` for a
    group of a warp or less, else one.  The bits follow the lanes, not the
    threads that play them."""
    if group > 32:
        return 1
    lanes = min(group, BATCH)
    while lanes > 1 and -(-nent * lanes // group) > BATCH:
        lanes //= 2
    return lanes


def row_tile(blocks: int, nrows: int, n_sm: int) -> int:
    """The rows a forward block serves (1, 2 or ``ROW_TILE``) in a grid of
    ``blocks`` blocks a row tile: one while the grid leaves SMs idle, else
    the widest tile that still gives each of the ``n_sm`` SMs a block, and
    no wider than the rows.  A row's order of additions does not depend on
    the rows a block serves, so the tile moves no bits."""
    tile = ROW_TILE
    while tile > 1 and (blocks * -(-nrows // tile) < n_sm or tile // 2 >= nrows):
        tile //= 2
    return tile


def forward_row_tile(nrays: int, nent: int, nrows: int, n_sm: int) -> int:
    """:func:`row_tile` of the forward's grid of ray blocks."""
    return row_tile(-(-nrays // (THREADS // lanes_per_ray(nent))), nrows, n_sm)


_SM_COUNT: dict = {}


def _sm_count(dev: int) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def _check(x, table: LosTable, width: int, what: str):
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{what} must have shape (B, {width}); got {tuple(x.shape)}")
    if x.dtype != table.w.dtype:
        raise TypeError(f"{what} is {x.dtype} but the table is {table.w.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != table.idx.device:
        raise ValueError(f"{what} on {x.device} but the table on {table.idx.device}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows; got {x.shape[0]}")


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev)


def _count(wrapper, key, nrows: int, dtype):
    wrapper.launches += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_shape[key, nrows] += 1
    wrapper.launches_by_dtype[_FLOAT_DTYPES[dtype]] += 1


def los_integrate(f, table: LosTable):
    """The forward, fields ``(B, N)`` -> ``(B, R)``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.  Entries outside the grid
    contribute nothing (no NaN: see :attr:`LosTable.nan_offset`)."""
    _check(f, table, table.ncells, "field")
    if not f.is_cuda:
        if f.device.type == "cpu":
            return los_integrate_plain(f, table)
        raise RuntimeError(f"no los_interp kernel for device {f.device}")
    out = f.new_empty((f.shape[0], table.nrays))
    dev = f.get_device()
    tile = forward_row_tile(table.nrays, table.nent, f.shape[0], _sm_count(dev))
    rc = _kernels()["forward", f.dtype](
        f.data_ptr(), table.idx.data_ptr(), table.w.data_ptr(), table.scale.data_ptr(),
        out.data_ptr(), table.nrays, table.nent, table.ncells, f.shape[0], tile, dev,
        _stream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    _count(los_integrate, table.key, f.shape[0], f.dtype)
    return out


def los_integrate_adjoint(ybar, table: LosTable):
    """The adjoint, cotangents ``(B, R)`` -> ``(B, N)``: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    _check(ybar, table, table.nrays, "cotangent")
    if not ybar.is_cuda:
        if ybar.device.type == "cpu":
            return los_integrate_adjoint_plain(ybar, table)
        raise RuntimeError(f"no los_interp kernel for device {ybar.device}")
    out = ybar.new_empty((ybar.shape[0], table.ncells))
    dev = ybar.get_device()
    rc = _kernels()["adjoint", ybar.dtype](
        ybar.data_ptr(), table.mask.data_ptr(), table.cells_narrow.data_ptr(),
        table.seg_off.data_ptr(), table.seg_ray.data_ptr(), table.seg_w.data_ptr(),
        table.scale.data_ptr(), out.data_ptr(), table.ncells, table.nrays, table.n_touched,
        ybar.shape[0], dev, _stream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    _count(los_integrate_adjoint, table.key, ybar.shape[0], ybar.dtype)
    return out


def reset_launch_counts():
    for fn in (los_integrate, los_integrate_adjoint, slab_row_partials):
        fn.launches = 0
        fn.launches_by_rows, fn.launches_by_shape = Counter(), Counter()
        fn.launches_by_dtype = Counter()


# -- autograd pair --------------------------------------------------------


class LosIntegrate(torch.autograd.Function):
    """fields (B, N) -> ray values (B, R); derivative: the adjoint."""

    @staticmethod
    def forward(f, table):
        return los_integrate(f, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return LosIntegrateAdjoint.apply(grad_out.contiguous(), ctx.table), None

    @staticmethod
    def jvp(ctx, f_dot, _table_dot):
        return LosIntegrate.apply(f_dot.contiguous(), ctx.table)

    @staticmethod
    def vmap(info, in_dims, f, table):
        if in_dims[0] is None:
            return LosIntegrate.apply(f, table), None
        x = f.movedim(in_dims[0], 0)
        n, nrows = x.shape[0], x.shape[1]
        out = LosIntegrate.apply(x.reshape(n * nrows, -1).contiguous(), table)
        return out.reshape(n, nrows, -1), 0


class LosIntegrateAdjoint(torch.autograd.Function):
    """cotangents (B, R) -> fields (B, N); derivative: the forward."""

    @staticmethod
    def forward(ybar, table):
        return los_integrate_adjoint(ybar, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return LosIntegrate.apply(grad_out.contiguous(), ctx.table), None

    @staticmethod
    def jvp(ctx, ybar_dot, _table_dot):
        return LosIntegrateAdjoint.apply(ybar_dot.contiguous(), ctx.table)

    @staticmethod
    def vmap(info, in_dims, ybar, table):
        if in_dims[0] is None:
            return LosIntegrateAdjoint.apply(ybar, table), None
        x = ybar.movedim(in_dims[0], 0)
        n, nrows = x.shape[0], x.shape[1]
        out = LosIntegrateAdjoint.apply(x.reshape(n * nrows, -1).contiguous(), table)
        return out.reshape(n, nrows, -1), 0


def _check_trailing(got, want, what: str, of: str):
    """Raise unless ``got`` ends in ``want``: a field-sharded field (a rank's
    slab, or two samples' half slabs) has as many entries as a whole one of
    other rows, and a reshape would take it for one."""
    if len(got) < len(want) or tuple(got[len(got) - len(want):]) != tuple(want):
        raise ValueError(
            f"{what} of shape {tuple(got)} does not end in the {of} {tuple(want)}; a "
            "field-sharded field takes a model placed on the mesh (`shard_position`)")


def integrate(x, table: LosTable):
    """The ray values of fields ``(..., *table.shape)`` -> ``(..., R)``, NaN
    on the rays with a corner outside the grid."""
    _check_trailing(x.shape, table.shape, "a field", "table's grid")
    lead = tuple(x.shape[: x.ndim - len(table.shape)])
    y = LosIntegrate.apply(x.reshape(-1, table.ncells).contiguous(), table)
    if table.has_nan:
        y = y + table.nan_offset
    return y.reshape(*lead, table.nrays)


def integrate_adjoint(ybar, table: LosTable):
    """The adjoint of :func:`integrate`'s linear map: ``(..., R)`` ->
    ``(..., *table.shape)``."""
    _check_trailing(ybar.shape, (table.nrays,), "a cotangent", "table's rays")
    lead = tuple(ybar.shape[:-1])
    g = LosIntegrateAdjoint.apply(ybar.reshape(-1, table.nrays).contiguous(), table)
    return g.reshape(*lead, *table.shape)


# -- a rank's slab of a field-sharded grid ----------------------------------


def _lanes_of_counts(counts):
    """:func:`lanes_per_ray` and :func:`slab_lanes_per_thread` of each entry
    count in ``counts``."""
    uniq, inv = np.unique(counts, return_inverse=True)
    groups = [lanes_per_ray(int(c)) for c in uniq]
    per_thread = [slab_lanes_per_thread(g, int(c)) for g, c in zip(groups, uniq)]
    return np.array(groups, dtype=np.int64)[inv], np.array(per_thread, dtype=np.int64)[inv]


class LosSlab(nn.Module):
    """The ray integral over rows ``[r0, r1)`` of the first axis of a grid
    (a rank's slab of a field sharded over a mesh's field axis), from the
    global tables of :func:`los_tables`.

    - ``table``: the rays' entries whose cell lies in the slab, rebased to
      it, every other entry -1 (a :class:`LosTable` over the slab's shape).
      Its forward is a ray's partial over the slab; its adjoint's CSR keeps
      the global (ray, entry) order inside each cell, so a cell's sum has
      the same bits whatever the slab.
    - the slab's *virtual rays*, one for each (ray, row) pair that holds an
      entry: the ray's valid entries in that row, in entry order, kept
      compact (``v_off``, int32 CSR offsets, ``(V + 1,)``; ``v_idx``, int32
      cells of the slab; ``v_w``), with the ray's ``s_r`` (``v_scale``) and
      the pair's place ``(row - r0) · R + ray`` in the partials
      (``v_dest``, int32).  They are sorted by the lanes
      :func:`lanes_per_ray` gives their entry count, then by the lanes
      :func:`slab_lanes_per_thread` gives a thread (the most first), then
      by ``ray · n0 + row``; ``v_blocks`` (int32, ``(blocks, 4)``) holds
      each kernel block's (first, end, lanes, lanes a thread), the virtual
      rays of one such class that ``THREADS`` threads serve; ``empty`` is
      the bit mask (a uint32 word for 32
      pairs, as int32) of the pairs that hold no virtual ray.  A virtual
      ray's sum depends on its entries alone, so each (ray, row) partial
      has the same bits in every slab that holds the row.

    ``nan_offset`` / ``has_nan`` are the global rays' (added once, after
    the reduction over the slabs); ``key`` = ``(grid shape, rows, R)`` names
    the slab in the launch counts."""

    def __init__(self, idx, w, scale, shape, rows, nan_rays=None):
        super().__init__()
        idx = np.asarray(idx)
        w = np.asarray(w)
        shape = tuple(int(n) for n in shape)
        r0, r1 = (int(r) for r in rows)
        if not 0 <= r0 < r1 <= shape[0]:
            raise ValueError(f"rows [{r0}, {r1}) are not a slab of the first axis of {shape}")
        row_cells = int(np.prod(shape[1:], dtype=np.int64))
        n0 = shape[0]
        self.rows, self.shape = (r0, r1), (r1 - r0,) + shape[1:]
        self.nrays = idx.shape[0]
        self.key = (shape, self.rows, self.nrays)
        self.nout = (r1 - r0) * self.nrays
        lo, hi = r0 * row_cells, r1 * row_cells
        inside = (idx >= lo) & (idx < hi)
        self.table = LosTable(np.where(inside, idx - lo, -1), w, scale, self.shape)
        self.ncells = self.table.ncells
        nan_rays = np.zeros(self.nrays, bool) if nan_rays is None else np.asarray(nan_rays)
        self.has_nan = bool(nan_rays.any())
        # virtual rays: the slab's valid entries by (ray, row), in entry order
        ray, ent = np.nonzero(inside)
        cell = idx[ray, ent].astype(np.int64)
        vid = ray.astype(np.int64) * n0 + cell // row_cells
        order = np.argsort(vid, kind="stable")
        ray, ent, cell = ray[order], ent[order], cell[order]
        vray, first, count = np.unique(vid[order], return_index=True, return_counts=True)
        lanes, per_thread = _lanes_of_counts(count)
        bad = [k for k in np.unique(per_thread).tolist()
               if k not in SLAB_LANES_PER_THREAD or BATCH % k]
        if bad:
            raise ValueError(f"lanes a thread {bad}: the slab kernel plays "
                             f"{SLAB_LANES_PER_THREAD}, each a divisor of BATCH = {BATCH}")
        # classes of (lanes, lanes a thread), by lanes, the most a thread first
        cls = lanes * (BATCH + 1) - per_thread
        by_class = np.argsort(cls, kind="stable")
        vray, first, count, cls = vray[by_class], first[by_class], count[by_class], cls[by_class]
        lanes, per_thread = lanes[by_class], per_thread[by_class]
        off = np.zeros(vray.size + 1, dtype=np.int64)
        np.cumsum(count, out=off[1:])
        at = np.repeat(first - off[:-1], count) + np.arange(int(off[-1]))
        v_ray, v_row = vray // n0, vray % n0
        blocks = []
        for c in np.unique(cls):
            sel = np.flatnonzero(cls == c)
            g, k = int(lanes[sel[0]]), int(per_thread[sel[0]])
            per = THREADS * k // g
            starts = np.arange(sel[0], sel[-1] + 1, per)
            blocks.append(np.stack([starts, np.minimum(starts + per, sel[-1] + 1),
                                    np.full(starts.size, g), np.full(starts.size, k)], 1))
        dest = (v_row - r0) * self.nrays + v_ray
        held = np.zeros(-(-self.nout // 32) * 32, dtype=bool)
        held[dest] = True
        held[self.nout:] = True
        empty = np.packbits(~held, bitorder="little").view(np.uint32)
        self.n_virtual = int(vray.size)
        self.groups = {int(g): int(n) for g, n in zip(*np.unique(lanes, return_counts=True))}
        for name, arr in (
                ("v_off", off.astype(np.int32)), ("v_idx", (cell[at] - lo).astype(np.int32)),
                ("v_w", w[ray[at], ent[at]]), ("v_scale", np.asarray(scale, w.dtype)[v_ray]),
                ("v_dest", dest.astype(np.int32)),
                ("v_blocks", np.concatenate(blocks or [np.zeros((0, 4), np.int64)])
                 .astype(np.int32)),
                ("empty", empty.view(np.int32)),
                ("nan_offset", np.where(nan_rays, np.nan, 0).astype(w.dtype))):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    @property
    def n_blocks(self) -> int:
        """The kernel's virtual-ray blocks a row tile."""
        return self.v_blocks.shape[0]

    @property
    def table_bytes(self) -> int:
        """The bytes of the slab forward's tables: the virtual rays'
        offsets, cells, weights, scales and places, the block descriptors
        and the zero-fill mask."""
        return sum(getattr(self, n).numel() * getattr(self, n).element_size()
                   for n in ("v_off", "v_idx", "v_w", "v_scale", "v_dest", "v_blocks", "empty"))

    def partials_csr(self):
        """The linear map of :func:`slab_row_partials` as a sparse CSR
        matrix ``(rows · R, slab cells)``: a row a (row, ray) pair in the
        partials' order, holding its virtual ray's weights times ``s_r``."""
        counts = (self.v_off[1:] - self.v_off[:-1]).long()
        rows = torch.repeat_interleave(self.v_dest.long(), counts)
        vals = self.v_w * torch.repeat_interleave(self.v_scale, counts)
        return torch.sparse_coo_tensor(torch.stack([rows, self.v_idx.long()]), vals,
                                       (self.nout, self.ncells)).coalesce().to_sparse_csr()

    def extra_repr(self):
        return (f"rows={self.rows}, rays={self.nrays}, virtual rays={self.n_virtual} by lanes "
                f"{self.groups}")


def _slab_plain(f, slab: LosSlab, w, scale):
    nrows = f.shape[0]
    out = f.new_zeros((nrows, slab.nout))
    if slab.n_virtual:
        terms = w * f.index_select(1, slab.v_idx)
        offs = slab.v_off.long().expand(nrows, -1).contiguous()
        sums = torch.segment_reduce(terms, "sum", offsets=offs, axis=1)
        out[:, slab.v_dest.long()] = sums * scale
    return out.reshape(nrows, -1, slab.nrays)


def slab_row_partials_plain(f, slab: LosSlab):
    """The plain version of :func:`slab_row_partials`: each virtual ray's
    terms ``w · f[:, idx]``, a segment sum by virtual ray, times ``s_r``,
    put at the pairs' places in zeros."""
    return _slab_plain(f, slab, slab.v_w, slab.v_scale)


def slab_sum_abs_terms(slab: LosSlab, f):
    """The per-partial sum of |term| of :func:`slab_row_partials` of ``f``:
    the scale the kernel's error is held to."""
    return _slab_plain(f.abs(), slab, slab.v_w.abs(), slab.v_scale.abs())


def slab_row_partials(f, slab: LosSlab):
    """The (ray, row) partials of fields ``(B, slab cells)``: ``(B, rows,
    R)``, ``s_r`` times the sum of ray ``r``'s entries in each row of the
    slab (+0 where it has none).  One launch of ``los_slab_forward`` for a
    CUDA tensor, the plain version for a CPU tensor."""
    _check(f, slab.table, slab.ncells, "field")
    nrows = f.shape[0]
    if not f.is_cuda:
        if f.device.type == "cpu":
            return slab_row_partials_plain(f, slab)
        raise RuntimeError(f"no los_interp kernel for device {f.device}")
    out = f.new_empty((nrows, slab.nout))
    dev = f.get_device()
    rc = _kernels()["slab", f.dtype](
        f.data_ptr(), slab.v_off.data_ptr(), slab.v_idx.data_ptr(), slab.v_w.data_ptr(),
        slab.v_scale.data_ptr(), slab.v_dest.data_ptr(), slab.v_blocks.data_ptr(),
        slab.empty.data_ptr(), out.data_ptr(), slab.ncells, slab.nout, nrows, slab.n_blocks,
        row_tile(slab.n_blocks, nrows, _sm_count(dev)), dev, _stream(dev))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    if rc:
        _count(slab_row_partials, slab.key, nrows, f.dtype)
    return out.reshape(nrows, -1, slab.nrays)


def slab_forward_plain(f, slab: LosSlab, det: bool):
    """The plain version of a slab's share of the forward, before the
    reduction over the field group: the (ray, row) partials ``(B, rows,
    R)`` under ``deterministic_reductions``, else the rays' partials over
    the slab ``(B, R)``."""
    if det:
        return slab_row_partials_plain(f, slab)
    return los_integrate_plain(f, slab.table)


def slab_adjoint_plain(ybar, slab: LosSlab):
    """The plain version of the slab adjoint: replicated cotangents ``(B,
    R)`` -> the slab's ``(B, slab cells)``."""
    return los_integrate_adjoint_plain(ybar, slab.table)


def slab_integrate(f, slab: LosSlab, group, det: bool):
    """The forward of the rank's slab ``(B, slab cells)`` -> the rays'
    integrals over the whole grid ``(B, R)``, the same on every rank of the
    field ``group`` (no NaN offset).  Under ``deterministic_reductions``
    (``det``) the (ray, row) partials are gathered over the group and
    folded over the global rows in halves, an order fixed by the grid, so
    every world gives the bits of one rank; else the rays' partials over
    the slab are all-reduced.  Only ``(B, rows, R)`` or ``(B, R)`` values
    cross ranks."""
    from ..parallel import collectives as coll
    from ..tree import _fold_halving

    if det:
        return _fold_halving(coll.all_gather(slab_row_partials(f, slab), group, dim=1))
    return coll.all_reduce(los_integrate(f, slab.table), group)


class LosSlabIntegrate(torch.autograd.Function):
    """A rank's slab (B, slab cells) -> the replicated ray values (B, R)
    (:func:`slab_integrate`); derivative: :class:`LosSlabAdjoint`, which
    needs no collective (the replicated cotangent is whole on every rank)."""

    @staticmethod
    def forward(f, slab, group, det):
        return slab_integrate(f, slab, group, det)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad_out):
        return (LosSlabAdjoint.apply(grad_out.contiguous(), *ctx.args),) + (None,) * 3

    @staticmethod
    def jvp(ctx, f_dot, *_):
        return LosSlabIntegrate.apply(f_dot.contiguous(), *ctx.args)

    @staticmethod
    def vmap(info, in_dims, f, slab, group, det):
        if in_dims[0] is None:
            return LosSlabIntegrate.apply(f, slab, group, det), None
        x = f.movedim(in_dims[0], 0)
        n, nrows = x.shape[0], x.shape[1]
        out = LosSlabIntegrate.apply(x.reshape(n * nrows, -1).contiguous(), slab, group, det)
        return out.reshape(n, nrows, -1), 0


class LosSlabAdjoint(torch.autograd.Function):
    """Replicated cotangents (B, R) -> the rank's slab (B, slab cells), the
    adjoint over the slab's CSR by cell; derivative: :class:`LosSlabIntegrate`
    (the ranks' partials summed)."""

    @staticmethod
    def forward(ybar, slab, group, det):
        return los_integrate_adjoint(ybar, slab.table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad_out):
        return (LosSlabIntegrate.apply(grad_out.contiguous(), *ctx.args),) + (None,) * 3

    @staticmethod
    def jvp(ctx, ybar_dot, *_):
        return LosSlabAdjoint.apply(ybar_dot.contiguous(), *ctx.args)

    @staticmethod
    def vmap(info, in_dims, ybar, slab, group, det):
        if in_dims[0] is None:
            return LosSlabAdjoint.apply(ybar, slab, group, det), None
        x = ybar.movedim(in_dims[0], 0)
        n, nrows = x.shape[0], x.shape[1]
        out = LosSlabAdjoint.apply(x.reshape(n * nrows, -1).contiguous(), slab, group, det)
        return out.reshape(n, nrows, -1), 0


def integrate_slab(x, slab: LosSlab, group, det: bool):
    """:func:`integrate` of a field sharded over ``group``: this rank's
    slabs ``(..., *slab.shape)`` -> the replicated ray values ``(..., R)``,
    NaN on the rays with a corner outside the grid."""
    _check_trailing(x.shape, slab.shape, "a field", "slab")
    lead = tuple(x.shape[: x.ndim - len(slab.shape)])
    y = LosSlabIntegrate.apply(x.reshape(-1, slab.ncells).contiguous(), slab, group, det)
    if slab.has_nan:
        y = y + slab.nan_offset
    return y.reshape(*lead, slab.nrays)


reset_launch_counts()
