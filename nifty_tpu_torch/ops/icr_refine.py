"""One refinement step of iterative charted refinement (ICR), K9, and its
transpose.

An ICR field is built level by level: each refinement site reads a window
of ``W`` coarse values and writes ``F`` children,

    fine[b, i(s, f)] = sum_w olf[m(s), f, w] coarse[b, c(s, w)]
                     + sum_e ker[m(s), f, e] xi[b, s, e],

with the site's optimal linear filter ``olf`` and the square root ``ker``
of its conditional covariance.  The JAX package leaves this step to XLA
(``nifty_tpu/refine/charted_field.py:283-303``,
``nifty_tpu/refine/healpix_field.py:190-222``: a window stack or gather,
two per-site einsums, the interleave of the children); here it is a
hand-written CUDA kernel pair (``csrc/icr_refine.cu``), since the field is
linear in its excitations and the metric matvec of a geoVI update is
these steps, forwards and transposed, at every level.

:class:`RefineLevel` holds one step's geometry and matrices as buffers.
Every chart the port has is separable: along each axis ``a`` of the coarse
grid, site ``s_a`` reads the coarse indices ``windows[a][s_a]`` and places
``children[a]`` children at fine positions ``s_a * children[a] + f_a``
(slots and children row-major over the axes; the fine grid row-major over
the extents ``sites[a] * children[a]``).  The window tables are per axis
(a charted level's clamped or periodic window starts, a HEALPix level's
nested neighbours, ``q .. q + 2`` along a radial axis), so no table the
size of the field is built.  The matrices vary along the axes where the
chart makes them differ and are broadcast along the rest (stride 0).

:func:`icr_refine` and :func:`icr_refine_transpose` run the kernels for a
CUDA tensor and their plain versions (:func:`icr_refine_plain`, the window
gather / einsum / interleave route, and its autograd pull-back) for a CPU
tensor only.  The transpose pulls each site's children back onto its
window slots and excitations, then sums each coarse entry's slots over a
CSR inverse of each axis's window table, built here, in a fixed order and
with no atomics.  Each level takes a route for each direction, chosen
here from its tables alone (:func:`choose_routes`,
:attr:`RefineLevel.routes`): for the compiled shapes
(:data:`COMPILED_SHAPES`) the step a thread a site (matrices shared along
the last axis) or a lane group a site, else a thread a fine entry; the
transpose in one pass over boxes of coarse entries (:func:`box_schedule`)
where every box's halo of reading sites is compact, else in two passes
through scratch.  ``icr_refine.launches`` and
``icr_refine_transpose.launches`` count the calls that take the kernel
route (never plain runs), in total, by rows (``launches_by_rows``) and by
level and rows (``launches_by_level``, keyed by :attr:`RefineLevel.key`)
and by the values' float type (``launches_by_dtype``, "f32" / "f64").

:class:`IcrRefine` and :class:`IcrRefineTranspose` are the
``torch.autograd.Function`` pair: each one's derivative is the other, with
``setup_context``, ``jvp`` and ``vmap``, so that ``torch.func.jvp``,
``vjp``, ``linearize`` and ``vmap`` and autograd's double backward reach
both kernels.  :func:`refine_level` takes leading batch axes.
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
#: Axes a level may have on the card (``kMaxAxes`` in ``csrc/icr_refine.cu``;
#: :func:`_kernels` checks that they agree).
MAX_AXES = 16
#: The (slots, children) an axis of the levels with compiled kernels
#: (``Line3``, ``Nest9``, ``Plane``, ``Shell`` in ``csrc/icr_refine.cu``;
#: :func:`_kernels` checks that they agree): a 1-D chart, a HEALPix level,
#: a 2-D chart, sphere x radius.
COMPILED_SHAPES = (((3, 2),), ((9, 4),), ((3, 2), (3, 2)), ((9, 4), (3, 2)))
#: Threads a block (``kThreads``): the lane-group routes' tiles hold
#: ``THREADS // F`` sites.
THREADS = 256
#: Coarse entries a box of the one-pass transpose along each axis, by axis
#: count; the last box of an axis is ragged.
BOX = {1: (1024,), 2: (8, 32)}
#: The one-pass transpose is taken where its boxes' halos hold at most this
#: many sites for every site of the level (the rest are computed twice) ...
BOX_MAX_WORK = 1.5
#: ... and a box's slot cotangents fit in this much shared memory (float64),
#: and there are enough boxes to fill an H100 (two an SM), or the level's
#: sites are no more than a block's threads.
BOX_MAX_SMEM = 96 * 1024
BOX_MIN_BOXES = 2 * 132
_ROUTE_CODES = {"entry": 0, "group": 1, "box": 2, "thread": 3}
_INDEX_LIMIT = 2**31


def window_inverse(table, extent: int):
    """The CSR inverse of one axis's window table ``(sites, slots)`` over a
    coarse extent: ``offsets`` (extent + 1) and ``positions``, the flat
    positions ``s * slots + w`` that read each coarse index, in increasing
    order (a stable sort), repeats included."""
    flat = np.asarray(table, dtype=np.int64).ravel()
    positions = np.argsort(flat, kind="stable").astype(np.int32)
    offsets = np.zeros(extent + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=extent), out=offsets[1:])
    if offsets[-1] >= 2**31:
        raise ValueError("window tables of 2^31 entries or more are not supported")
    return offsets.astype(np.int32), positions


def box_schedule(tables, coarse_shape, box):
    """The one-pass transpose's boxes along each axis: for window tables
    ``(sites[a], slots[a])`` over ``coarse_shape`` and boxes of ``box[a]``
    coarse entries (the last one ragged), per axis the halo ``(boxes, 2)``
    (int32: the sites ``[lo, hi)`` whose windows meet box ``k``; ``[0, 0)``
    where none does) and the owner ``(sites,)`` (int32: the box that holds
    the site's first window entry, which writes its excitations'
    cotangents).  A box of the grid is a product of one box an axis, so
    every (site, slot) pair that reads one of its coarse entries lies in
    its halo."""
    halos, owners = [], []
    for tab, n, size in zip(tables, coarse_shape, box):
        tab = np.asarray(tab, dtype=np.int64)
        nbox = -(-int(n) // int(size))
        tile = (tab // size).ravel()
        site = np.repeat(np.arange(tab.shape[0]), tab.shape[1])
        lo = np.full(nbox, tab.shape[0], dtype=np.int64)
        hi = np.zeros(nbox, dtype=np.int64)
        np.minimum.at(lo, tile, site)
        np.maximum.at(hi, tile, site + 1)
        lo = np.minimum(lo, hi)
        halos.append(np.stack([lo, hi], axis=1).astype(np.int32))
        owners.append((tab[:, 0] // size).astype(np.int32))
    return halos, owners


def _box_smem_values(level, halo_max):
    """float64 values of a box's shared memory (``box_smem_bytes`` in
    ``csrc/icr_refine.cu``): its slot cotangents, and the matrix pairs of
    its halo's rows where they vary by row alone."""
    up = lambda n: -(-n // 2) * 2  # noqa: E731
    values = up(level.W * int(np.prod(halo_max)))
    if level.ndim == 1 or level.mstrides[-1] == 0:
        nm = level.mstrides[0] * (halo_max[0] - 1) + 1
        values += up(nm * level.F * level.W + 2) + nm * level.F * level.F + 2
    return values


def choose_routes(level):
    """The routes of ``level`` (a :class:`RefineLevel` being built), from
    its tables alone: ``(step, transpose, schedule)``.  Compiled shapes
    (:data:`COMPILED_SHAPES`) whose rows fit 32-bit indices take a compiled
    route.  The step takes ``"thread"`` (a thread a site) on a 2-D level
    with pairs of children along its last axis and matrices shared along
    it, ``"group"`` (a lane group a site, the tile's matrices in one
    contiguous range: the axes along which they vary come first) on the
    other compiled levels, and ``"entry"`` (a thread a fine entry)
    elsewhere.  The transpose takes ``"box"`` (one pass,
    :func:`box_schedule` with boxes of :data:`BOX`) where the halos are
    compact (:data:`BOX_MAX_WORK`, :data:`BOX_MAX_SMEM`) and the boxes fill
    the card (:data:`BOX_MIN_BOXES`) or one block takes every site, else
    ``"group"`` or ``"entry"`` (two passes); ``schedule`` is the box
    schedule on the box route, else None."""
    shape = tuple(zip(level.slots, level.child_shape))
    mats = sum(m * (s - 1) for m, s in zip(level.mstrides, level.sites)) + 1
    narrow = (level.n_fine < _INDEX_LIMIT and level.n_coarse < _INDEX_LIMIT
              and level.S * (level.W + level.F) < _INDEX_LIMIT
              and mats * level.F * (level.W + level.F) < _INDEX_LIMIT)
    compiled = shape in COMPILED_SHAPES and narrow
    varying = [m != 0 for m in level.mstrides]
    prefix = varying == sorted(varying, reverse=True)
    group = compiled and prefix
    if compiled and level.ndim == 2 and level.child_shape[1] == 2 and not varying[1]:
        step = "thread"
    else:
        step = "group" if group else "entry"
    if not compiled:
        return step, "entry", None
    box = BOX[level.ndim]
    tables = [level._buffers[f"window{a}"].cpu().numpy() for a in range(level.ndim)]
    halos, owners = box_schedule(tables, level.coarse_shape, box)
    extents = [h[:, 1] - h[:, 0] for h in halos]
    work = np.prod([float(e.sum()) for e in extents])
    smem = 8 * _box_smem_values(level, [int(e.max()) for e in extents])
    enough = int(np.prod([len(h) for h in halos])) >= BOX_MIN_BOXES
    if (work <= BOX_MAX_WORK * level.S and smem <= BOX_MAX_SMEM
            and (enough or level.S <= THREADS)):
        return step, "box", (box, halos, owners)
    return step, "group" if group else "entry", None


class RefineLevel(nn.Module):
    """One refinement step: per-axis window tables, their CSR inverses and
    the stacked matrices, as non-persistent buffers (``.to()`` moves them;
    all of them follow from the chart and the kernel, so they stay out of
    ``state_dict``).

    ``coarse_shape``: the coarse grid's extents; ``windows``: one integer
    table ``(sites[a], slots[a])`` an axis, entries in ``[0,
    coarse_shape[a])``; ``children``: children an axis; ``olf`` and ``ker``:
    ``matrix_grid + (F, W)`` and ``matrix_grid + (F, F)``, where
    ``matrix_grid[a]`` is ``sites[a]`` along an axis where the matrices vary
    and 1 where they are shared.  The buffers ``olf`` and ``ker`` hold them
    stacked, ``(M, F, W)`` and ``(M, F, F)``.
    """

    def __init__(self, coarse_shape, windows, children, olf, ker, matrix_grid):
        super().__init__()
        self.coarse_shape = tuple(int(n) for n in coarse_shape)
        self.ndim = len(self.coarse_shape)
        windows = [np.asarray(w, dtype=np.int64) for w in windows]
        self.child_shape = tuple(int(c) for c in children)
        self.matrix_grid = tuple(int(g) for g in matrix_grid)
        if not (len(windows) == len(self.child_shape) == len(self.matrix_grid) == self.ndim):
            raise ValueError("one window table, child count and matrix extent an axis")
        self.sites = tuple(w.shape[0] for w in windows)
        self.slots = tuple(w.shape[1] for w in windows)
        for a, (w, n, g) in enumerate(zip(windows, self.coarse_shape, self.matrix_grid)):
            if w.size and (w.min() < 0 or w.max() >= n):
                raise ValueError(f"axis {a}: window entries must lie in [0, {n})")
            if g not in (1, w.shape[0]):
                raise ValueError(f"axis {a}: matrix extent {g} is neither 1 nor the sites")
        self.W = int(np.prod(self.slots))
        self.F = int(np.prod(self.child_shape))
        self.S = int(np.prod(self.sites))
        self.n_coarse = int(np.prod(self.coarse_shape))
        self.fine_shape = tuple(s * c for s, c in zip(self.sites, self.child_shape))
        self.n_fine = int(np.prod(self.fine_shape))
        self.n_matrices = int(np.prod(self.matrix_grid))
        mshape = (self.n_matrices, self.F)
        if tuple(olf.shape[-2:]) != (self.F, self.W) or tuple(ker.shape[-2:]) != (self.F, self.F):
            raise ValueError(f"matrices of shape {tuple(olf.shape)}, {tuple(ker.shape)} for "
                             f"F = {self.F}, W = {self.W}")
        self.register_buffer("olf", olf.reshape(*mshape, self.W).contiguous(), persistent=False)
        self.register_buffer("ker", ker.reshape(*mshape, self.F).contiguous(), persistent=False)
        strides = np.cumprod((1,) + self.matrix_grid[:0:-1])[::-1]
        self.mstrides = tuple(int(s) if g > 1 else 0
                              for s, g in zip(strides, self.matrix_grid))
        for a, (w, n) in enumerate(zip(windows, self.coarse_shape)):
            offsets, positions = window_inverse(w, n)
            self.register_buffer(f"window{a}", torch.from_numpy(w.astype(np.int32)),
                                 persistent=False)
            self.register_buffer(f"inverse_offsets{a}", torch.from_numpy(offsets),
                                 persistent=False)
            self.register_buffer(f"inverse{a}", torch.from_numpy(positions), persistent=False)
        self.step_route, self.transpose_route, schedule = choose_routes(self)
        box, nbox, halo_max = (0,) * self.ndim, (0,) * self.ndim, (0,) * self.ndim
        if schedule is not None:
            box, halos, owners = schedule
            nbox = tuple(len(h) for h in halos)
            halo_max = tuple(int((h[:, 1] - h[:, 0]).max()) for h in halos)
            for a, (h, o) in enumerate(zip(halos, owners)):
                self.register_buffer(f"box_halo{a}", torch.from_numpy(h), persistent=False)
                self.register_buffer(f"box_owner{a}", torch.from_numpy(o), persistent=False)
        self.box, self.box_counts, self.halo_max = tuple(box), nbox, halo_max
        # the C entries' geometry: ndim, then sites, slots, children, coarse
        # extents and matrix strides, one an axis, the two routes, then the
        # box extents, boxes and largest halo an axis
        self._geometry = (ctypes.c_longlong * (3 + 8 * self.ndim))(
            self.ndim, *self.sites, *self.slots, *self.child_shape, *self.coarse_shape,
            *self.mstrides, _ROUTE_CODES[self.step_route], _ROUTE_CODES[self.transpose_route],
            *box, *nbox, *halo_max)

    @property
    def key(self):
        """The level's shape, by which launches are counted: (coarse shape,
        fine shape, W, F)."""
        return (self.coarse_shape, self.fine_shape, self.W, self.F)

    @property
    def routes(self):
        """(step route, transpose route): the step's ``"thread"``,
        ``"group"`` or ``"entry"``, the transpose's ``"box"``, ``"group"`` or
        ``"entry"`` (:func:`choose_routes`)."""
        return self.step_route, self.transpose_route

    def schedule_tables(self):
        """The box route's halos and owners an axis (None elsewhere), in the
        order the C entries take their pointers after :meth:`tables`."""
        b = self._buffers
        return ([b.get(f"box_halo{a}") for a in range(self.ndim)]
                + [b.get(f"box_owner{a}") for a in range(self.ndim)])

    def tables(self):
        """The per-axis window tables, inverse offsets and inverses, in the
        order the C entries take their pointers."""
        b = self._buffers
        return ([b[f"window{a}"] for a in range(self.ndim)]
                + [b[f"inverse_offsets{a}"] for a in range(self.ndim)]
                + [b[f"inverse{a}"] for a in range(self.ndim)])

    def matrices(self):
        """(olf, ker) with the matrix grid's axes: ``matrix_grid + (F, W)``
        and ``matrix_grid + (F, F)``."""
        return (self.olf.reshape(*self.matrix_grid, self.F, self.W),
                self.ker.reshape(*self.matrix_grid, self.F, self.F))

    def extra_repr(self):
        return (f"coarse={self.coarse_shape}, fine={self.fine_shape}, W={self.W}, F={self.F}, "
                f"matrices={self.matrix_grid}, routes={self.routes}")


# -- plain versions -------------------------------------------------------


def gather_windows(x, tables):
    """The windows of every site: ``x (..., n_1, ..., n_d)`` -> ``(..., s_1,
    ..., s_d, W)``, through one integer table ``(s_a, w_a)`` an axis, entries
    in ``[0, n_a)``; slots row-major over the axes.  The gather runs from the
    last axis, so the window axes it inserts never disturb pending ones."""
    d = len(tables)
    lead = x.ndim - d
    for a in range(d - 1, -1, -1):
        tab = tables[a]
        x = x.index_select(lead + a, tab.reshape(-1)).unflatten(lead + a, tuple(tab.shape))
    perm = (list(range(lead)) + [lead + 2 * a for a in range(d)]
            + [lead + 2 * a + 1 for a in range(d)])
    x = x.permute(perm)
    return x.reshape(x.shape[:lead + d] + (-1,))


def interleave_children(y, child_shape):
    """``(..., s_1, ..., s_d, F)`` -> the fine grid ``(..., s_1 f_1, ..., s_d
    f_d)``: child ``c_a`` of site ``s_a`` at ``s_a * f_a + c_a`` along every
    axis, children row-major over the axes."""
    d = len(child_shape)
    lead = y.ndim - d - 1
    sites = y.shape[lead:lead + d]
    y = y.reshape(y.shape[:lead] + sites + tuple(child_shape))
    perm = list(range(lead))
    for a in range(d):
        perm.extend([lead + a, lead + d + a])
    y = y.permute(perm)
    return y.reshape(y.shape[:lead] + tuple(s * c for s, c in zip(sites, child_shape)))


def icr_refine_plain(coarse, xi, level: RefineLevel):
    """The refinement step for ``(B, n_coarse)`` coarse values and ``(B, S *
    F)`` excitations: the windows, the two per-site products (matrices
    broadcast along the axes where they are shared), the children placed."""
    nrows = coarse.shape[0]
    tables = [level._buffers[f"window{a}"] for a in range(level.ndim)]
    win = gather_windows(coarse.reshape(nrows, *level.coarse_shape), tables)
    x = xi.reshape(nrows, *level.sites, level.F)
    if level.n_matrices == 1:
        y = (torch.einsum("b...w,fw->b...f", win, level.olf[0])
             + torch.einsum("b...e,fe->b...f", x, level.ker[0]))
    else:
        olf, ker = level.matrices()
        y = (torch.einsum("b...w,...fw->b...f", win, olf.expand(*level.sites, level.F, level.W))
             + torch.einsum("b...e,...fe->b...f", x, ker.expand(*level.sites, level.F, level.F)))
    return interleave_children(y, level.child_shape).reshape(nrows, level.n_fine)


def icr_refine_transpose_plain(cot, level: RefineLevel):
    """The transpose of :func:`icr_refine_plain` for a ``(B, n_fine)``
    cotangent: its autograd pull-back, ``(cot_coarse, cot_xi)``."""
    nrows = cot.shape[0]
    with torch.enable_grad():
        coarse = cot.new_zeros((nrows, level.n_coarse), requires_grad=True)
        xi = cot.new_zeros((nrows, level.S * level.F), requires_grad=True)
        out = icr_refine_plain(coarse, xi, level)
        return torch.autograd.grad(out, (coarse, xi), cot)


# -- kernel wrappers ------------------------------------------------------

_KERNELS: dict = {}


def _kernels():
    """The library's C entries, loaded (and built) at first use."""
    if _KERNELS:
        return _KERNELS
    lib = load_library("icr_refine")
    lib.icr_refine_max_axes.argtypes, lib.icr_refine_max_axes.restype = [], ctypes.c_int
    if lib.icr_refine_max_axes() != MAX_AXES:
        raise RuntimeError(f"icr_refine built for {lib.icr_refine_max_axes()} axes; the host "
                           f"uses {MAX_AXES}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.icr_refine_threads.argtypes, lib.icr_refine_threads.restype = [], ci
    lib.icr_refine_shapes.argtypes, lib.icr_refine_shapes.restype = [vp, ci], ci
    out = (ctypes.c_int * (5 * 16))()
    shapes = tuple(
        tuple(zip(out[5 * i + 1:5 * i + 5:2], out[5 * i + 2:5 * i + 5:2]))[:out[5 * i]]
        for i in range(lib.icr_refine_shapes(out, 16)))
    if shapes != COMPILED_SHAPES or lib.icr_refine_threads() != THREADS:
        raise RuntimeError(f"icr_refine built for the shapes {shapes} and "
                           f"{lib.icr_refine_threads()} threads; the host uses "
                           f"{COMPILED_SHAPES} and {THREADS}")
    for dtype, sfx in _FLOAT_DTYPES.items():
        fwd = getattr(lib, f"icr_refine_{sfx}")
        fwd.argtypes = [vp] * 7 + [ci, ci, vp]
        fwd.restype = ci
        tr = getattr(lib, f"icr_refine_transpose_{sfx}")
        tr.argtypes = [vp] * 8 + [ci, ci, vp]
        tr.restype = ci
        desc = getattr(lib, f"icr_refine_describe_{sfx}")
        desc.argtypes = [vp, vp, ci, vp, ci]
        desc.restype = ci
        _KERNELS["refine", dtype] = fwd
        _KERNELS["transpose", dtype] = tr
        _KERNELS["describe", dtype] = desc
    return _KERNELS


def _check(x, level: RefineLevel, width: int, what: str):
    shape = x.shape
    if len(shape) != 2 or shape[1] != width:
        raise ValueError(f"{what} must have shape (B, {width}); got {tuple(shape)}")
    olf = level._buffers["olf"]
    if x.dtype != olf.dtype:
        raise TypeError(f"{what} is {x.dtype} but the level's matrices are {olf.dtype}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{what} must be float32 or float64; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != olf.device:
        raise ValueError(f"{what} on {x.device} but the level on {olf.device}")
    if shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows; got {shape[0]}")


def _launch_args(level: RefineLevel, dev: int):
    if level.ndim > MAX_AXES:
        raise ValueError(f"the kernel takes at most {MAX_AXES} axes; the level has {level.ndim}")
    tables = level.tables() + level.schedule_tables()
    ptrs = (ctypes.c_void_p * len(tables))(*(None if t is None else t.data_ptr()
                                             for t in tables))
    return level._geometry, ptrs, torch._C._cuda_getCurrentRawStream(dev)


def describe_kernels(level: RefineLevel, transpose: bool):
    """What the card made of the kernels a call on ``level`` launches (one
    row): for each, a dict of its registers, local (spill) bytes, static
    and dynamic shared memory a block, blocks and threads a block."""
    olf = level._buffers["olf"]
    fn = _kernels()["describe", olf.dtype]
    geom, tables, _ = _launch_args(level, olf.get_device())
    info = (ctypes.c_longlong * 12)()
    n = fn(geom, tables, int(transpose), info, olf.get_device())
    if n < 0:
        raise RuntimeError(f"describing the kernels failed with cudaError {-n}")
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem", "blocks", "threads")
    return [dict(zip(keys, info[6 * k:6 * k + 6])) for k in range(n)]


def _count(wrapper, level: RefineLevel, nrows: int):
    wrapper.launches += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_level[level.key, nrows] += 1
    wrapper.launches_by_dtype[_FLOAT_DTYPES[level.olf.dtype]] += 1


def icr_refine(coarse, xi, level: RefineLevel):
    """The refinement step, ``(B, n_coarse)`` and ``(B, S * F)`` -> ``(B,
    n_fine)``: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    _check(coarse, level, level.n_coarse, "coarse values")
    _check(xi, level, level.S * level.F, "excitations")
    if not coarse.is_cuda:
        if coarse.device.type == "cpu":
            return icr_refine_plain(coarse, xi, level)
        raise RuntimeError(f"no icr_refine kernel for device {coarse.device}")
    fn = _kernels()["refine", coarse.dtype]
    nrows = coarse.shape[0]
    out = coarse.new_empty((nrows, level.n_fine))
    dev = coarse.get_device()
    geom, tables, stream = _launch_args(level, dev)
    b = level._buffers
    rc = fn(coarse.data_ptr(), xi.data_ptr(), b["olf"].data_ptr(), b["ker"].data_ptr(),
            out.data_ptr(), geom, tables, nrows, dev, stream)
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    _count(icr_refine, level, nrows)
    return out


def icr_refine_transpose(cot, level: RefineLevel):
    """The transpose of the refinement step, ``(B, n_fine)`` -> ``(cot_coarse
    (B, n_coarse), cot_xi (B, S * F))``: the kernel (one pass on the box
    route, two through scratch on the others) for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check(cot, level, level.n_fine, "cotangent")
    if not cot.is_cuda:
        if cot.device.type == "cpu":
            return icr_refine_transpose_plain(cot, level)
        raise RuntimeError(f"no icr_refine kernel for device {cot.device}")
    fn = _kernels()["transpose", cot.dtype]
    nrows = cot.shape[0]
    cot_coarse = cot.new_empty((nrows, level.n_coarse))
    cot_xi = cot.new_empty((nrows, level.S * level.F))
    # the two passes' slot cotangents, read back by the gather pass: scratch
    # from the caching allocator (so the call can be captured in a CUDA
    # graph); the box route keeps them in shared memory
    scratch = (None if level.transpose_route == "box"
               else cot.new_empty((nrows, level.S * level.W)))
    dev = cot.get_device()
    geom, tables, stream = _launch_args(level, dev)
    b = level._buffers
    rc = fn(cot.data_ptr(), b["olf"].data_ptr(), b["ker"].data_ptr(),
            None if scratch is None else scratch.data_ptr(), cot_coarse.data_ptr(),
            cot_xi.data_ptr(), geom, tables, nrows, dev, stream)
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")
    _count(icr_refine_transpose, level, nrows)
    return cot_coarse, cot_xi


def reset_launch_counts():
    for fn in (icr_refine, icr_refine_transpose):
        fn.launches = 0
        fn.launches_by_rows, fn.launches_by_level = Counter(), Counter()
        fn.launches_by_dtype = Counter()


reset_launch_counts()


# -- autograd pair --------------------------------------------------------


def _rows(x, dim, n):
    """``x`` with the vmapped dimension ``dim`` first (broadcast to ``n``
    where it has none), its rows flattened after it: ``(n * B, width)``."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(n, *x.shape)
    return x.reshape(-1, x.shape[-1]).contiguous()


class IcrRefine(torch.autograd.Function):
    """(coarse (B, n_coarse), xi (B, S F)) -> fine (B, n_fine); derivative:
    the transpose."""

    @staticmethod
    def forward(coarse, xi, level):
        return icr_refine(coarse, xi, level)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.level = inputs[2]
        ctx.shapes = (inputs[0].shape, inputs[1].shape)

    @staticmethod
    def backward(ctx, grad_out):
        cot_coarse, cot_xi = IcrRefineTranspose.apply(grad_out.contiguous(), ctx.level)
        return cot_coarse, cot_xi, None

    @staticmethod
    def jvp(ctx, coarse_dot, xi_dot, _level_dot):
        ref = coarse_dot if coarse_dot is not None else xi_dot
        if coarse_dot is None:
            coarse_dot = ref.new_zeros(ctx.shapes[0])
        if xi_dot is None:
            xi_dot = ref.new_zeros(ctx.shapes[1])
        return IcrRefine.apply(coarse_dot.contiguous(), xi_dot.contiguous(), ctx.level)

    @staticmethod
    def vmap(info, in_dims, coarse, xi, level):
        dc, dx = in_dims[0], in_dims[1]
        if dc is None and dx is None:
            return IcrRefine.apply(coarse, xi, level), None
        n = info.batch_size
        nrows = coarse.shape[0] if dc is None else coarse.shape[1]
        out = IcrRefine.apply(_rows(coarse, dc, n), _rows(xi, dx, n), level)
        return out.reshape(n, nrows, -1), 0


class IcrRefineTranspose(torch.autograd.Function):
    """cot (B, n_fine) -> (cot_coarse (B, n_coarse), cot_xi (B, S F));
    derivative: the refinement step."""

    @staticmethod
    def forward(cot, level):
        return icr_refine_transpose(cot, level)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.level = inputs[1]
        ctx.shapes = (output[0].shape, output[1].shape)

    @staticmethod
    def backward(ctx, grad_coarse, grad_xi):
        ref = grad_coarse if grad_coarse is not None else grad_xi
        if grad_coarse is None:
            grad_coarse = ref.new_zeros(ctx.shapes[0])
        if grad_xi is None:
            grad_xi = ref.new_zeros(ctx.shapes[1])
        return IcrRefine.apply(grad_coarse.contiguous(), grad_xi.contiguous(), ctx.level), None

    @staticmethod
    def jvp(ctx, cot_dot, _level_dot):
        return IcrRefineTranspose.apply(cot_dot.contiguous(), ctx.level)

    @staticmethod
    def vmap(info, in_dims, cot, level):
        if in_dims[0] is None:
            return IcrRefineTranspose.apply(cot, level), (None, None)
        c = cot.movedim(in_dims[0], 0)
        n, nrows = c.shape[0], c.shape[1]
        cot_coarse, cot_xi = IcrRefineTranspose.apply(c.reshape(n * nrows, -1).contiguous(),
                                                      level)
        return (cot_coarse.reshape(n, nrows, -1), cot_xi.reshape(n, nrows, -1)), (0, 0)


def refine_level(coarse, xi, level: RefineLevel):
    """The refinement step with leading batch axes: ``coarse (..., n_coarse)``
    and ``xi (..., S * F)`` -> ``(..., n_fine)``."""
    lead = torch.broadcast_shapes(coarse.shape[:-1], xi.shape[:-1])
    c2 = coarse.expand(*lead, level.n_coarse).reshape(-1, level.n_coarse).contiguous()
    x2 = xi.expand(*lead, xi.shape[-1]).reshape(-1, xi.shape[-1]).contiguous()
    return IcrRefine.apply(c2, x2, level).reshape(*lead, level.n_fine)
