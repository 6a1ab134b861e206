"""The window pair of the non-uniform FFT, K7: interpolation from the
oversampled spectrum and its exact adjoint.

For ``npts`` points at positions ``x_j`` on a complex oversampled grid of
shape ``n = (n_0, ..., n_{d-1})`` (a frequency times ``n_os / n_image``),

    v[b, j] = Σ_{t ∈ W^d} φ_t(x_j) · g[b, (i0_j + off_t) mod n]          (interp)
    g[b, c] = Σ_{(j, t) : (i0_j + off_t) mod n = c} φ_t(x_j) · v[b, j]      (spread)

with ``i0_j = floor(x_j)`` and ``off_t = t - W // 2 + 1`` per axis, and
``φ_t`` the product over the axes of the exp-of-semicircle kernel
``exp(β (sqrt(1 - s²) - 1))`` at ``s = (x - (i0 + off)) / (W / 2)``, the
first axis's factor first.  The JAX package computes the interpolation with
XLA (``nifty_tpu/ops/nufft.py:204-247``, ``interp_point`` vmapped over the
points) and its transpose as the scatter-add autodiff makes of it
(``:251-265``); the weights are real, so the spread is also the adjoint
``W^H`` of the complex interpolation.

:class:`WindowTable` holds a point set's tables as buffers, built on the
host from static positions: the positions, each point's base cell, and a
CSR over the cells (the points sorted by the flat index of their base cell,
stable, with each cell's offsets), each point's first tap cell per axis
in CSR order, and the spread's sum blocks (the blocks some window reaches,
the most terms first) and fill chunks (the cells of the others); on the card
also each point's axis factors in CSR order, built by a kernel at the
table's first use there (:func:`csr_factors_plain` is their plain version).
The hand-written kernels (``csrc/nufft_window.cu``) run them for a CUDA
tensor; :func:`window_interp_plain` and :func:`window_spread_plain` are the
plain versions, which :func:`window_interp` / :func:`window_spread` take for
a CPU tensor only.  Their ``launches`` count the calls that take the kernel
route (the spread's launch two kernels: the values' gather and the sums),
in total, by rows (``launches_by_rows``), by (table key, rows)
(``launches_by_shape``) and by float type (``launches_by_dtype``, "f32" /
"f64"); :func:`build_factors` counts the factor tables it builds.
:class:`WindowInterp` and :class:`WindowSpread` are the
``torch.autograd.Function`` pair, each the other's derivative, with
``setup_context``, ``jvp`` and ``vmap``.  The positions are constants of
the model: no gradient flows to them.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch
from torch import nn

from .cuda_build import load_library

_REAL = {torch.float32: "f32", torch.float64: "f64"}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_NP = {torch.float32: np.float32, torch.float64: np.float64}
#: the most rows a spread block serves (``kRowTile`` in the source)
ROW_TILE = 4
#: the widest window the kernels take (``kMaxWidth``)
MAX_WIDTH = 16
#: the most rows a call takes: the spread's gridDim.y (65535) row tiles of
#: ``ROW_TILE``
MAX_ROWS = 65535 * ROW_TILE
#: the cells along the innermost axis a spread block takes (``kSpreadCells``)
SPREAD_CELLS = 32
#: the most cells of a spread fill chunk (``kFillCells``)
FILL_CELLS = 2048


def es_beta(sigma: float, width: int) -> float:
    """The ES kernel's sharpness: ``2.30 W`` at σ = 2, ``π W (1 - 1/(2σ))
    0.976`` in general (Barnett, Magland & af Klinteberg 2019, §3)."""
    if abs(sigma - 2.0) < 1e-12:
        return 2.30 * width
    return np.pi * width * (1.0 - 1.0 / (2.0 * sigma)) * 0.976


def es_phi(t, beta: float):
    """The ES kernel on the normalized support ``|t| <= 1`` (0 outside),
    for a tensor ``t``."""
    arg = torch.clamp_min(1.0 - t * t, 0.0)
    return torch.where(t.abs() <= 1.0, torch.exp(beta * (torch.sqrt(arg) - 1.0)),
                       torch.zeros_like(t))


def deconv_factors(n: int, n_os: int, width: int, beta: float):
    """The image-domain correction ``1 / ψ̂(x / n_os)`` for the ES kernel on
    the centered image axis of length ``n`` (numpy float64):
    ``ψ̂(ξ) = W ∫_0^1 φ(t) cos(π W ξ t) dt`` by 64-node Gauss-Legendre
    quadrature."""
    t, q = np.polynomial.legendre.leggauss(64)
    t = 0.5 * (t + 1.0)
    q = 0.5 * q
    phi = np.exp(beta * (np.sqrt(np.maximum(1.0 - t * t, 0.0)) - 1.0))
    x = (np.arange(n) - n // 2).astype(float) / n_os
    psi_hat = width * np.cos(np.pi * width * x[:, None] * t[None, :]) @ (q * phi)
    return 1.0 / psi_hat


def window_terms(counts, width: int):
    """The (point, tap) terms that land in each cell (int64, the oversampled
    grid's shape): ``counts`` holds the points of each base cell, and a
    cell ``c`` takes those of the base cells ``c - off`` for the window's
    offsets on every axis (wrapped).  A cell is reached where it is not 0."""
    terms = counts.astype(np.int64)
    offs = np.arange(width) - (width // 2 - 1)
    for a in range(counts.ndim):
        terms = sum(np.roll(terms, o, axis=a) for o in offs)
    return terms


def spread_block_terms(terms, cells: int = SPREAD_CELLS):
    """The terms of each block of the spread kernel (int64, one per block);
    a block takes ``cells`` consecutive cells along the innermost axis of
    one line."""
    nl = terms.shape[-1]
    segs = -(-nl // cells)
    lines = terms.reshape(-1, nl)
    padded = np.zeros((lines.shape[0], segs * cells), dtype=np.int64)
    padded[:, :nl] = lines
    return padded.reshape(-1, segs, cells).sum(-1).reshape(-1)


def sum_blocks(block_terms):
    """The spread's sum blocks: the blocks with a term, the most terms first
    (ties in block order), int32."""
    order = np.argsort(-block_terms, kind="stable")
    return order[:int(np.count_nonzero(block_terms))].astype(np.int32)


def fill_chunks(active, nl: int, cells: int = SPREAD_CELLS, chunk: int = FILL_CELLS):
    """The spread's fill chunks, ``(nfill, 2)`` int32 (first cell, cells):
    the cells of the blocks that no window reaches (``active`` false), in runs
    of consecutive blocks, cut where a run crosses a multiple of ``chunk``
    cells."""
    segs = -(-nl // cells)
    blk = np.arange(active.size, dtype=np.int64)
    line_start = (blk // segs) * nl
    start = line_start + (blk % segs) * cells
    stop = np.minimum(start + cells, line_start + nl)
    edges = np.diff(np.concatenate([[0], (active == 0).astype(np.int8), [0]]))
    lo, hi = start[edges[:-1] == 1], stop[np.flatnonzero(edges[1:] == -1)]
    n = (hi - 1) // chunk - lo // chunk + 1
    run = np.repeat(np.arange(lo.size), n)
    c = lo[run] // chunk + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    first = np.maximum(c * chunk, lo[run])
    last = np.minimum((c + 1) * chunk, hi[run])
    return np.stack([first, last - first], axis=-1).astype(np.int32).reshape(-1, 2)


def oversampled_shape(shape, sigma: float) -> tuple:
    return tuple(int(np.round(sigma * n)) for n in shape)


class WindowTable(nn.Module):
    """The tables of one point set on the oversampled grid of an image of
    ``shape``, as non-persistent buffers (``.to(device)`` moves them).

    ``xs`` (``(npts, d)``, float32 or float64) holds the positions,
    ``i0`` (int64) their base cells per axis; ``csr_pts`` (int32) the
    points sorted by the flat index of their base cell, stable, and
    ``csr_off`` (int32, ``ncells + 1``) each cell's offsets in it;
    ``csr_first`` (int32, ``(npts, d)``) each point's first tap cell per
    axis, ``(i0 - W // 2 + 1) mod n``, in CSR order; ``sum_blocks``
    (int32) the spread kernel's blocks that some window reaches, the most
    terms first (:func:`window_terms`, :func:`spread_block_terms`,
    :func:`sum_blocks`), and ``fill`` (int32, ``(nfill, 2)``) the others'
    cells (:func:`fill_chunks`); ``factors``
    each point's axis factors ``(npts, d, W)`` in CSR order, empty until
    :func:`build_factors` builds them on the card; ``deconv0``,
    ``deconv1``, ... the image axes' deconvolution factors
    (:func:`deconv_factors`) in the positions' dtype.  ``key`` =
    ``(os_shape, npts, width)`` names the table in the launch counts."""

    def __init__(self, shape, coords, *, sigma: float = 2.0, width: int = 8,
                 dtype=torch.float64):
        super().__init__()
        if dtype not in _NP:
            raise TypeError(f"positions must be float32 or float64; got {dtype}")
        self.shape = tuple(int(n) for n in shape)
        self.d = len(self.shape)
        if not 1 <= self.d <= 3:
            raise NotImplementedError("nufft supports up to 3 dimensions")
        if torch.is_tensor(coords):
            if coords.requires_grad:
                raise ValueError("the NUFFT's coordinates are constants: no gradient flows "
                                 "to them")
            coords = coords.detach().cpu().numpy()
        coords = np.asarray(coords)
        if coords.ndim != 2 or coords.shape[1] != self.d:
            raise ValueError(f"coordinates must have shape (npts, {self.d}); got {coords.shape}")
        self.sigma, self.width = float(sigma), int(width)
        if not 1 <= self.width <= MAX_WIDTH:
            raise ValueError(f"window widths 1 to {MAX_WIDTH} are supported; got {width}")
        self.beta = es_beta(self.sigma, self.width)
        self.half = self.width / 2.0
        self.os_shape = oversampled_shape(self.shape, self.sigma)
        self.ncells = int(np.prod(self.os_shape))
        if self.ncells >= 2**31 - 1:
            raise ValueError("oversampled grids of 2^31 cells or more are not supported")
        self.npts = coords.shape[0]
        if self.npts >= 2**31:
            raise ValueError("2^31 points or more are not supported")
        self.key = (self.os_shape, self.npts, self.width)
        # positions: coordinates times n_os / n, both in the table's type (the
        # JAX package casts float32 coordinates before it scales them)
        scale = np.asarray([no / n for no, n in zip(self.os_shape, self.shape)],
                           dtype=_NP[dtype])
        xs = np.ascontiguousarray(np.asarray(coords, dtype=_NP[dtype]) * scale)
        i0 = np.floor(xs).astype(np.int64)
        base = np.zeros(self.npts, dtype=np.int64)
        for a, n in enumerate(self.os_shape):
            base = base * n + i0[:, a] % n
        order = np.argsort(base, kind="stable")
        off = np.zeros(self.ncells + 1, dtype=np.int64)
        np.cumsum(np.bincount(base, minlength=self.ncells), out=off[1:])
        deconv = [(f"deconv{a}", deconv_factors(n, no, self.width, self.beta).astype(_NP[dtype]))
                  for a, (n, no) in enumerate(zip(self.shape, self.os_shape))]
        terms = window_terms(np.diff(off).reshape(self.os_shape), self.width)
        #: the cells the windows reach: the grid values the interpolation needs
        self.n_reached = int(np.count_nonzero(terms))
        block_terms = spread_block_terms(terms)
        first = (i0[order] - (self.width // 2 - 1)) % np.asarray(self.os_shape)
        tables = (("xs", xs), ("i0", i0), ("csr_pts", order.astype(np.int32)),
                  ("csr_off", off.astype(np.int32)), ("csr_first", first.astype(np.int32)),
                  ("sum_blocks", sum_blocks(block_terms)),
                  ("fill", fill_chunks(block_terms > 0, self.os_shape[-1])),
                  ("factors", np.zeros(0, dtype=_NP[dtype])), *deconv)
        for name, arr in tables:
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    @property
    def dtype(self):
        return self.xs.dtype

    @property
    def complex_dtype(self):
        return _COMPLEX[self.xs.dtype]

    def extra_repr(self):
        return f"shape={self.shape}, os_shape={self.os_shape}, points={self.npts}, " \
               f"width={self.width}"


# -- plain versions -------------------------------------------------------


def window_entries(table: WindowTable):
    """Every (point, tap) entry: the flat cells ``(npts, W^d)`` (int64) and
    the weights ``(npts, W^d)``, taps in row-major order (the last axis
    fastest), each weight the product of the axes' from the first on."""
    offs = torch.arange(table.width, device=table.xs.device) - (table.width // 2 - 1)
    cells, weights = None, None
    for a, n in enumerate(table.os_shape):
        taps = table.i0[:, a, None] + offs  # (npts, W), unwrapped
        idx = torch.remainder(taps, n)
        wgt = es_phi((table.xs[:, a, None] - taps.to(table.dtype)) / table.half, table.beta)
        if cells is None:
            cells, weights = idx, wgt
        else:
            cells = (cells[:, :, None] * n + idx[:, None, :]).reshape(table.npts, -1)
            weights = (weights[:, :, None] * wgt[:, None, :]).reshape(table.npts, -1)
    return cells, weights


def csr_factors_plain(table: WindowTable):
    """Each point's axis factors in CSR order, ``(npts, d, W)``: point
    ``csr_pts[k]``'s weight on axis ``a`` at tap ``t``, as
    :func:`window_entries` computes it (the plain version of the factor
    table the kernels read)."""
    offs = torch.arange(table.width, device=table.xs.device) - (table.width // 2 - 1)
    pts = table.csr_pts.long()
    taps = table.i0[pts, :, None] + offs  # (npts, d, W), unwrapped
    return es_phi((table.xs[pts, :, None] - taps.to(table.dtype)) / table.half, table.beta)


def gather_values_plain(v, table: WindowTable):
    """The rows' values in CSR order, ``v[:, csr_pts]`` (what the spread
    kernel reads)."""
    return v.index_select(1, table.csr_pts.long())


def _wide(x):
    return x.to(torch.complex128)


def window_interp_plain(g, table: WindowTable):
    """The interpolation for spectra ``(B, ncells)`` -> ``(B, npts)``: each
    point's window gathered and weighted, summed in complex128 (as the
    kernel sums)."""
    cells, weights = window_entries(table)
    vals = g.index_select(1, cells.reshape(-1)).reshape(g.shape[0], table.npts, -1)
    return _wide(vals * weights).sum(-1).to(g.dtype)


def window_spread_plain(v, table: WindowTable):
    """The spread for values ``(B, npts)`` -> ``(B, ncells)``: each entry's
    weight times its point's value, added into its cell (``index_add_``,
    in complex128)."""
    cells, weights = window_entries(table)
    terms = _wide(v[:, :, None] * weights).reshape(v.shape[0], -1)
    out = terms.new_zeros((v.shape[0], table.ncells)).index_add_(1, cells.reshape(-1), terms)
    return out.to(v.dtype)


def sum_abs_terms(table: WindowTable, g=None, v=None):
    """The per-output sum of |term| (a term's modulus as a complex number)
    of the interpolation of ``g`` or of the spread of ``v``: the scale the
    kernels' error is held to."""
    cells, weights = window_entries(table)
    weights = weights.abs().double()
    if g is not None:
        vals = g.abs().double().index_select(1, cells.reshape(-1))
        return (vals.reshape(g.shape[0], table.npts, -1) * weights).sum(-1)
    terms = (v.abs().double()[:, :, None] * weights).reshape(v.shape[0], -1)
    return terms.new_zeros((v.shape[0], table.ncells)).index_add_(1, cells.reshape(-1), terms)


# -- kernel wrappers ------------------------------------------------------

_KERNELS: dict = {}


def _kernels():
    """The library's C entries, loaded (and built) at first use."""
    if _KERNELS:
        return _KERNELS
    lib = load_library("nufft_window")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    argtypes = {"factors": [vp] * 3 + [ci] * 3 + [cd, ci, vp],
                "gather": [vp] * 3 + [ci] * 3 + [vp],
                "interp": [vp] * 5 + [ci] * 8 + [vp],
                "spread": [vp] * 4 + [ci, vp, ci, vp] + [ci] * 8 + [vp]}
    for dtype, sfx in _REAL.items():
        for kind, types in argtypes.items():
            fn = getattr(lib, f"nufft_{kind}_{sfx}")
            fn.argtypes, fn.restype = types, ci
            _KERNELS[kind, dtype] = fn
    for name, want in (("nufft_window_row_tile", ROW_TILE), ("nufft_window_max_width", MAX_WIDTH),
                       ("nufft_window_spread_cells", SPREAD_CELLS),
                       ("nufft_window_fill_cells", FILL_CELLS)):
        fn = getattr(lib, name)
        fn.restype = ci
        if fn() != want:
            raise RuntimeError(f"kernels built with {name} {fn()}; the host uses {want}")
    return _KERNELS


def _check(x, table: WindowTable, width: int, what: str):
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{what} must have shape (B, {width}); got {tuple(x.shape)}")
    if x.dtype != table.complex_dtype:
        raise TypeError(f"{what} is {x.dtype} but the table takes {table.complex_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != table.xs.device:
        raise ValueError(f"{what} on {x.device} but the table on {table.xs.device}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows; got {x.shape[0]}")


def _dims(table: WindowTable):
    return (*table.os_shape, *[1] * (3 - table.d))


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev)


def _launched(rc):
    if rc < 0:
        raise RuntimeError(f"CUDA kernel launch failed with cudaError {-rc}")


def _count(wrapper, table: WindowTable, nrows: int):
    wrapper.launches += 1
    wrapper.launches_by_rows[nrows] += 1
    wrapper.launches_by_shape[table.key, nrows] += 1
    wrapper.launches_by_dtype[_REAL[table.dtype]] += 1


def build_factors(table: WindowTable):
    """The table's axis factors on its card (``table.factors``), built by
    the factor kernel where they are not yet there; the kernels read them.
    Inside a CUDA graph's capture the kernel is only recorded, so a table
    not yet built gets factors of that graph's own, which its replays
    rebuild, and keeps none.  ``launches`` / ``launches_by_shape`` count the
    builds."""
    f = table.factors
    if (f.numel() == table.npts * table.d * table.width and f.dtype == table.dtype
            and f.device == table.xs.device):
        return f
    f = table.xs.new_empty((table.npts, table.d, table.width))
    dev = f.get_device()
    _launched(_kernels()["factors", table.dtype](
        table.xs.data_ptr(), table.csr_pts.data_ptr(), f.data_ptr(), table.npts, table.d,
        table.width, table.beta, dev, _stream(dev)))
    if not torch.cuda.is_current_stream_capturing():
        table.factors = f
    build_factors.launches += 1
    build_factors.launches_by_shape[table.key] += 1
    build_factors.launches_by_dtype[_REAL[table.dtype]] += 1
    return f


def gather_values(v, table: WindowTable):
    """``v[:, csr_pts]`` by the gather kernel for a CUDA tensor (the plain
    version for a CPU one)."""
    _check(v, table, table.npts, "values")
    if not v.is_cuda:
        if v.device.type == "cpu":
            return gather_values_plain(v, table)
        raise RuntimeError(f"no nufft_window kernel for device {v.device}")
    out = torch.empty_like(v)
    dev = v.get_device()
    _launched(_kernels()["gather", table.dtype](
        v.data_ptr(), table.csr_pts.data_ptr(), out.data_ptr(), table.npts, v.shape[0], dev,
        _stream(dev)))
    return out


def window_interp(g, table: WindowTable):
    """The interpolation, spectra ``(B, ncells)`` -> ``(B, npts)``: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    _check(g, table, table.ncells, "spectrum")
    if not g.is_cuda:
        if g.device.type == "cpu":
            return window_interp_plain(g, table)
        raise RuntimeError(f"no nufft_window kernel for device {g.device}")
    fac = build_factors(table)
    out = g.new_empty((g.shape[0], table.npts))
    dev = g.get_device()
    _launched(_kernels()["interp", table.dtype](
        g.data_ptr(), fac.data_ptr(), table.csr_first.data_ptr(), table.csr_pts.data_ptr(),
        out.data_ptr(), table.npts, table.d, *_dims(table), table.width, g.shape[0], dev,
        _stream(dev)))
    _count(window_interp, table, g.shape[0])
    return out


def window_spread(v, table: WindowTable):
    """The spread, values ``(B, npts)`` -> ``(B, ncells)``: the kernels for
    a CUDA tensor (the values' gather into CSR order, then the sums and
    zeros), the plain version for a CPU tensor."""
    _check(v, table, table.npts, "values")
    if not v.is_cuda:
        if v.device.type == "cpu":
            return window_spread_plain(v, table)
        raise RuntimeError(f"no nufft_window kernel for device {v.device}")
    fac = build_factors(table)
    vg = gather_values(v, table)
    out = v.new_empty((v.shape[0], table.ncells))
    dev = v.get_device()
    _launched(_kernels()["spread", table.dtype](
        vg.data_ptr(), fac.data_ptr(), table.csr_off.data_ptr(), table.sum_blocks.data_ptr(),
        table.sum_blocks.numel(), table.fill.data_ptr(), table.fill.shape[0], out.data_ptr(),
        table.npts, table.d, *_dims(table), table.width, v.shape[0], dev, _stream(dev)))
    _count(window_spread, table, v.shape[0])
    return out


def reset_launch_counts():
    for fn in (window_interp, window_spread):
        fn.launches = 0
        fn.launches_by_rows, fn.launches_by_shape = Counter(), Counter()
        fn.launches_by_dtype = Counter()
    build_factors.launches, build_factors.launches_by_shape = 0, Counter()
    build_factors.launches_by_dtype = Counter()


reset_launch_counts()


# -- autograd pair --------------------------------------------------------


def _flat_rows(x, in_dim):
    x = x.movedim(in_dim, 0)
    return x.reshape(x.shape[0] * x.shape[1], -1).contiguous(), x.shape[:2]


class WindowInterp(torch.autograd.Function):
    """spectra (B, ncells) -> values (B, npts); derivative: the spread."""

    @staticmethod
    def forward(g, table):
        return window_interp(g, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return WindowSpread.apply(grad_out.contiguous(), ctx.table), None

    @staticmethod
    def jvp(ctx, g_dot, _table_dot):
        return WindowInterp.apply(g_dot.contiguous(), ctx.table)

    @staticmethod
    def vmap(info, in_dims, g, table):
        if in_dims[0] is None:
            return WindowInterp.apply(g, table), None
        flat, lead = _flat_rows(g, in_dims[0])
        return WindowInterp.apply(flat, table).reshape(*lead, -1), 0


class WindowSpread(torch.autograd.Function):
    """values (B, npts) -> spectra (B, ncells); derivative: the interpolation."""

    @staticmethod
    def forward(v, table):
        return window_spread(v, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad_out):
        return WindowInterp.apply(grad_out.contiguous(), ctx.table), None

    @staticmethod
    def jvp(ctx, v_dot, _table_dot):
        return WindowSpread.apply(v_dot.contiguous(), ctx.table)

    @staticmethod
    def vmap(info, in_dims, v, table):
        if in_dims[0] is None:
            return WindowSpread.apply(v, table), None
        flat, lead = _flat_rows(v, in_dims[0])
        return WindowSpread.apply(flat, table).reshape(*lead, -1), 0
