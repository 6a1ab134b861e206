"""Iterative charted refinement (ICR) GP fields (counterpart of
:mod:`nifty_tpu.refine.charted_field`).

A GP with kernel ``k(r)`` is built level by level: the coarsest grid is an
exact draw (dense Cholesky over the small level-0 covariance); each
refinement conditions ``fine_size^d`` fine pixels per window on the
``coarse_size^d`` surrounding coarse values,

    fine = olf · coarse_window + ker_sqrt · ξ ,

with ``olf = k_fc k_cc^{-1}`` (optimal linear filter) and ``ker_sqrt`` the
Cholesky factor of the conditional covariance.

The matrices are host precompute in float64 on the CPU (the user's
``kernel`` receives torch tensors of distances), built once per level and
varying only along the axes where the chart makes them differ (deformed
axes, and axes whose last window is clamped); they are broadcast along
the others, never materialized.  Each level is a
:class:`~nifty_tpu_torch.ops.icr_refine.RefineLevel` whose buffers (the
matrices in the field's dtype, the per-axis window tables) land on the
configured device, the card by default; the level step is the CUDA kernel
K9 (:func:`~nifty_tpu_torch.ops.icr_refine.refine_level`) there and its
plain version on the CPU: the window gather of :func:`coarse_windows`' table
route, the per-site einsums and :func:`_interleave_children`.  The
level-0 product ``cov_sqrt0 @ xi0`` is a dense ``torch.matmul``.  Latents
may carry leading batch axes.
"""

from __future__ import annotations

import itertools
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import config
from ..model import Initializer, Model
from ..ops.icr_refine import RefineLevel, gather_windows, interleave_children, refine_level
from ..tree import ShapeWithDtype, random_like
from .chart import CoordinateChart

#: Sites whose matrices one batched solve builds at a time (bounds the
#: host memory of the kernel evaluations).
MATRIX_CHUNK = 1 << 15


def _pairwise_dist(a, b):
    """Distances between the rows of ``a`` (..., n, d) and ``b`` (..., m, d)."""
    d2 = torch.sum((a[..., :, None, :] - b[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def refinement_matrices(kernel: Callable, coarse_coords, fine_coords,
                        jitter: float = 1e-10):
    """(olf, ker_sqrt) conditioning fine pixels on a coarse window.

    ``coarse_coords`` (..., nw, d), ``fine_coords`` (..., nf, d), in float64
    on the CPU; returns ``olf (..., nf, nw)`` and ``ker_sqrt (..., nf,
    nf)``.  Leading axes are independent sites.  ``k_cc`` is solved by
    Cholesky (it is positive definite, and badly conditioned at deep
    levels), with a jitter relative to the largest marginal variance.
    """
    coarse = torch.as_tensor(coarse_coords, dtype=torch.float64)
    fine = torch.as_tensor(fine_coords, dtype=torch.float64)
    cc = kernel(_pairwise_dist(coarse, coarse))
    fc = kernel(_pairwise_dist(fine, coarse))
    ff = kernel(_pairwise_dist(fine, fine))
    # relative jitter: the conditional covariance of deep levels is many
    # orders of magnitude below the marginal variance
    scale = torch.diagonal(ff, dim1=-2, dim2=-1).abs().amax(-1)[..., None, None]
    cc = cc + (jitter * scale) * torch.eye(cc.shape[-1], dtype=cc.dtype)
    olf = torch.cholesky_solve(fc.mT, torch.linalg.cholesky(cc)).mT
    fine_cov = ff - olf @ fc.mT
    fine_cov = fine_cov + (jitter * scale) * torch.eye(ff.shape[-1], dtype=ff.dtype)
    return olf, torch.linalg.cholesky(fine_cov)


def _batched_matrices(kernel, cws, fws):
    """:func:`refinement_matrices` of many sites, ``cws`` (n, nw, d) and
    ``fws`` (n, nf, d) as numpy, in chunks of :data:`MATRIX_CHUNK` sites."""
    olfs, kers = [], []
    for lo in range(0, cws.shape[0], MATRIX_CHUNK):
        olf, ker = refinement_matrices(kernel, torch.from_numpy(cws[lo:lo + MATRIX_CHUNK]),
                                       torch.from_numpy(fws[lo:lo + MATRIX_CHUNK]))
        olfs.append(olf)
        kers.append(ker)
    return torch.cat(olfs), torch.cat(kers)


def _cov_sqrt0(kernel, coords):
    """The Cholesky factor of the level-0 covariance (jitter 1e-10)."""
    pos = torch.as_tensor(coords, dtype=torch.float64)
    cc0 = kernel(_pairwise_dist(pos, pos))
    cc0 = cc0 + 1e-10 * torch.eye(cc0.shape[0], dtype=cc0.dtype)
    return torch.linalg.cholesky(cc0)


def _uniform_starts(starts: np.ndarray) -> bool:
    """Whether per-axis window starts form an unclamped uniform stride."""
    if starts.size <= 1:
        return True
    d = np.diff(starts)
    return bool(np.all(d == d[0]))


def _window_table(starts: np.ndarray, csz: int, n: int, periodic: bool) -> np.ndarray:
    """One axis's windows: the ``(sites, csz)`` coarse indices read from
    ``starts`` on, wrapped on a periodic axis of extent ``n``."""
    idx = starts[:, None] + np.arange(csz)[None, :]
    return idx % n if periodic else idx


def coarse_windows(x, ndim: int, *, chart: Optional[CoordinateChart] = None,
                   level: int = 0):
    """Extract all refinement windows around the sites of ``level``.

    ``x`` has shape ``(..., n1, ..., nd)``; returns ``(..., ns1, ..., nsd,
    csz^d)``.  Without a chart, the classic ``coarse_size=3`` / stride-1
    stencil is used.  Uniform axes use strided slices; clamped or periodic
    axes gather through a host-precomputed index table.
    """
    lead = x.ndim - ndim
    if chart is None:
        csz, step = 3, 1
        starts = [np.arange(n - 2) for n in x.shape[lead:]]
        periodic = (False,) * ndim
        shape = x.shape[lead:]
    else:
        csz, step = chart.coarse_size, chart.window_stride
        starts = chart.window_starts(level)
        periodic = chart.periodic
        shape = chart.shapes[level]

    slice_ok = [
        _uniform_starts(s) and not p for s, p in zip(starts, periodic)
    ]
    if all(slice_ok):
        parts = []
        for offs in itertools.product(range(csz), repeat=ndim):
            sl = tuple(
                slice(o, o + (len(s) - 1) * step + 1, step)
                for o, s in zip(offs, starts)
            )
            parts.append(x[(Ellipsis,) + sl])
        return torch.stack(parts, dim=-1)

    # general path: per-axis index tables
    return gather_windows(x, [torch.from_numpy(_window_table(s, csz, n, p)).to(x.device)
                              for s, n, p in zip(starts, shape, periodic)])


def _interleave_children(y, ndim: int, fsz: int = 2):
    """(..., i1..id, fsz^d) block values -> fine grid (..., fsz·i1, ...,
    fsz·id)."""
    return interleave_children(y, (fsz,) * ndim)


class RefinementField(Model):
    """GP field on a (possibly deformed) chart via iterative refinement.

    Parameters
    ----------
    chart : CoordinateChart or tuple/int
        Chart (or ``shape0`` convenience, combined with the chart kwargs).
    kernel : callable
        Isotropic covariance function ``k(r)`` of a float64 torch tensor.
    depth, distances0, nonlinear_map, coarse_size, fine_size,
    fine_strategy, periodic :
        Convenience chart construction when ``chart`` is a shape.
    name : str
        Prefix of the excitation keys (``{name}0``, ``{name}1``, ...).
    dtype :
        Of the latents and the matrices on the device (default float64).
    device :
        Of the buffers (default: the configured device, the card).
    """

    def __init__(
        self,
        chart,
        kernel: Optional[Callable] = None,
        *,
        depth: Optional[int] = None,
        distances0=None,
        nonlinear_map=None,
        coarse_size: int = 3,
        fine_size: int = 2,
        fine_strategy: str = "extend",
        periodic=False,
        name: str = "xi",
        dtype=None,
        device=None,
    ):
        if not isinstance(chart, CoordinateChart):
            chart = CoordinateChart(
                chart, depth=depth if depth is not None else 3,
                distances0=distances0, nonlinear_map=nonlinear_map,
                coarse_size=coarse_size, fine_size=fine_size,
                fine_strategy=fine_strategy, periodic=periodic,
            )
        ndim = chart.ndim
        n_children = chart.fine_size ** ndim
        dtype = dtype if dtype is not None else config.default_float_dtype()
        domain = {f"{name}0": ShapeWithDtype(chart.shape0, dtype)}
        for l in range(chart.depth):
            domain[f"{name}{l + 1}"] = ShapeWithDtype(
                chart.site_counts(l) + (n_children,), dtype
            )
        init = Initializer(
            {k: partial(random_like, primals=v) for k, v in domain.items()}
        )
        super().__init__(domain=domain, init=init)
        self.chart = chart
        self.kernel = kernel
        self.name = name
        device = torch.device(device) if device is not None else config.default_device()
        cov_sqrt0, olfs, kers, grids = self._build_matrices()
        self.register_buffer("cov_sqrt0", cov_sqrt0.to(dtype), persistent=False)
        levels = []
        for l, (olf, ker, grid) in enumerate(zip(olfs, kers, grids)):
            windows = [_window_table(s, chart.coarse_size, n, p) for s, n, p in zip(
                chart.window_starts(l), chart.shapes[l], chart.periodic)]
            levels.append(RefineLevel(chart.shapes[l], windows, (chart.fine_size,) * ndim,
                                      olf.to(dtype), ker.to(dtype), grid))
        self.levels = nn.ModuleList(levels)
        self.to(device)

    # -- host precompute ---------------------------------------------------

    def _varying_axes(self, level: int):
        """Axes along which the refinement matrices differ between sites:
        deformed (irregular) axes, plus axes whose last window was clamped
        to the boundary (non-uniform stride)."""
        chart = self.chart
        starts = chart.window_starts(level)
        out = []
        for a in range(chart.ndim):
            clamped = not _uniform_starts(starts[a])
            if clamped or a in chart.irregular_axes:
                out.append(a)
            if chart.periodic[a] and a in chart.irregular_axes:
                raise ValueError(
                    "periodic axes require a regular (translation-"
                    f"invariant) chart; axis {a} is both periodic and "
                    "irregular"
                )
        return tuple(out)

    def _site_coords(self, level: int, site) -> Tuple[np.ndarray, np.ndarray]:
        """(window, children) Cartesian coordinates of one refinement site.

        Positions of wrapped (periodic) windows use the *unwrapped* index
        continuation so all relative distances stay local.
        """
        chart = self.chart
        ndim = chart.ndim
        csz, fsz = chart.coarse_size, chart.fine_size
        starts = chart.window_starts(level)
        widx = [starts[a][site[a]] + np.arange(csz) for a in range(ndim)]
        fidx = [site[a] * fsz + np.arange(fsz) for a in range(ndim)]
        cw = chart.positions_at(widx, level).reshape(-1, ndim)
        fw = chart.positions_at(fidx, level + 1).reshape(-1, ndim)
        return cw, fw

    def _grid_coords(self, level: int, grid) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`_site_coords` of every site of the grid ``grid`` (sites
        ``0 .. grid[a] - 1`` along each axis) in one chart evaluation:
        ``(prod(grid), csz^d, d)`` and ``(prod(grid), fsz^d, d)``."""
        chart = self.chart
        ndim = chart.ndim
        csz, fsz = chart.coarse_size, chart.fine_size
        starts = chart.window_starts(level)

        def indices(first, size):
            # axis a's index array over (grid axes..., window axes...)
            out = []
            for a in range(ndim):
                shape = [1] * (2 * ndim)
                shape[a], shape[ndim + a] = grid[a], size
                out.append((first(a)[:, None] + np.arange(size)[None, :]).reshape(shape))
            return out

        cw = chart.positions_at(indices(lambda a: starts[a][:grid[a]], csz), level)
        fw = chart.positions_at(indices(lambda a: np.arange(grid[a]) * fsz, fsz), level + 1)
        n = int(np.prod(grid))
        return cw.reshape(n, -1, ndim), fw.reshape(n, -1, ndim)

    def matrices_at(self, level: int, pixel_index, kernel=None):
        """(olf, ker_sqrt) of one refinement site, float64 on the CPU."""
        kernel = self.kernel if kernel is None else kernel
        cw, fw = self._site_coords(level, tuple(pixel_index))
        return refinement_matrices(kernel, torch.from_numpy(cw), torch.from_numpy(fw))

    def _build_matrices(self):
        """The level-0 Cholesky factor and, for each level, ``olf``, ``ker``
        and the matrix grid (the sites along varying axes, 1 along the
        others), float64 on the CPU."""
        chart, kernel = self.chart, self.kernel
        ndim = chart.ndim
        cov_sqrt0 = _cov_sqrt0(kernel, chart.positions(0).reshape(-1, ndim))
        olfs, kers, grids = [], [], []
        for l in range(chart.depth):
            nsites = chart.site_counts(l)
            varying = self._varying_axes(l)
            grid = tuple(nsites[a] if a in varying else 1 for a in range(ndim))
            cws, fws = self._grid_coords(l, grid)
            olf, ker = _batched_matrices(kernel, cws, fws)
            olfs.append(olf.reshape(grid + olf.shape[1:]))
            kers.append(ker.reshape(grid + ker.shape[1:]))
            grids.append(grid)
        return cov_sqrt0, olfs, kers, grids

    def matrices(self):
        """``(cov_sqrt0, olfs, kers)`` as the JAX package's ``_matrices``
        holds them: a level's matrices ``(F, W)`` / ``(F, F)`` where all its
        sites share them, else ``grid + (F, W)`` / ``grid + (F, F)``."""
        olfs, kers = [], []
        for level in self.levels:
            olf, ker = level.matrices()
            if level.n_matrices == 1:
                olf, ker = olf.reshape(level.F, level.W), ker.reshape(level.F, level.F)
            olfs.append(olf)
            kers.append(ker)
        return self.cov_sqrt0, tuple(olfs), tuple(kers)

    # -- forward -----------------------------------------------------------

    def forward(self, x):
        chart = self.chart
        xi0 = x[f"{self.name}0"]
        lead = xi0.shape[:xi0.ndim - chart.ndim]
        field = xi0.reshape(*lead, -1) @ self.cov_sqrt0.mT
        for l, level in enumerate(self.levels):
            xi = x[f"{self.name}{l + 1}"]
            field = refine_level(field, xi.reshape(*lead, -1), level)
        return field.reshape(*lead, *chart.shape)
