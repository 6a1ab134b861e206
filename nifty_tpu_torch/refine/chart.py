"""Coordinate charts for iterative refinement (counterpart of
:mod:`nifty_tpu.refine.chart`, of which this is a copy: the port imports
nothing of the JAX package).

A chart maps refinement-level grid indices to Cartesian (modeling)
coordinates; refinement matrices are then built from the *true* distances
between charted points, so arbitrarily deformed/curved grids get a
correctly adapted GP prior.

Geometry is fully general: each refinement conditions ``fine_size^d``
children on a sliding window of ``coarse_size^d`` coarse pixels, with two
placement strategies —

- ``"extend"``: windows slide by ``fine_size/2`` coarse pixels and the
  children tile half a coarse volume each (the classic halving refinement
  for ``coarse_size=3, fine_size=2``);
- ``"jump"``: windows slide by one coarse pixel and all children live
  inside the centermost coarse pixel (spacing ``1/fine_size``).

Axes can have different extents per level (irregular level shapes fall out
of the shape algebra), can be declared ``periodic`` (windows wrap), and can
be declared regular/irregular for matrix deduplication on deformed charts.

Everything here is host numpy: a ``nonlinear_map`` receives and returns
numpy arrays.
"""

from __future__ import annotations

from math import ceil
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np


def _per_axis(val, ndim, cast=float):
    if val is None:
        return None
    if np.isscalar(val):
        return (cast(val),) * ndim
    out = tuple(cast(v) for v in val)
    if len(out) != ndim:
        raise ValueError(f"expected {ndim} per-axis entries; got {val!r}")
    return out


def _site_count(n: int, csz: int, step: int, periodic: bool) -> int:
    """Number of refinement windows along one axis of extent ``n``."""
    if periodic:
        if n % step != 0:
            raise ValueError(
                f"periodic axis of size {n} not divisible by window "
                f"stride {step}"
            )
        return n // step
    free = n - csz + 1
    if free <= 0:
        raise ValueError(
            f"axis of size {n} too small for a {csz}-wide window"
        )
    return ceil(free / step)


def coarse2fine_shape(
    shape0: Union[int, Sequence[int]],
    depth: int,
    *,
    coarse_size: int = 3,
    fine_size: int = 2,
    fine_strategy: str = "extend",
    periodic: Union[bool, Sequence[bool]] = False,
):
    """Shape after ``depth`` refinements of a ``shape0`` grid."""
    shape0 = (shape0,) if isinstance(shape0, int) else tuple(shape0)
    per = _per_axis(periodic, len(shape0), bool) or (False,) * len(shape0)
    step = 1 if fine_strategy == "jump" else fine_size // 2
    if fine_strategy not in ("jump", "extend"):
        raise ValueError(f"invalid `fine_strategy`; got {fine_strategy!r}")
    if fine_size % 2 != 0:
        raise ValueError("`fine_size` must be even")
    shp = list(shape0)
    for _ in range(depth):
        shp = [
            fine_size * _site_count(n, coarse_size, step, p)
            for n, p in zip(shp, per)
        ]
    return tuple(shp)


def fine2coarse_shape(
    shape: Union[int, Sequence[int]],
    depth: int,
    *,
    coarse_size: int = 3,
    fine_size: int = 2,
    fine_strategy: str = "extend",
    ceil_sizes: bool = False,
):
    """Smallest ``shape0`` whose ``depth``-fold refinement covers ``shape``
    (per axis)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    step = 1 if fine_strategy == "jump" else fine_size // 2
    out = []
    for target in shape:
        n = target
        for _ in range(depth):
            # smallest n with fine_size * ceil((n - csz + 1) / step) >= n_fine
            nsites = ceil(n / fine_size)
            n = (nsites - 1) * step + coarse_size
        out.append(int(n))
    del ceil_sizes  # the closed form is already minimal-integral
    return tuple(out)


def coarse2fine_distances(distances0, depth: int, *, fine_size: int = 2,
                          fine_strategy: str = "extend"):
    """Pixel spacings after ``depth`` refinements."""
    shrink = fine_size if fine_strategy == "jump" else 2
    return np.atleast_1d(np.asarray(distances0, dtype=float)) / shrink ** depth


def fine2coarse_distances(distances, depth: int, *, fine_size: int = 2,
                          fine_strategy: str = "extend"):
    """Level-0 pixel spacings given final-level spacings."""
    shrink = fine_size if fine_strategy == "jump" else 2
    return np.atleast_1d(np.asarray(distances, dtype=float)) * shrink ** depth


class CoordinateChart:
    """Refinement chart: grid metadata + (optionally nonlinear) coordinates.

    Parameters
    ----------
    shape0 : int or tuple of int
        Shape of the coarsest grid.
    depth : int
        Number of refinement levels.
    distances0 : float or tuple of float
        Level-0 pixel spacings (in chart input units).
    nonlinear_map : callable, optional
        Map from regular coordinates (fractional level-0 index × distances0)
        to Cartesian modeling coordinates; identity when None.  Input/output
        are arrays of shape (*grid_shape, ndim).
    coarse_size, fine_size, fine_strategy :
        Refinement stencil (see module docstring).
    periodic : bool or tuple of bool
        Axes on which refinement windows wrap around.
    regular_axes / irregular_axes : tuple of int, optional
        On a deformed chart, axes along which the deformation is
        translation-invariant ("regular"): refinement matrices are computed
        once per irregular-site and broadcast along regular axes.  With no
        ``nonlinear_map`` every axis is regular.
    """

    def __init__(
        self,
        shape0: Union[int, Sequence[int]] = None,
        depth: int = 3,
        distances0: Union[float, Sequence[float], None] = None,
        nonlinear_map: Optional[Callable] = None,
        *,
        min_shape: Union[int, Sequence[int], None] = None,
        distances: Union[float, Sequence[float], None] = None,
        coarse_size: int = 3,
        fine_size: int = 2,
        fine_strategy: str = "extend",
        periodic: Union[bool, Sequence[bool]] = False,
        regular_axes: Optional[Sequence[int]] = None,
        irregular_axes: Optional[Sequence[int]] = None,
    ):
        if fine_strategy not in ("jump", "extend"):
            raise ValueError(f"invalid `fine_strategy`; got {fine_strategy!r}")
        if fine_size % 2 != 0:
            raise ValueError("`fine_size` must be even")
        self.coarse_size = int(coarse_size)
        self.fine_size = int(fine_size)
        self.fine_strategy = str(fine_strategy)
        self.depth = int(depth)

        if shape0 is None:
            if min_shape is None:
                raise ValueError("specify `shape0` or `min_shape`")
            shape0 = fine2coarse_shape(
                min_shape, self.depth, coarse_size=self.coarse_size,
                fine_size=self.fine_size, fine_strategy=self.fine_strategy,
                ceil_sizes=True,
            )
        self.shape0 = (
            (int(shape0),) if np.isscalar(shape0)
            else tuple(int(s) for s in shape0)
        )
        self.ndim = len(self.shape0)
        self.periodic = (
            _per_axis(periodic, self.ndim, bool) or (False,) * self.ndim
        )

        if distances0 is None and distances is not None:
            distances0 = fine2coarse_distances(
                distances, self.depth, fine_size=self.fine_size,
                fine_strategy=self.fine_strategy,
            )
        if distances0 is None:
            distances0 = (1.0,) * self.ndim
        self.distances0 = _per_axis(distances0, self.ndim)
        self.distances = tuple(coarse2fine_distances(
            self.distances0, self.depth, fine_size=self.fine_size,
            fine_strategy=self.fine_strategy,
        ))
        self.nonlinear_map = nonlinear_map

        if regular_axes is None and irregular_axes is not None:
            regular_axes = tuple(
                a for a in range(self.ndim) if a not in set(irregular_axes)
            )
        if regular_axes is None:
            regular_axes = (
                tuple(range(self.ndim)) if nonlinear_map is None else ()
            )
        self.regular_axes = tuple(int(a) for a in regular_axes)
        self.irregular_axes = tuple(
            a for a in range(self.ndim) if a not in set(self.regular_axes)
        )

        # Grid shapes per level.
        shapes = [self.shape0]
        for _ in range(self.depth):
            shapes.append(coarse2fine_shape(
                shapes[-1], 1, coarse_size=self.coarse_size,
                fine_size=self.fine_size, fine_strategy=self.fine_strategy,
                periodic=self.periodic,
            ))
        self.shapes = tuple(shapes)

    @property
    def shape(self):
        """Shape at the final refinement level."""
        return self.shapes[-1]

    @property
    def window_stride(self) -> int:
        return 1 if self.fine_strategy == "jump" else self.fine_size // 2

    # -- index algebra ------------------------------------------------------

    def site_counts(self, level: int) -> Tuple[int, ...]:
        """Refinement windows per axis when refining ``level -> level+1``."""
        return tuple(
            _site_count(n, self.coarse_size, self.window_stride, p)
            for n, p in zip(self.shapes[level], self.periodic)
        )

    def window_starts(self, level: int):
        """Per-axis window start indices (into the ``level`` grid); the last
        non-periodic window is clamped so it never overruns the axis."""
        csz, step = self.coarse_size, self.window_stride
        out = []
        for n, p, ns in zip(
            self.shapes[level], self.periodic, self.site_counts(level)
        ):
            starts = np.arange(ns) * step
            if not p:
                starts = np.minimum(starts, n - csz)
            out.append(starts)
        return out

    def rgoffset(self, level: int) -> Tuple[float, ...]:
        """Level-0 fractional index of pixel 0 at ``level`` (pixel indices
        denote pixel centers; level-0 pixel 0 sits at 0)."""
        csz, fsz = self.coarse_size, self.fine_size
        if self.fine_strategy == "jump":
            lm0 = (csz - 1) / 2 - 0.5 + 0.5 / fsz
            geo = (1.0 - fsz ** -level) / (1.0 - 1.0 / fsz)
        else:
            lm0 = (csz - 1) / 2 - 0.25 * (fsz - 1)
            geo = (1.0 - 2.0 ** -level) * 2.0
        return (lm0 * geo,) * self.ndim

    def _dvol(self, level: int) -> float:
        """Pixel spacing at ``level`` in level-0 index units."""
        shrink = self.fine_size if self.fine_strategy == "jump" else 2
        return shrink ** -level

    def ind2rg(self, indices, level: int):
        """Pixel indices at ``level`` → continuous level-0 fractional
        coordinates (per-axis iterable in, per-axis tuple out)."""
        off = self.rgoffset(level)
        dvol = self._dvol(level)
        return tuple(o + np.asarray(i) * dvol for o, i in zip(off, indices))

    def rg2ind(self, positions, level: int, discretize: bool = True):
        """Continuous level-0 fractional coordinates → pixel indices at
        ``level``."""
        off = self.rgoffset(level)
        dvol = self._dvol(level)
        idx = tuple((np.asarray(p) - o) / dvol for o, p in zip(off, positions))
        if discretize:
            idx = tuple(np.rint(i).astype(np.int64) for i in idx)
        return idx

    def level_indices(self, level: int):
        """Fractional level-0 indices of all pixels at ``level`` (per
        axis)."""
        return [
            np.asarray(x, dtype=np.float64)
            for x in self.ind2rg(
                [np.arange(n) for n in self.shapes[level]], level
            )
        ]

    # -- coordinates ---------------------------------------------------------

    def rg2cart(self, reg: np.ndarray) -> np.ndarray:
        """Regular (index × distances0) coordinates → Cartesian modeling
        coordinates; ``reg`` has shape (..., ndim)."""
        if self.nonlinear_map is not None:
            return np.asarray(self.nonlinear_map(reg))
        return reg

    def positions_at(self, indices, level: int) -> np.ndarray:
        """Cartesian coordinates of (fractional) per-axis ``indices`` at
        ``level``; returns shape (*broadcast(indices), ndim)."""
        rg = self.ind2rg(indices, level)
        mesh = np.meshgrid(*rg, indexing="ij") if all(
            np.ndim(r) == 1 for r in rg
        ) else list(np.broadcast_arrays(*rg))
        reg = np.stack(
            [m * d for m, d in zip(mesh, self.distances0)], axis=-1
        )
        return self.rg2cart(reg)

    def positions(self, level: int) -> np.ndarray:
        """Cartesian coordinates of all pixels at ``level``;
        shape (*shapes[level], ndim)."""
        return self.positions_at(
            [np.arange(n) for n in self.shapes[level]], level
        )

    def is_regular(self) -> bool:
        return self.nonlinear_map is None
