"""Iterative refinement GP on the HEALPix sphere (counterpart of
:mod:`nifty_tpu.refine.healpix_field`).

Level ``l`` is a HEALPix grid at ``nside0 · 2^l`` (nested scheme); each
coarse pixel conditions its four nested children on itself plus its 8
neighbours (window of 9; a pixel with 7 neighbours names itself in place
of the missing one).  Pixel coordinates are unit vectors from the HEALPix
core (:mod:`nifty_tpu_torch.ops.healpix`); isotropic kernels act on the
chordal distance.  With a radial chart the field lives on sphere × radius
(radial window 3, radial children 2: a 27-point window, 8 children), the
geometry of 3-D dust maps.

Each level is a :class:`~nifty_tpu_torch.ops.icr_refine.RefineLevel` with
the neighbour table as its angular window table and one matrix pair a
site, so the level step is the CUDA kernel K9 on the card and the gather /
einsum route on the CPU.  The matrices are host precompute in float64 on
the CPU, with the user's ``kernel`` given torch tensors.  Latents may
carry leading batch axes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import config
from ..model import Initializer, Model
from ..ops import healpix as hpx
from ..ops.icr_refine import RefineLevel, refine_level
from ..tree import ShapeWithDtype, random_like
from .charted_field import _batched_matrices, _cov_sqrt0


class HEALPixChart:
    """Refinement chart on the sphere (optionally × a radial axis).

    Angular resolution doubles per level (nested children); with
    ``radial_chart`` (a 1-D :class:`~nifty_tpu_torch.refine.chart
    .CoordinateChart`) the field lives on sphere × radius and both axes
    refine simultaneously.
    """

    def __init__(self, nside0: int, depth: int, radial_chart=None):
        self.nside0 = int(nside0)
        self.depth = int(depth)
        self.nsides = tuple(self.nside0 * 2 ** l for l in range(depth + 1))
        self.radial_chart = radial_chart
        if radial_chart is None:
            self.shapes = tuple((hpx.npix(ns),) for ns in self.nsides)
        else:
            if radial_chart.ndim != 1 or radial_chart.depth != self.depth:
                raise ValueError(
                    "radial chart must be 1-D with matching depth"
                )
            self.shapes = tuple(
                (hpx.npix(ns), radial_chart.shapes[l][0])
                for l, ns in enumerate(self.nsides)
            )

    def angular_positions(self, level: int) -> np.ndarray:
        ns = self.nsides[level]
        return hpx.pix2vec(ns, np.arange(hpx.npix(ns)), nest=True)

    def positions(self, level: int) -> np.ndarray:
        """Cartesian positions; (npix, 3) or (npix, nr, 3) with radius."""
        vec = self.angular_positions(level)
        if self.radial_chart is None:
            return vec
        r = self.radial_chart.positions(level)[:, 0]  # (nr,)
        return vec[:, None, :] * r[None, :, None]

    def neighbor_windows(self, level: int) -> np.ndarray:
        """(npix, 9) nested indices: pixel + 8 neighbours (-1 → self)."""
        ns = self.nsides[level]
        pix = np.arange(hpx.npix(ns))
        nb = hpx.neighbours_nest(ns, pix)
        win = np.concatenate([pix[:, None], nb], axis=1)
        # missing corner neighbours: repeat the centre (degenerate column,
        # regularized away by the jitter in the matrix build)
        return np.where(win < 0, pix[:, None], win)


class RefinementHPField(Model):
    """GP field on the HEALPix sphere via iterative refinement.

    Parameters
    ----------
    chart : HEALPixChart or int
        Chart (or ``nside0`` convenience combined with ``depth``).
    kernel : callable
        Isotropic covariance as a function of *chordal* distance (a float64
        torch tensor).
    dtype, device :
        Of the latents and matrices (default float64) and of the buffers
        (default: the configured device, the card).
    """

    def __init__(self, chart, kernel: Optional[Callable] = None, *,
                 depth: Optional[int] = None, name: str = "xi", dtype=None, device=None):
        if not isinstance(chart, HEALPixChart):
            chart = HEALPixChart(chart, depth if depth is not None else 2)
        dtype = dtype if dtype is not None else config.default_float_dtype()
        domain = {f"{name}0": ShapeWithDtype(chart.shapes[0], dtype)}
        for l in range(chart.depth):
            npix_l = chart.shapes[l][0]
            if chart.radial_chart is None:
                exc_shape = (npix_l, 4)
            else:
                nr_int = chart.shapes[l][1] - 2
                exc_shape = (npix_l, nr_int, 8)
            domain[f"{name}{l + 1}"] = ShapeWithDtype(exc_shape, dtype)
        init = Initializer(
            {k: partial(random_like, primals=v) for k, v in domain.items()}
        )
        super().__init__(domain=domain, init=init)
        self.chart = chart
        self.kernel = kernel
        self.name = name
        device = torch.device(device) if device is not None else config.default_device()
        build = (self._build_matrices_sphere if chart.radial_chart is None
                 else self._build_matrices_radial)
        cov_sqrt0, olfs, kers, windows = build()
        self.register_buffer("cov_sqrt0", cov_sqrt0.to(dtype), persistent=False)
        levels = []
        for l, (olf, ker, win) in enumerate(zip(olfs, kers, windows)):
            npix_l = chart.shapes[l][0]
            if chart.radial_chart is None:
                levels.append(RefineLevel((npix_l,), [win], (4,), olf.to(dtype), ker.to(dtype),
                                          (npix_l,)))
            else:
                nr = chart.shapes[l][1]
                radial = np.arange(nr - 2)[:, None] + np.arange(3)[None, :]
                levels.append(RefineLevel((npix_l, nr), [win, radial], (4, 2), olf.to(dtype),
                                          ker.to(dtype), (npix_l, nr - 2)))
        self.levels = nn.ModuleList(levels)
        self.to(device)

    def _build_matrices_sphere(self):
        chart, kernel = self.chart, self.kernel
        cov_sqrt0 = _cov_sqrt0(kernel, chart.positions(0))
        olfs, kers, windows = [], [], []
        for l in range(chart.depth):
            coarse_pos = chart.positions(l)
            fine_pos = chart.positions(l + 1)
            win = chart.neighbor_windows(l)
            npix_l = win.shape[0]
            children = 4 * np.arange(npix_l)[:, None] + np.arange(4)[None, :]
            olf, ker = _batched_matrices(kernel, coarse_pos[win], fine_pos[children])
            olfs.append(olf)
            kers.append(ker)
            windows.append(win)
        return cov_sqrt0, olfs, kers, windows

    def _build_matrices_radial(self):
        chart, kernel = self.chart, self.kernel
        cov_sqrt0 = _cov_sqrt0(kernel, chart.positions(0).reshape(-1, 3))
        olfs, kers, windows = [], [], []
        for l in range(chart.depth):
            coarse_pos = chart.positions(l)      # (npix, nr, 3)
            fine_pos = chart.positions(l + 1)    # (4 npix, 2(nr-2), 3)
            win = chart.neighbor_windows(l)      # (npix, 9)
            npix_l, nr = chart.shapes[l]
            nr_int = nr - 2
            # coarse window coords per (pixel, radial site): 9 x 3 = 27
            ang = coarse_pos[win]                # (npix, 9, nr, 3)
            cws = np.stack(
                [ang[:, :, q:q + 3, :] for q in range(nr_int)], axis=1
            ).reshape(npix_l * nr_int, 27, 3)
            # fine children coords: 4 angular x 2 radial = 8
            children_ang = 4 * np.arange(npix_l)[:, None] + np.arange(4)
            fws = fine_pos[children_ang]         # (npix, 4, 2(nr-2), 3)
            fws = np.stack(
                [fws[:, :, 2 * q:2 * q + 2, :] for q in range(nr_int)], axis=1
            ).reshape(npix_l * nr_int, 8, 3)
            olf, ker = _batched_matrices(kernel, cws, fws)
            olfs.append(olf.reshape(npix_l, nr_int, 8, 27))
            kers.append(ker.reshape(npix_l, nr_int, 8, 8))
            windows.append(win)
        return cov_sqrt0, olfs, kers, windows

    def matrices(self):
        """``(cov_sqrt0, olfs, kers, windows)`` as the JAX package's
        ``_matrices`` holds them (the windows as int32 tensors)."""
        mats = [level.matrices() for level in self.levels]
        return (self.cov_sqrt0, tuple(m[0] for m in mats), tuple(m[1] for m in mats),
                tuple(level.window0 for level in self.levels))

    def forward(self, x):
        shape0 = self.chart.shapes[0]
        xi0 = x[f"{self.name}0"]
        lead = xi0.shape[:xi0.ndim - len(shape0)]
        field = xi0.reshape(*lead, -1) @ self.cov_sqrt0.mT
        for l, level in enumerate(self.levels):
            xi = x[f"{self.name}{l + 1}"]
            field = refine_level(field, xi.reshape(*lead, -1), level)
        return field.reshape(*lead, *self.chart.shapes[-1])
