"""Line-of-sight (tomography) response (counterpart of
:mod:`nifty_tpu.responses.los`).

Each ray is integrated by sampling the field at ``n_sampling_points``
equidistant points with multilinear (or nearest-cell) interpolation and
summing.  The JAX package maps coordinates per ray with XLA gathers; here
the host builds the rays' cell and weight tables once
(:func:`~nifty_tpu_torch.ops.los_interp.los_tables`, with the JAX package's
arithmetic) and the ray integral and its adjoint are the hand-written
kernel pair K11 (:mod:`nifty_tpu_torch.ops.los_interp`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import config
from ..model import Model
from ..ops import los_interp
from ..tree import ShapeWithDtype

_NP = {torch.float32: np.float32, torch.float64: np.float64}


class SamplingCartesianGridLOS(Model):
    """Line-of-sight integrals over a regular Cartesian grid.

    Parameters
    ----------
    start, end : array (n_rays, ndim) or (ndim,)
        Ray endpoints in world coordinates (broadcast against each other).
    shape : tuple
        Grid shape of the input field.
    distances : tuple of float
        Pixel sizes per axis.
    n_sampling_points : int
        Samples per ray.
    interpolation_order : int
        0 (nearest) or 1 (multilinear).
    device : the device of the ray tables; the configured one by default
        (``.to()`` moves them).

    The model takes fields ``(..., *shape)`` with any leading batch axes and
    returns ``(..., n_rays)``.  A ray with a sampling point whose cell has a
    corner outside the grid is NaN, as in the JAX package.  The tables of
    the domain's dtype are built at construction; those of another float
    type at its first call.
    """

    def __init__(self, start, end, *, shape, distances, n_sampling_points: int = 500,
                 interpolation_order: int = 1, dtype=None, device=None):
        start, end = np.atleast_2d(np.asarray(start)), np.atleast_2d(np.asarray(end))
        shape = tuple(int(n) for n in shape)
        n_rays = max(start.shape[0], end.shape[0])
        domain = ShapeWithDtype(shape, dtype)
        super().__init__(domain=domain, target=ShapeWithDtype((n_rays,), dtype))
        self.start, self.end = start, end
        self.distances = np.asarray(distances)
        self._shape = shape
        self._n_sampling_points = int(n_sampling_points)
        self._order = int(interpolation_order)
        self.tables = nn.ModuleDict()
        self._device = config.default_device() if device is None else torch.device(device)
        self.table(domain.dtype)

    def table(self, dtype) -> los_interp.LosTable:
        """The ray tables for fields of ``dtype``, built on the host at first
        use and kept beside the others (on the device of those built
        before, or the one given at construction)."""
        name = str(dtype).replace("torch.", "")
        if name not in self.tables:
            if dtype not in _NP:
                raise TypeError(f"fields must be float32 or float64; got {dtype}")
            idx, w, scale, nan_rays = los_interp.los_tables(
                self.start, self.end, self._shape, self.distances, self._n_sampling_points,
                self._order, _NP[dtype])
            device = next(iter(self.tables.values())).idx.device if self.tables else self._device
            self.tables[name] = los_interp.LosTable(idx, w, scale, self._shape, nan_rays).to(device)
        return self.tables[name]

    def forward(self, x):
        return los_interp.integrate(x, self.table(x.dtype))
