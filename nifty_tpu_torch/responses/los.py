"""Line-of-sight (tomography) response (counterpart of
:mod:`nifty_tpu.responses.los`).

Each ray is integrated by sampling the field at ``n_sampling_points``
equidistant points with multilinear (or nearest-cell) interpolation and
summing.  The JAX package maps coordinates per ray with XLA gathers; here
the host builds the rays' cell and weight tables once
(:func:`~nifty_tpu_torch.ops.los_interp.los_tables`, with the JAX package's
arithmetic) and the ray integral and its adjoint are the hand-written
kernel pair K11 (:mod:`nifty_tpu_torch.ops.los_interp`).

On a mesh whose field axis shards the grid along its first axis
(:func:`~nifty_tpu_torch.parallel.shard_position` calls :meth:`_shard_`),
a rank integrates its slab of rows (:class:`~nifty_tpu_torch.ops.los_interp.
LosSlab`) and the rays' values, data and noise stay whole on every rank.
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
    type at its first call.  Placed on a field-sharded mesh it takes this
    rank's slabs ``(..., shape[0] / p, *shape[1:])`` and returns the whole
    ray values, the same on every rank of the field group.
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
        # on a field-sharded mesh (`_shard_`): the mesh, this rank's rows of
        # the first axis and the slab tables by dtype
        self.field_mesh = None
        self.slabs = nn.ModuleDict()

    def _host_tables(self, dtype):
        if dtype not in _NP:
            raise TypeError(f"fields must be float32 or float64; got {dtype}")
        return los_interp.los_tables(self.start, self.end, self._shape, self.distances,
                                     self._n_sampling_points, self._order, _NP[dtype])

    def _table_device(self):
        return next(iter(self.tables.values())).idx.device if self.tables else self._device

    def table(self, dtype) -> los_interp.LosTable:
        """The ray tables for fields of ``dtype``, built on the host at first
        use and kept beside the others (on the device of those built
        before, or the one given at construction)."""
        name = str(dtype).replace("torch.", "")
        if name not in self.tables:
            idx, w, scale, nan_rays = self._host_tables(dtype)
            device = self._table_device()
            self.tables[name] = los_interp.LosTable(idx, w, scale, self._shape, nan_rays).to(device)
        return self.tables[name]

    def _shard_(self, mesh, min_ndim=2):
        """Take this rank's rows of the grid's first axis on ``mesh``'s field
        axis: the ray integral runs on the rank's slab and reduces over the
        field group (:func:`~nifty_tpu_torch.ops.los_interp.integrate_slab`);
        the ray values stay whole on every rank, so the data and the noise
        are never cut (the grid's shape, not the rays', is the mesh's field
        output)."""
        if self.field_mesh is not None:
            return
        p, f = mesh.size(mesh.field_axis), mesh.index(mesh.field_axis)
        n0 = self._shape[0]
        if n0 % p:
            raise ValueError(f"the grid's first axis ({n0}) does not divide among {p} ranks")
        self._rows = (f * (n0 // p), (f + 1) * (n0 // p))
        self.field_mesh = mesh
        mesh.field_grids.add(self._shape)
        for name in list(self.tables):
            self.slab(getattr(torch, name))

    def slab_tables(self, rows, dtype) -> los_interp.LosSlab:
        """The slab tables of rows ``[r0, r1)`` of the grid's first axis
        for fields of ``dtype``, built on the host, on the device of the
        tables."""
        idx, w, scale, nan_rays = self._host_tables(dtype)
        return los_interp.LosSlab(idx, w, scale, self._shape, rows,
                                  nan_rays).to(self._table_device())

    def slab(self, dtype) -> los_interp.LosSlab:
        """This rank's slab tables for fields of ``dtype`` on the mesh
        (built at first use)."""
        if self.field_mesh is None:
            raise ValueError("the response is not on a mesh: `shard_position` places it")
        name = str(dtype).replace("torch.", "")
        if name not in self.slabs:
            self.slabs[name] = self.slab_tables(self._rows, dtype)
        return self.slabs[name]

    def forward(self, x):
        mesh = self.field_mesh
        if mesh is None:
            return los_interp.integrate(x, self.table(x.dtype))
        return los_interp.integrate_slab(x, self.slab(x.dtype), mesh.group(mesh.field_axis),
                                         bool(config.get("deterministic_reductions")))
