"""Mesh parallelism: samples × field over ``torch.distributed``
(counterpart of :mod:`nifty_tpu.parallel.mesh`).

The JAX package places arrays on one global device mesh and lets XLA
insert the collectives.  Here every rank is a process (SPMD): a rank
holds its shards as ordinary tensors, and the collectives sit in a few
named places (:mod:`~nifty_tpu_torch.parallel.collectives`).  A world of
``samples * field`` ranks is laid out with ``field`` innermost, rank
``r = s * field + f``, as the JAX package lays out its mesh:

- ``"samples"``: each rank of a field row holds a contiguous block of the
  antithetic posterior samples (its keys' pairs, in the global
  interleaved order); the KL value, gradient and metric reduce over this
  group;
- ``"field"``: a field-sharded leaf is cut along its first axis into one
  block of rows a rank; the tree reductions, the distributor's adjoint
  and the pencil transforms (:mod:`~nifty_tpu_torch.ops.distributed_fft`)
  communicate over this group.

Which leaves are field-sharded is recorded on the mesh when
:func:`shard_position` places them (the *layout*, by tree structure), and
:mod:`nifty_tpu_torch.tree` reads it while the mesh is active: a slab and
a replicated leaf can have the same shape, so the layout is never guessed
from shapes.  A tree whose structure has no layout fails on a mesh with a
field axis of more than one rank.  With no mesh active every code path is
the single-process one.

Under ``deterministic_reductions`` every reduction across ranks runs in
an order fixed by the global shapes alone (per-row partials gathered,
then folded; samples in :func:`pairwise_sum`'s pairing), so a world of p
ranks gives the bits of a world of one rank.

:func:`make_mesh` with one rank on each axis needs no process group: the
1 × 1 mesh runs the mesh's code paths in a single process.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from .. import tree as _tree
from ..evi import Samples
from ..tree import ShapeWithDtype, Vector, tree_leaves, tree_map, tree_unflatten
from . import collectives as coll

SAMPLES, FIELD = "samples", "field"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, backend: Optional[str] = None,
                           timeout: float = 300.0, local_rank: Optional[int] = None):
    """Join a world (replacing the reference's ``MPI.COMM_WORLD``
    discovery): ``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` (``"host:port"``, or a URL such as
    ``file:///path`` for a rendezvous through a file; ``None``: the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment) with ``num_processes``
    ranks, this one ``process_id``.

    ``backend`` defaults to ``"nccl"`` where the configured device is a
    card and to ``"gloo"`` on the CPU.  With NCCL the rank binds its card,
    ``local_rank`` (default: ``LOCAL_RANK``, else ``process_id`` modulo
    the cards present), and makes it the configured device.  ``timeout``
    (seconds) bounds the rendezvous and every collective: a rank stuck in
    one raises instead of waiting.  Nothing switches backend or device on
    failure."""
    if backend is None:
        backend = "nccl" if torch.device(config.get("device")).type == "cuda" else "gloo"
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
        config.update("device", f"cuda:{local_rank}")
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def _structure(tree):
    """A hashable key of a tree's structure (dict keys, nesting, leaves)."""
    if isinstance(tree, Vector):
        return _structure(tree.tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(_structure(c) for c in tree))
    return "*"


class Mesh:
    """A ``samples × field`` layout of the world; see the module docstring.

    ``group(axis)`` is the process group of this rank's axis (``None``
    for a single-process mesh), ``size(axis)`` its extent and
    ``index(axis)`` this rank's place in it.  ``stats`` counts how the
    sample reductions ran (``"samples subtree"``: each rank reduced its
    rows and only the partials crossed ranks; ``"samples gathered"``: the
    rows themselves were gathered)."""

    def __init__(self, samples: int = 1, field: int = 1, *,
                 sample_axis: str = SAMPLES, field_axis: str = FIELD):
        self.axis_names = (sample_axis, field_axis)
        self.shape = {sample_axis: int(samples), field_axis: int(field)}
        n = int(samples) * int(field)
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            if world != n:
                raise ValueError(f"a {samples} x {field} mesh needs {n} ranks; the world has "
                                 f"{world}")
            # every rank creates every group, in the same order
            field_groups = [dist.new_group([s * field + f for f in range(field)])
                            for s in range(samples)]
            sample_groups = [dist.new_group([s * field + f for s in range(samples)])
                             for f in range(field)]
            s, f = divmod(rank, field)
            self._groups = {sample_axis: sample_groups[f], field_axis: field_groups[s]}
        else:
            if n != 1:
                raise ValueError(f"a {samples} x {field} mesh needs a world of {n} ranks: "
                                 "call initialize_distributed first")
            s = f = 0
            self._groups = {sample_axis: None, field_axis: None}
        self._index = {sample_axis: s, field_axis: f}
        self._layouts = {}
        #: latent keys that a field-sharded model takes as slabs (its
        #: ``_shard_`` names them); empty: the shape rule of
        #: :func:`shard_position` decides
        self.sharded_latents = set()
        #: global shapes of the grids that models placed on the mesh hold
        #: field-sharded (a correlated field's, a line-of-sight response's
        #: input); empty: the shape rule of :meth:`cuts` alone decides
        self.field_grids = set()
        self.stats = Counter()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, axis: str):
        return self._groups[axis]

    @property
    def field_axis(self):
        return self.axis_names[1]

    @property
    def sample_axis(self):
        return self.axis_names[0]

    @property
    def is_root(self) -> bool:
        """Rank 0 of the mesh (prints and writes what is written once)."""
        return all(i == 0 for i in self._index.values())

    # -- activity -----------------------------------------------------------

    def activate(self):
        """Make this the mesh that the tree reductions, the draws and the
        VI stages read (see the module docstring)."""
        _tree._MESH[0] = self
        return self

    def deactivate(self):
        if _tree._MESH[0] is self:
            _tree._MESH[0] = None

    def __enter__(self):
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()

    # -- layout ---------------------------------------------------------------

    def register(self, tree, sharded, global_shapes):
        """Record which leaves of trees structured like ``tree`` are
        field-sharded, and their global shapes."""
        key = _structure(tree)
        entry = tuple(zip(map(bool, sharded), map(tuple, global_shapes)))
        old = self._layouts.get(key)
        if old is not None and tuple(s for s, _ in old) != tuple(s for s, _ in entry):
            raise ValueError("two trees of one structure with different field layouts; "
                             "give them different structures")
        self._layouts[key] = entry

    def layout(self, tree):
        """``[(sharded, global shape), ...]`` a leaf of ``tree``, or
        ``None`` where its structure has no layout."""
        return self._layouts.get(_structure(tree))

    def field_shapes(self) -> set:
        """The global shapes of the field-sharded leaves of every tree whose
        layout the mesh records."""
        return {shape for entry in self._layouts.values() for s, shape in entry if s}

    def field_flags(self, tree, n_leaves: int):
        """Which of ``tree``'s leaves are field-sharded; raises where that
        is unknown and the field axis has more than one rank."""
        entry = self.layout(tree)
        if entry is None:
            if self.size(self.field_axis) > 1:
                raise ValueError(
                    "a tree without a field layout on a field-sharded mesh: place it with "
                    "`shard_position` (its structure is not one the mesh knows)")
            return [False] * n_leaves
        return [s for s, _ in entry]

    def cuts(self, shape, min_ndim: int = 2) -> bool:
        """Whether a data-space leaf of global ``shape`` (data, noise, the
        likelihood's white noise) is field-sharded: it has at least
        ``min_ndim`` dimensions, its first axis divides by the field extent
        and, where models placed on the mesh recorded their grids
        (:attr:`field_grids`), it is one of those.  A response that
        integrates the field (rays, visibilities) keeps its data whole
        whatever its shape, a ``(R, E)`` or ``(R, 3)`` table too."""
        shape = tuple(shape)
        if not _shardable(shape, self.size(self.field_axis), min_ndim):
            return False
        return not self.field_grids or shape in self.field_grids

    def own_rows(self, x, axis: str = FIELD, dim: int = 0):
        """This rank's block of ``x`` along ``dim`` for the mesh axis
        ``axis`` (a copy)."""
        p, i = self.size(axis), self.index(axis)
        n = x.shape[dim]
        if n % p:
            raise ValueError(f"an axis of {n} does not divide among {p} ranks")
        return x.narrow(dim, i * (n // p), n // p).contiguous()


def make_mesh(samples: int = 1, field: int = 1, *, sample_axis: str = SAMPLES,
              field_axis: str = FIELD) -> Mesh:
    """Build a 2-D ``samples × field`` mesh of the world (field innermost:
    a field row's ranks share a host's cards where they can).  Not active
    until :meth:`Mesh.activate` or :func:`shard_position`."""
    return Mesh(samples, field, sample_axis=sample_axis, field_axis=field_axis)


def active_mesh() -> Optional[Mesh]:
    return _tree._MESH[0]


def _shardable(shape, fdim, min_ndim):
    return len(shape) >= min_ndim and shape[0] % fdim == 0


def shard_position(pos, mesh: Mesh, *, field_axis: str = FIELD, min_ndim: int = 2):
    """Place a latent position on the mesh: leaves with at least
    ``min_ndim`` dimensions whose first axis divides by the field extent
    become this rank's block of rows; the rest replicate.  Where a model
    placed on the mesh before named its field-sharded latents (a
    correlated field its excitation), only those of them are cut.  The
    layout is recorded on the mesh and the mesh made active.

    Given a module (a likelihood, a model), every submodule that knows its
    field layout takes its own: a correlated field takes the rows of its
    full-grid index maps, a line-of-sight response its slab of the grid,
    then data and noise trees become their slabs where they are fields
    (:meth:`Mesh.cuts`); the module is changed in place and returned."""
    fdim = mesh.size(field_axis)
    if isinstance(pos, torch.nn.Module):
        hooked = [m for m in pos.modules() if getattr(m, "_shard_", None) is not None]
        # the models first, so that the data's hooks know the mesh's grids
        for m in sorted(hooked, key=lambda m: bool(getattr(m, "_shard_data_", False))):
            m._shard_(mesh, min_ndim=min_ndim)
        mesh.activate()
        return pos
    leaves = tree_leaves(pos)
    sharded = [_shardable(tuple(x.shape), fdim, min_ndim) for x in leaves]
    if mesh.sharded_latents:
        # a model on the mesh named its field's latents: the others (an
        # amplitude spectrum's, say) stay whole whatever their shape
        sharded = [s and k in mesh.sharded_latents for s, k in zip(sharded, _top_keys(pos))]
    out = [mesh.own_rows(x, field_axis) if s and torch.is_tensor(x) else x
           for x, s in zip(leaves, sharded)]
    mesh.register(pos, sharded, [tuple(x.shape) for x in leaves])
    mesh.activate()
    return tree_unflatten(pos, out)


def _top_keys(tree) -> list:
    """Each leaf's top-level dict key (``None`` outside a dict), in flatten
    order."""
    tree = tree.tree if isinstance(tree, Vector) else tree
    if isinstance(tree, dict):
        return [k for k in sorted(tree) for _ in tree_leaves(tree[k])]
    return [None] * len(tree_leaves(tree))


def shard_tree_buffers(tb, mesh: Mesh, min_ndim: int = 2):
    """Field-shard the leaves of a tree held as buffers (data, noise
    diagonals) and record the tree's layout."""
    names = list(tb._buffers)
    leaves = [tb._buffers[k] for k in names]
    sharded = [mesh.cuts(x.shape, min_ndim) for x in leaves]
    mesh.register(tb._like, sharded, [tuple(x.shape) for x in leaves])
    for k, x, s in zip(names, leaves, sharded):
        if s:
            tb._buffers[k] = mesh.own_rows(x, mesh.field_axis)


def sample_rows(mesh: Optional[Mesh], n_rows: int):
    """``(first, count)`` of this rank's block of ``n_rows`` stacked
    samples (all of them without a samples axis)."""
    if mesh is None:
        return 0, n_rows
    p, i = mesh.size(mesh.sample_axis), mesh.index(mesh.sample_axis)
    if n_rows % p:
        raise ValueError(f"{n_rows} sample rows do not divide among {p} ranks of the samples axis")
    return i * (n_rows // p), n_rows // p


def shard_samples(samples: Samples, mesh: Mesh, *, sample_axis: str = SAMPLES,
                  field_axis: str = FIELD) -> Samples:
    """This rank's rows of a :class:`Samples`: a contiguous block of the
    stacked residuals (and the keys of its antithetic pairs), with every
    field-sharded leaf (the position's layout) cut to the rank's slab."""
    pos = shard_position(samples.pos, mesh, field_axis=field_axis) \
        if samples.pos is not None else None
    resid = samples._samples
    keys = samples.keys
    if resid is not None:
        n = len(samples)
        first, count = sample_rows(mesh, n)
        flags = mesh.field_flags(samples.pos, len(tree_leaves(resid))) \
            if samples.pos is not None else [False] * len(tree_leaves(resid))
        leaves = [x.narrow(0, first, count) for x in tree_leaves(resid)]
        leaves = [mesh.own_rows(x, field_axis, dim=1) if s else x.contiguous()
                  for x, s in zip(leaves, flags)]
        resid = tree_unflatten(resid, leaves)
        if keys is not None and len(keys) * 2 == n:
            keys = list(keys)[first // 2:(first + count) // 2]
    mesh.activate()
    return Samples(pos=pos, samples=resid, keys=keys)


def gather_samples(samples: Samples, mesh: Mesh) -> Samples:
    """The global :class:`Samples` on every rank, from each rank's
    (:func:`shard_samples`): the inverse, for checks and checkpoints."""
    pos = gather_position(samples.pos, mesh) if samples.pos is not None else None
    resid = samples._samples
    if resid is not None:
        flags = mesh.field_flags(samples.pos, len(tree_leaves(resid))) \
            if samples.pos is not None else [False] * len(tree_leaves(resid))
        sg, fg = mesh.group(mesh.sample_axis), mesh.group(mesh.field_axis)
        leaves = []
        for x, s in zip(tree_leaves(resid), flags):
            if s:
                x = coll.all_gather(x, fg, dim=1)
            leaves.append(coll.all_gather(x, sg, dim=0))
        resid = tree_unflatten(resid, leaves)
    keys = samples.keys
    if keys is not None:
        keys = [k for part in coll.all_gather_object(list(keys), mesh.group(mesh.sample_axis))
                for k in part]
    return Samples(pos=pos, samples=resid, keys=keys)


def gather_position(pos, mesh: Mesh):
    """A field-sharded tree made whole on every rank."""
    flags = mesh.field_flags(pos, len(tree_leaves(pos)))
    fg = mesh.group(mesh.field_axis)
    return tree_unflatten(pos, [coll.all_gather(x, fg, 0) if s else x
                                for x, s in zip(tree_leaves(pos), flags)])


# -- fixed-order reductions -----------------------------------------------------


def _pairwise_local(x):
    """Even/odd pairing along axis 0, an odd last row carried."""
    n = x.shape[0]
    while n > 1:
        m = n // 2
        x = torch.cat([x[0:2 * m:2] + x[1:2 * m:2], x[2 * m:]], dim=0)
        n = x.shape[0]
    return x[0]


def _mesh_group(mesh, mesh_axis):
    if mesh is None:
        return None, 1
    return mesh.group(mesh_axis), mesh.size(mesh_axis)


def pairwise_sum(x, axis: int = 0, *, mesh: Optional[Mesh] = None,
                 mesh_axis: str = SAMPLES):
    """Fixed-order binary-tree reduction along ``axis``: rows paired even
    with odd, level by level, an odd last row carried.  The order is a
    function of the global length only, never of the world, so results
    are bitwise reproducible across world sizes (the reference's
    deterministic MPI allreduce).

    Given a ``mesh`` whose ``mesh_axis`` has more than one rank, ``x`` is
    this rank's contiguous block of the rows and the result the global
    reduction, on every rank: where a rank's rows form a whole subtree of
    the pairing (a power-of-two count of them) each rank reduces its own
    and only the partials cross ranks, else the rows are gathered."""
    x = x.movedim(axis, 0)
    group, p = _mesh_group(mesh, mesh_axis)
    if group is None:
        return _pairwise_local(x)
    k = x.shape[0]
    if k & (k - 1) == 0:
        mesh.stats["samples subtree"] += 1
        parts = coll.GatherAcross.apply(_pairwise_local(x)[None], group, 0)
    else:
        mesh.stats["samples gathered"] += 1
        parts = coll.GatherAcross.apply(x.contiguous(), group, 0)
    return _pairwise_local(parts)


def _global_rows(x, axis, mesh, mesh_axis):
    _, p = _mesh_group(mesh, mesh_axis)
    return x.shape[axis] * p


def pairwise_mean(x, axis: int = 0, *, mesh: Optional[Mesh] = None,
                  mesh_axis: str = SAMPLES):
    return pairwise_sum(x, axis, mesh=mesh, mesh_axis=mesh_axis) / _global_rows(
        x, axis, mesh, mesh_axis)


def tree_pairwise_mean(tree, axis: int = 0, *, mesh: Optional[Mesh] = None,
                       mesh_axis: str = SAMPLES):
    """Deterministic sample-mean of every leaf (the ``kl_reduce`` of
    ``deterministic_reductions``).  Across ranks, one collective serves
    every leaf of one dtype."""
    group, p = _mesh_group(mesh, mesh_axis)
    if group is None:
        return tree_map(lambda x: pairwise_mean(x, axis), tree)
    leaves = [x.movedim(axis, 0) for x in tree_leaves(tree)]
    k = leaves[0].shape[0]
    n = k * p
    subtree = k & (k - 1) == 0
    mesh.stats["samples subtree" if subtree else "samples gathered"] += 1
    rows = [_pairwise_local(x)[None] if subtree else x for x in leaves]
    out = [None] * len(rows)
    for dtype in dict.fromkeys(r.dtype for r in rows):
        idx = [i for i, r in enumerate(rows) if r.dtype == dtype]
        flat = torch.cat([rows[i].reshape(rows[i].shape[0], -1) for i in idx], dim=1)
        got = coll.GatherAcross.apply(flat.contiguous(), group, 0)
        at = 0
        for i in idx:
            w = rows[i][0].numel()
            part = got[:, at:at + w].reshape((got.shape[0],) + tuple(rows[i].shape[1:]))
            out[i] = _pairwise_local(part) / n
            at += w
    return tree_unflatten(tree, out)


def tree_mean(tree, axis: int = 0, *, mesh: Optional[Mesh] = None,
              mesh_axis: str = SAMPLES):
    """Plain sample-mean of every leaf; across ranks the local sums are
    all-reduced (one collective for every leaf of one dtype)."""
    group, p = _mesh_group(mesh, mesh_axis)
    if group is None:
        return tree_map(lambda x: x.mean(dim=axis), tree)
    sums = [x.sum(dim=axis) for x in tree_leaves(tree)]
    n = tree_leaves(tree)[0].shape[axis] * p
    out = [None] * len(sums)
    for dtype in dict.fromkeys(s.dtype for s in sums):
        idx = [i for i, s in enumerate(sums) if s.dtype == dtype]
        flat = torch.cat([sums[i].reshape(-1) for i in idx])
        got = coll.SumAcross.apply(flat, group)
        at = 0
        for i in idx:
            w = sums[i].numel()
            out[i] = got[at:at + w].reshape(sums[i].shape) / n
            at += w
    return tree_unflatten(tree, out)


__all__ = [
    "Mesh", "active_mesh", "gather_position", "gather_samples", "initialize_distributed",
    "make_mesh", "pairwise_mean", "pairwise_sum", "sample_rows", "shard_position",
    "shard_samples", "shard_tree_buffers", "tree_mean", "tree_pairwise_mean",
]
