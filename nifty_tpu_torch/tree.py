"""Trees of tensors as vectors (counterpart of :mod:`nifty_tpu.tree`).

Latent positions, samples and data are plain trees: dicts (iterated in
sorted key order, as JAX flattens them), lists, tuples, :class:`Vector`
and ``None`` as an empty node, with ``torch.Tensor`` leaves.  All vector
operations (dot products, norms, axpy) walk those trees.

Randomness has no global state.  Every draw takes its white noise from
an explicit *key*:

- an ``int`` seed: a ``torch.Generator`` on the target device seeded with
  it (the stream then depends on the device type);
- a ``torch.Generator``, drawn from in place;
- a *noise provider*, any object with ``split(num)`` and
  ``normal(primals, device=None)`` methods; :class:`HostKey` is one that
  draws on the host, so a run on the card and one on the CPU see the same
  numbers, and the parity tests inject the noise the JAX package drew
  through the same interface.

:func:`split` derives sub-keys the way ``jax.random.split`` does for the
JAX package, so the two packages take their noise at the same places.
"""

from __future__ import annotations

import operator
from typing import Callable

import numpy as np
import torch

from . import config

#: The active mesh (:mod:`nifty_tpu_torch.parallel.mesh`), or ``None``:
#: set by ``Mesh.activate``; the reductions and draws below read it.
_MESH = [None]

# --------------------------------------------------------------------------
# Shape/dtype descriptors
# --------------------------------------------------------------------------


class ShapeWithDtype:
    """Shape+dtype leaf descriptor; dtype defaults to the port's float."""

    def __init__(self, shape=(), dtype=None):
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype if dtype is not None else config.default_float_dtype()

    @classmethod
    def from_leave(cls, element):
        return cls(tuple(element.shape), element.dtype)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def ndim(self):
        return len(self.shape)

    def __eq__(self, other):
        return (
            isinstance(other, ShapeWithDtype)
            and self.shape == other.shape and self.dtype == other.dtype
        )

    def __hash__(self):
        return hash((self.shape, self.dtype))

    def __repr__(self):
        return f"ShapeWithDtype(shape={self.shape}, dtype={self.dtype})"


def shape_dtype_like(tree):
    """Map a tree of tensors to a tree of :class:`ShapeWithDtype`."""
    return tree_map(ShapeWithDtype.from_leave, tree)


# --------------------------------------------------------------------------
# Tree walking
# --------------------------------------------------------------------------


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """Leaves in flatten order (dict keys sorted, like ``jax.tree_util``)."""
    if tree is None:
        return []
    if isinstance(tree, Vector):
        return tree_leaves(tree.tree)
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for c in tree for leaf in tree_leaves(c)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over congruent trees."""
    if tree is None:
        return None
    if isinstance(tree, Vector):
        rest = tuple(r.tree if isinstance(r, Vector) else r for r in rest)
        return Vector(tree_map(fn, tree.tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)
        ))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """Rebuild a tree shaped like ``like`` from ``leaves`` in flatten order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# --------------------------------------------------------------------------
# Vector wrapper
# --------------------------------------------------------------------------

CORE_ARITHMETIC_ATTRIBUTES = (
    "__neg__", "__pos__", "__abs__", "__add__", "__radd__", "__sub__",
    "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
    "__floordiv__", "__rfloordiv__", "__pow__", "__rpow__", "__mod__",
    "__rmod__", "__matmul__", "__rmatmul__",
)


def has_arithmetics(obj, additional_attributes=()) -> bool:
    """Whether ``obj`` supports the core arithmetic operators (a tensor or
    a :class:`Vector` does, a plain dict does not)."""
    attrs = CORE_ARITHMETIC_ATTRIBUTES + tuple(additional_attributes)
    return all(hasattr(obj, a) for a in attrs)



def _broadcast_binary(op):
    def binary(self, other):
        if isinstance(other, Vector):
            return Vector(tree_map(op, self.tree, other.tree))
        return Vector(tree_map(lambda x: op(x, other), self.tree))

    return binary


def _broadcast_rbinary(op):
    def rbinary(self, other):
        if isinstance(other, Vector):
            return Vector(tree_map(lambda a, b: op(b, a), self.tree, other.tree))
        return Vector(tree_map(lambda x: op(other, x), self.tree))

    return rbinary


class Vector:
    """Tree wrapper lifting elementwise arithmetic to arbitrary trees."""

    def __init__(self, tree):
        self._tree = tree

    @property
    def tree(self):
        return self._tree

    def __getitem__(self, key):
        return self._tree[key]

    def __contains__(self, key):
        return key in self._tree

    def __len__(self):
        return len(self._tree)

    def __iter__(self):
        return iter(self._tree)

    def keys(self):
        return self._tree.keys()

    def values(self):
        return self._tree.values()

    def items(self):
        return self._tree.items()

    __add__ = _broadcast_binary(operator.add)
    __radd__ = _broadcast_rbinary(operator.add)
    __sub__ = _broadcast_binary(operator.sub)
    __rsub__ = _broadcast_rbinary(operator.sub)
    __mul__ = _broadcast_binary(operator.mul)
    __rmul__ = _broadcast_rbinary(operator.mul)
    __truediv__ = _broadcast_binary(operator.truediv)
    __rtruediv__ = _broadcast_rbinary(operator.truediv)
    __floordiv__ = _broadcast_binary(operator.floordiv)
    __rfloordiv__ = _broadcast_rbinary(operator.floordiv)
    __pow__ = _broadcast_binary(operator.pow)
    __rpow__ = _broadcast_rbinary(operator.pow)
    __mod__ = _broadcast_binary(operator.mod)
    __rmod__ = _broadcast_rbinary(operator.mod)
    __matmul__ = _broadcast_binary(operator.matmul)
    __rmatmul__ = _broadcast_rbinary(operator.matmul)

    def __neg__(self):
        return Vector(tree_map(operator.neg, self._tree))

    def __pos__(self):
        return self

    def __abs__(self):
        return Vector(tree_map(operator.abs, self._tree))

    def __repr__(self):
        return f"Vector({self._tree!r})"

    @property
    def size(self):
        return size(self._tree)


# --------------------------------------------------------------------------
# Vector math
# --------------------------------------------------------------------------


def tree_add(a, b):
    return tree_map(operator.add, a, b)


def tree_sub(a, b):
    return tree_map(operator.sub, a, b)


def tree_scale(a, c):
    """Every leaf of ``a`` times the scalar ``c``."""
    return tree_map(lambda x: x * c, a)


def tree_axpy(c, x, y):
    """``y + c * x`` leafwise with a scalar ``c``."""
    return tree_map(lambda xe, ye: ye + c * xe, x, y)


def _fold_halving_sum(z):
    """Scalar sum with an association order fixed by the shape alone:
    trailing axes are summed per row, then the leading axis is folded in
    half repeatedly (the JAX package's ``_fold_halving_sum``)."""
    return _fold_halving_sum_rows(z[None])[0]


def vdot(a, b):
    """Tree-wide ``sum_i conj(a_i) * b_i`` as a 0-d tensor: :func:`vdot_rows`
    of the trees as one row, so a tree reduces alone as it does as a row of
    a batch.

    Under ``deterministic_reductions`` each leaf reduces with the
    fixed fold-halving order.
    """
    if not tree_leaves(a):
        return torch.zeros(())
    return vdot_rows(add_row(a), add_row(b))[0]


def dot(a, b):
    """Tree-wide ``sum_i a_i * b_i`` without complex conjugation."""
    acc = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        acc = acc + (x * y).sum()
    return acc


def tsum(tree):
    """The sum of every entry of every leaf (on a mesh, of the global
    leaves: see :func:`vdot_rows`)."""
    if _MESH[0] is not None:
        leaves = [x[None] for x in tree_leaves(tree)]
        if not leaves:
            return 0.0
        mesh, flags = _on_mesh(tree, leaves)
        det = config.get("deterministic_reductions")
        return _sum_leaves(_mesh_row_sums(leaves, flags, det, mesh))[0]
    acc = 0.0
    for x in tree_leaves(tree):
        acc = acc + x.sum()
    return acc


def conj(tree):
    """The complex conjugate of every leaf, materialized (not a lazy view)."""
    return tree_map(lambda x: x.conj().resolve_conj(), tree)


def norm(tree, ord=2, *, ravel=False):
    """Tree-wide vector norm of order ``ord``: see :func:`norm_rows`."""
    return norm_rows(add_row(tree), ord=ord, ravel=ravel)[0]


# --------------------------------------------------------------------------
# Per-row forms: every leaf carries a leading batch axis B
# --------------------------------------------------------------------------


def rows(c, x):
    """A per-row value ``c`` of shape (B,) shaped to broadcast against the
    batched leaf ``x`` of shape (B, ...)."""
    return c.reshape((-1,) + (1,) * (x.ndim - 1))


def _fold_halving(z):
    """(B, n, ...) -> (B, ...): axis 1 folded in half repeatedly (an odd
    last entry carried), an order fixed by ``n`` alone.  The one fold of
    the fixed-order reductions (:func:`_fold_halving_sum_rows`, the
    field-sharded distributor's adjoint)."""
    n = z.shape[1]
    while n > 1:
        m = n // 2
        folded = z[:, :m] + z[:, m:2 * m]
        if n % 2:
            folded = torch.cat([folded, z[:, 2 * m:]], dim=1)
        z = folded
        n = z.shape[1]
    return z[:, 0]


def _fold_halving_sum_rows(z):
    """The fold-halving sum of every row of a (B, ...) tensor: a row's
    trailing axes are summed, then its leading axis is folded in half
    repeatedly, whatever the number of rows."""
    if z.ndim == 1:
        return z
    if z.ndim > 2:
        z = z.sum(dim=tuple(range(2, z.ndim)))
    return _fold_halving(z)


def _row_partials(z):
    """(B, rows, ...) -> (B, rows): each row's sum over its trailing axes,
    taken one axis at a time from the last.  A long reduction on the card
    may be split over blocks by the number of its outputs (here a rank's
    share of the rows), so a 3-D slab's planes are not summed in one
    step; a 2-D field's rows are summed in one step either way."""
    while z.ndim > 2:
        z = z.sum(dim=-1)
    return z


def _mesh_row_sums(leaves, flags, det, mesh):
    """The (B,) row sums of each batched leaf on an active mesh: a
    replicated leaf sums its rows alone; a field-sharded one (``flags``)
    sums its rank's rows and reduces over the field group.  Under
    ``deterministic_reductions`` the per-row partials (one a row of the
    sharded axis) are gathered and folded in halves, the order
    :func:`_fold_halving_sum_rows` gives one rank holding every row, so
    any number of ranks gives the same bits; else the rank sums are
    all-reduced.  One collective serves every sharded leaf of one dtype."""
    from .parallel import collectives as coll

    group = mesh.group(mesh.field_axis)
    shard = [i for i, s in enumerate(flags) if s]
    out = [None] * len(leaves)
    if det:
        for i, z in enumerate(leaves):
            if not flags[i]:
                out[i] = _fold_halving_sum_rows(z)
        parts = {i: _row_partials(leaves[i]) for i in shard}
    else:
        for i, z in enumerate(leaves):
            out[i] = z.reshape(z.shape[0], -1).sum(dim=1)
        parts = {i: out[i][:, None] for i in shard}
    p = coll.group_size(group)
    for dtype in dict.fromkeys(q.dtype for q in parts.values()):
        idx = [i for i in shard if parts[i].dtype == dtype]
        cat = torch.cat([parts[i] for i in idx], dim=1)
        if not det:
            got = coll.SumAcross.apply(cat, group)
            for j, i in enumerate(idx):
                out[i] = got[:, j]
            continue
        got = coll.GatherAcross.apply(cat, group, 1)
        got = got.reshape(got.shape[0], p, cat.shape[1])
        at = 0
        for i in idx:
            w = parts[i].shape[1]
            out[i] = _fold_halving_sum_rows(got[:, :, at:at + w].reshape(got.shape[0], p * w))
            at += w
    return out


def _on_mesh(tree, leaves):
    """``(mesh, field flags)`` of a batched tree's leaves on the active
    mesh, or ``(None, None)`` without one."""
    mesh = _MESH[0]
    if mesh is None:
        return None, None
    flags = mesh.field_flags(tree, len(leaves))
    layout = mesh.layout(tree)
    for x, s, (_, shape) in zip(leaves, flags, layout or ()):
        if s and x.ndim != len(shape) + 1:
            raise ValueError(
                f"a field-sharded leaf takes one row axis on a mesh; got {tuple(x.shape)} for "
                f"a leaf of {shape}")
    return mesh, flags


def _sum_leaves(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def vdot_rows(a, b):
    """:func:`vdot` of each row of two batched trees: a (B,) tensor.  On a
    mesh the field-sharded leaves reduce over the field group
    (:func:`_mesh_row_sums`)."""
    det = config.get("deterministic_reductions")
    if _MESH[0] is not None:
        prods = [x.conj() * y for x, y in zip(tree_leaves(a), tree_leaves(b))]
        if not prods:
            raise ValueError("`vdot_rows` of trees without leaves")
        mesh, flags = _on_mesh(a, prods)
        return _sum_leaves(_mesh_row_sums(prods, flags, det, mesh))
    acc = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        prod = x.conj() * y
        v = _fold_halving_sum_rows(prod) if det else prod.reshape(prod.shape[0], -1).sum(dim=1)
        acc = v if acc is None else acc + v
    if acc is None:
        raise ValueError("`vdot_rows` of trees without leaves")
    return acc


def norm_rows(tree, ord=2, *, ravel=False):
    """:func:`norm` of each row of a batched tree: a (B,) tensor.

    Orders 1, 2 and ``inf`` take the tree-wide norm directly (with the
    fold-halving sums of ``deterministic_reductions``); any other order,
    or ``ravel=True``, takes ``(sum over leaves of ||leaf||_ord^ord)^(1 /
    ord)`` as the JAX package does, so ``ord=inf, ravel=True`` gives
    ``inf ** 0 = 1``."""
    if (ravel or ord not in (1, 2, np.inf)) and _MESH[0] is not None:
        leaves = tree_leaves(tree)
        if not leaves:
            raise ValueError("`norm_rows` of a tree without leaves")
        mesh, flags = _on_mesh(tree, leaves)
        powers = [x.abs() ** ord for x in leaves]
        det = config.get("deterministic_reductions")
        return _sum_leaves(_mesh_row_sums(powers, flags, det, mesh)) ** (1.0 / ord)
    if ravel or ord not in (1, 2, np.inf):
        acc = None
        for x in tree_leaves(tree):
            v = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), ord=ord, dim=1) ** ord
            acc = v if acc is None else acc + v
        if acc is None:
            raise ValueError("`norm_rows` of a tree without leaves")
        return acc ** (1.0 / ord)
    if ord == 2:
        return torch.sqrt(vdot_rows(tree, tree).real)
    leaves = tree_leaves(tree)
    if _MESH[0] is not None:
        return _mesh_norm_rows(tree, leaves, ord)
    if ord == 1:
        if config.get("deterministic_reductions"):
            parts = [_fold_halving_sum_rows(x.abs()) for x in leaves]
        else:
            parts = [x.abs().reshape(x.shape[0], -1).sum(dim=1) for x in leaves]
        return sum(parts[1:], parts[0])
    if ord == np.inf:
        return torch.stack(
            [x.abs().reshape(x.shape[0], -1).amax(dim=1) for x in leaves]
        ).amax(dim=0)


def _mesh_norm_rows(tree, leaves, ord):
    """:func:`norm_rows` of order 1 or ``inf`` on an active mesh."""
    from .parallel import collectives as coll

    mesh, flags = _on_mesh(tree, leaves)
    if ord == 1:
        det = config.get("deterministic_reductions")
        return _sum_leaves(_mesh_row_sums([x.abs() for x in leaves], flags, det, mesh))
    maxes = [x.abs().reshape(x.shape[0], -1).amax(dim=1) for x in leaves]
    group = mesh.group(mesh.field_axis)
    maxes = [coll.all_reduce(m, group, op=coll.dist.ReduceOp.MAX) if s else m
             for m, s in zip(maxes, flags)]
    return torch.stack(maxes).amax(dim=0)


def axpy_rows(c, x, y):
    """``y + c * x`` with one scalar ``c[b]`` per row."""
    return tree_map(lambda xe, ye: ye + rows(c, xe) * xe, x, y)


def scale_rows(c, x):
    """``c * x`` with one scalar ``c[b]`` per row."""
    return tree_map(lambda xe: rows(c, xe) * xe, x)


def where_rows(cond, a, b):
    """Row-wise select between batched trees: row ``b`` of the result is
    ``a``'s where ``cond[b]`` and ``b``'s elsewhere."""
    return tree_map(lambda x, y: torch.where(rows(cond, x), x, y), a, b)


def broadcast_rows(tree, n: int):
    """A view of ``tree`` with a leading axis of ``n`` equal rows."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)), tree)


def add_row(tree):
    """A view of ``tree`` as a batch of one row."""
    return tree_map(lambda x: x[None], tree)


def first_row(tree):
    """Row 0 of a batched tree, as a view."""
    return tree_map(lambda x: x[0], tree)


def mean(trees):
    """Mean over a list of trees, or over the leading axis of a stacked
    tree."""
    if isinstance(trees, (list, tuple)):
        acc = trees[0]
        for t in trees[1:]:
            acc = tree_add(acc, t)
        return tree_scale(acc, 1.0 / len(trees))
    return tree_map(lambda x: x.mean(dim=0), trees)


def mean_and_std(trees, correct_bias=True):
    """Leafwise mean and standard deviation over a list of trees or the
    leading axis of a stacked tree."""
    if isinstance(trees, (list, tuple)):
        trees = stack(trees)
    m = tree_map(lambda x: x.mean(dim=0), trees)
    s = tree_map(lambda x: x.std(dim=0, correction=1 if correct_bias else 0), trees)
    return m, s


def size(tree) -> int:
    return sum(
        (x.size if isinstance(x, ShapeWithDtype) else x.numel())
        for x in tree_leaves(tree)
    )


def result_type(tree) -> torch.dtype:
    leaves = tree_leaves(tree)
    if not leaves:
        return config.default_float_dtype()
    dt = leaves[0].dtype
    for leaf in leaves[1:]:
        dt = torch.promote_types(dt, leaf.dtype)
    return dt


def tree_device(tree) -> torch.device:
    """Device of the first tensor leaf; the configured default device
    (:func:`nifty_tpu_torch.config.default_device`) for shape-only trees."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return config.default_device()


def _filled_like(tree, value, device):
    def fill(x):
        if isinstance(x, ShapeWithDtype):
            dev = device if device is not None else config.default_device()
            return torch.full(x.shape, value, dtype=x.dtype, device=dev)
        return torch.full_like(x, value)

    return tree_map(fill, tree)


def ones_like(tree, *, device=None):
    """Ones shaped like ``tree``; shape-only leaves land on ``device``
    (default: the configured device)."""
    return _filled_like(tree, 1, device)


def zeros_like(tree, *, device=None):
    """Zeros shaped like ``tree``; shape-only leaves land on ``device``
    (default: the configured device)."""
    return _filled_like(tree, 0, device)


def where(cond, a, b):
    """Leafwise select; a Python/0-d condition selects whole trees."""
    if isinstance(cond, (bool, np.bool_)):
        return a if cond else b
    if isinstance(cond, torch.Tensor) and cond.ndim == 0:
        return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
    return tree_map(torch.where, cond, a, b)


def unite(x, y, op=operator.add):
    """Key-wise union of two dict-like trees; keys in both are combined
    with ``op``."""
    if isinstance(x, Vector) or isinstance(y, Vector):
        x = x.tree if isinstance(x, Vector) else x
        y = y.tree if isinstance(y, Vector) else y
        return Vector(unite(x, y, op=op))
    if not hasattr(x, "keys") and not hasattr(y, "keys"):
        return op(x, y)
    out = {}
    for k in set(x.keys()) | set(y.keys()):
        if k in x and k in y:
            out[k] = op(x[k], y[k])
        else:
            out[k] = x[k] if k in x else y[k]
    return out


def stack(trees, axis=0):
    """Stack congruent trees along a new axis (Python numbers included)."""

    def stk(*xs):
        return torch.stack([torch.as_tensor(x) for x in xs], dim=axis)

    return tree_map(stk, trees[0], *trees[1:])


def unstack(tree, axis=0):
    n = tree_leaves(tree)[0].shape[axis]
    return [tree_map(lambda x: x.select(axis, i), tree) for i in range(n)]


def ravel(tree):
    """Every leaf raveled and concatenated in flatten order: the vector of
    ``jax.flatten_util.ravel_pytree``."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def unravel(like, flat):
    """Inverse of :func:`ravel`: the last axis of ``flat`` cut into leaves
    shaped like those of ``like`` (tensors or :class:`ShapeWithDtype`);
    leading axes of ``flat`` stay leading axes of every leaf."""
    batch = tuple(flat.shape[:-1])
    leaves, at = [], 0
    for leaf in tree_leaves(like):
        n = size(leaf)
        leaves.append(flat[..., at:at + n].reshape(batch + tuple(leaf.shape)))
        at += n
    if at != flat.shape[-1]:
        raise ValueError(f"a vector of {flat.shape[-1]} entries for a tree of {at}")
    return tree_unflatten(like, leaves)


# --------------------------------------------------------------------------
# Weights carried across: JAX-package trees <-> port trees
# --------------------------------------------------------------------------


def from_numpy(tree, *, device=None, dtype=None, mesh=None):
    """Turn a tree of numpy (or numpy-convertible) arrays into tensors.

    Dicts, lists and tuples keep their type; any object with a ``.tree``
    attribute (a ``Vector`` of either package) becomes a port
    :class:`Vector`.  ``dtype`` applies to floating leaves only; without
    it a leaf takes the precision in force, as ``jnp.asarray`` does
    (:func:`~nifty_tpu_torch.config.canonical`: with ``enable_x64`` off a
    float64 leaf becomes float32).  ``device`` defaults to the configured
    device.

    Given a ``mesh``, a global tree becomes this rank's part of it, as
    :func:`~nifty_tpu_torch.parallel.mesh.shard_position` places it: the
    leaves it shards are cut to the rank's rows on the host, before the
    copy to the device, and the layout is recorded on the mesh.
    """
    if mesh is not None:
        from .parallel.mesh import shard_position

        host = from_numpy(tree, device="cpu", dtype=dtype)
        return tree_map(lambda x: x.to(device if device is not None
                                       else config.default_device()),
                        shard_position(host, mesh))
    if device is None:
        device = config.default_device()
    if isinstance(tree, dict):
        return {k: from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_namedtuple(tree):
        return type(tree)(from_numpy(v, device=device, dtype=dtype) for v in tree)
    if hasattr(tree, "tree") and not isinstance(tree, np.ndarray):
        return Vector(from_numpy(tree.tree, device=device, dtype=dtype))
    arr = np.array(tree, copy=True)
    t = torch.from_numpy(arr)
    if dtype is None:
        t = config.canonical(t)
    elif t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree):
    """Inverse of :func:`from_numpy`: host numpy copies of every leaf."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


# --------------------------------------------------------------------------
# Random numbers
# --------------------------------------------------------------------------


def _is_noise_provider(key) -> bool:
    return hasattr(key, "normal") and hasattr(key, "split")


def split(key, num: int = 2) -> list:
    """``num`` independent sub-keys of ``key`` (ints, or providers)."""
    if isinstance(key, torch.Generator):
        draws = torch.randint(
            0, 2**62, (num,), generator=key, device=key.device
        )
        return [int(s) for s in draws.tolist()]
    if _is_noise_provider(key):
        return list(key.split(num))
    state = np.random.SeedSequence(int(key)).generate_state(num, np.uint64)
    return [int(s >> np.uint64(1)) for s in state]


def fold_in(key, data: int):
    """A key derived from ``key`` and the integer ``data`` that leaves
    ``key`` as it was (counterpart of ``jax.random.fold_in``): a generator
    is not advanced, so what is drawn from ``key`` afterwards does not
    depend on whether a key was folded out of it."""
    if isinstance(key, torch.Generator):
        probe = torch.Generator(device=key.device)
        probe.set_state(key.get_state())
        key = int(torch.randint(0, 2**62, (1,), generator=probe, device=probe.device))
    elif _is_noise_provider(key):
        if not hasattr(key, "fold_in"):
            raise TypeError(f"noise provider {key!r} has no `fold_in`")
        return key.fold_in(int(data))
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def normal(generator, shape, dtype, device):
    """Standard-normal draws, the default ``rng`` of :func:`random_like`."""
    return torch.randn(shape, dtype=dtype, device=device, generator=generator)


def rademacher(generator, shape, dtype, device):
    """-1 or +1 with equal probability (``jax.random.rademacher``), an
    ``rng`` for :func:`random_like`: the probes of trace and diagonal
    estimators."""
    bits = torch.randint(0, 2, tuple(shape), device=device, generator=generator)
    return (2 * bits - 1).to(dtype)


def _draw(gen: torch.Generator, primals, device, rng=normal):
    def draw(x):
        dtype = x.dtype
        if dtype.is_complex:
            rdt = torch.empty((), dtype=dtype).real.dtype
            re = rng(gen, x.shape, rdt, gen.device)
            im = rng(gen, x.shape, rdt, gen.device)
            out = torch.complex(re, im) / np.sqrt(2.0)
        else:
            out = rng(gen, x.shape, dtype, gen.device)
        return out.to(device)

    return tree_map(draw, primals)


def random_like(key, primals, rng=None, *, device=None):
    """A tree shaped like ``primals`` (tensors or :class:`ShapeWithDtype`) of
    draws from ``key`` (see module docstring): standard normal, or
    ``rng(generator, shape, dtype, device)`` (e.g. :func:`rademacher`), a
    complex leaf as ``(re + i im) / sqrt(2)`` of two real draws.

    ``device`` defaults to the device of ``primals``' tensor leaves.  A
    noise provider draws through its ``normal(primals, device=)`` or, with
    ``rng``, its ``draw(primals, rng, device=)``: :class:`HostKey` calls
    ``rng`` with its host generator and ``device`` cpu, then copies, so an
    ``rng`` written with torch calls serves the host and the card alike.
    """
    mesh = _MESH[0]
    if mesh is not None and mesh.size(mesh.field_axis) > 1:
        slabs = _slab_draws(mesh, primals)
        if slabs is not None:
            like, dims = slabs
            if device is None:
                device = tree_device(primals)
            _MESH[0] = None  # the global draw is a single-process one
            try:
                full = random_like(key, like, rng, device=device)
            finally:
                _MESH[0] = mesh
            return tree_unflatten(primals, [
                x if d is None else mesh.own_rows(x, mesh.field_axis, dim=d)
                for x, d in zip(tree_leaves(full), dims)])
    if _is_noise_provider(key):
        if rng is None:
            return key.normal(primals, device=device)
        if not hasattr(key, "draw"):
            raise TypeError(f"noise provider {key!r} has no `draw` for an `rng`")
        return key.draw(primals, rng, device=device)
    rng = normal if rng is None else rng
    device = torch.device(device) if device is not None else tree_device(primals)
    if isinstance(key, torch.Generator):
        return _draw(key, primals, device, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return _draw(gen, primals, device, rng)


def _slab_draws(mesh, primals):
    """``(global_like, dims)`` for a draw shaped like ``primals`` on a
    field-sharded mesh: each leaf that the mesh's layout marks sharded and
    that has its rank's slab shape is drawn whole (``global_like`` holds its
    global shape) and cut to the rank's rows along ``dims[i]``; so a
    sample's noise is the same in any world.  ``None`` where no leaf is a
    slab (a global tree is drawn as it is)."""
    layout = mesh.layout(primals)
    if layout is None:
        return None
    p = mesh.size(mesh.field_axis)
    like, dims = [], []
    for x, (sharded, shape) in zip(tree_leaves(primals), layout):
        xs = tuple(x.shape)
        lead = len(xs) - len(shape)
        local = (shape[0] // p,) + tuple(shape[1:]) if shape else ()
        if sharded and lead >= 0 and xs[lead:] == local:
            like.append(ShapeWithDtype(xs[:lead] + tuple(shape), x.dtype))
            dims.append(lead)
        else:
            like.append(ShapeWithDtype(xs, x.dtype))
            dims.append(None)
    if all(d is None for d in dims):
        return None
    return tree_unflatten(primals, like), dims


class HostKey:
    """Key whose noise is drawn on the host and copied to the target
    device, so that runs on different devices see identical numbers."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def split(self, num: int = 2):
        return [HostKey(s) for s in split(self.seed, num)]

    def fold_in(self, data: int):
        return HostKey(fold_in(self.seed, data))

    def normal(self, primals, device=None):
        return self.draw(primals, normal, device=device)

    def draw(self, primals, rng, device=None):
        """``rng`` draws (see :func:`random_like`) on the host, copied to
        ``device``."""
        device = torch.device(device) if device is not None else tree_device(primals)
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        return _draw(gen, primals, device, rng)

    def __repr__(self):
        return f"HostKey({self.seed})"


# --------------------------------------------------------------------------
# Map registry
# --------------------------------------------------------------------------


def get_map(map) -> Callable:
    """Resolve a map specifier to a callable.

    ``"smap"``/``"s"`` and ``"lmap"``/``"l"`` are loops over the leading
    axis.  ``"vmap"``/``"v"`` is batching
    (:func:`nifty_tpu_torch.custom_map.vmap`): one evaluation for all
    elements stacked on a leading axis.  The sampling stages of
    ``OptimizeVI`` recognise it and run their solvers in lockstep over the
    batch (:func:`nifty_tpu_torch.evi.draw_linear_residuals`,
    :func:`~nifty_tpu_torch.evi.nonlinearly_update_residuals`).
    """
    from .custom_map import lmap, smap, vmap

    if isinstance(map, str):
        m = {
            "vmap": vmap, "v": vmap,
            "smap": smap, "s": smap,
            "lmap": lmap, "l": lmap,
        }.get(map)
        if m is None:
            raise ValueError(f"unknown map {map!r}")
        return m
    if callable(map):
        return map
    raise TypeError(f"invalid map {map!r}")


__all__ = [
    "HostKey", "ShapeWithDtype", "Vector", "axpy_rows", "broadcast_rows",
    "conj", "dot", "fold_in", "from_numpy", "get_map", "has_arithmetics",
    "mean", "mean_and_std", "norm", "norm_rows", "normal", "ones_like", "rademacher",
    "random_like", "ravel", "result_type", "rows", "scale_rows", "shape_dtype_like", "size",
    "split", "stack", "to_numpy", "tree_add", "tree_axpy", "tree_device", "tree_leaves",
    "tree_map", "tree_scale", "tree_sub", "tree_unflatten", "tsum", "unite",
    "unravel", "unstack", "vdot", "vdot_rows", "where", "where_rows", "zeros_like",
]
