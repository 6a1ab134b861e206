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
    __pow__ = _broadcast_binary(operator.pow)
    __rpow__ = _broadcast_rbinary(operator.pow)

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


def tree_axpy(c, x, y):
    """``y + c * x`` leafwise with a scalar ``c``."""
    return tree_map(lambda xe, ye: ye + c * xe, x, y)


def _fold_halving_sum(z):
    """Scalar sum with an association order fixed by the shape alone:
    trailing axes are summed per row, then the leading axis is folded in
    half repeatedly (the JAX package's ``_fold_halving_sum``)."""
    if z.ndim == 0:
        return z
    if z.ndim > 1:
        z = z.sum(dim=tuple(range(1, z.ndim)))
    n = z.shape[0]
    while n > 1:
        m = n // 2
        folded = z[:m] + z[m:2 * m]
        if n % 2:
            folded = torch.cat([folded, z[2 * m:]])
        z = folded
        n = z.shape[0]
    return z[0]


def vdot(a, b):
    """Tree-wide ``sum_i conj(a_i) * b_i`` as a 0-d tensor.

    Under ``deterministic_reductions`` each leaf reduces with the
    fixed fold-halving order.
    """
    det = config.get("deterministic_reductions")
    acc = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if det:
            v = _fold_halving_sum(x.conj() * y)
        else:
            v = torch.vdot(x.reshape(-1), y.reshape(-1))
        acc = v if acc is None else acc + v
    return torch.zeros(()) if acc is None else acc


def norm(tree, ord=2):
    """Tree-wide vector norm of order 1, 2 or ``inf``."""
    if ord == 2:
        return torch.sqrt(vdot(tree, tree).real)
    leaves = tree_leaves(tree)
    if ord == 1:
        fold = (
            _fold_halving_sum if config.get("deterministic_reductions")
            else torch.sum
        )
        parts = [fold(x.abs()) for x in leaves]
        return sum(parts[1:], parts[0])
    if ord == np.inf:
        return torch.stack([x.abs().max() for x in leaves]).max()
    raise ValueError(f"unsupported norm order {ord!r}")


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
    """Device of the first tensor leaf (CPU for shape-only trees)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def zeros_like(tree, *, device=None):
    def zero(x):
        if isinstance(x, ShapeWithDtype):
            return torch.zeros(x.shape, dtype=x.dtype, device=device)
        return torch.zeros_like(x)

    return tree_map(zero, tree)


def where(cond, a, b):
    """Leafwise select; a Python/0-d condition selects whole trees."""
    if isinstance(cond, (bool, np.bool_)):
        return a if cond else b
    if isinstance(cond, torch.Tensor) and cond.ndim == 0:
        return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
    return tree_map(torch.where, cond, a, b)


def stack(trees, axis=0):
    """Stack congruent trees along a new axis (Python numbers included)."""

    def stk(*xs):
        return torch.stack([torch.as_tensor(x) for x in xs], dim=axis)

    return tree_map(stk, trees[0], *trees[1:])


def unstack(tree, axis=0):
    n = tree_leaves(tree)[0].shape[axis]
    return [tree_map(lambda x: x.select(axis, i), tree) for i in range(n)]


# --------------------------------------------------------------------------
# Weights carried across: JAX-package trees <-> port trees
# --------------------------------------------------------------------------


def from_numpy(tree, *, device=None, dtype=None):
    """Turn a tree of numpy (or numpy-convertible) arrays into tensors.

    Dicts, lists and tuples keep their type; any object with a ``.tree``
    attribute (a ``Vector`` of either package) becomes a port
    :class:`Vector`.  ``dtype`` applies to floating leaves only.
    """
    if isinstance(tree, dict):
        return {k: from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_namedtuple(tree):
        return type(tree)(from_numpy(v, device=device, dtype=dtype) for v in tree)
    if hasattr(tree, "tree") and not isinstance(tree, np.ndarray):
        return Vector(from_numpy(tree.tree, device=device, dtype=dtype))
    arr = np.array(tree, copy=True)
    t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


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


def _draw_normal(gen: torch.Generator, primals, device):
    def draw(x):
        dtype = x.dtype
        if dtype.is_complex:
            rdt = torch.empty((), dtype=dtype).real.dtype
            re = torch.randn(x.shape, dtype=rdt, device=gen.device, generator=gen)
            im = torch.randn(x.shape, dtype=rdt, device=gen.device, generator=gen)
            out = torch.complex(re, im) / np.sqrt(2.0)
        else:
            out = torch.randn(x.shape, dtype=dtype, device=gen.device, generator=gen)
        return out.to(device)

    return tree_map(draw, primals)


def random_like(key, primals, *, device=None):
    """Standard-normal tree shaped like ``primals`` (tensors or
    :class:`ShapeWithDtype`), drawn from ``key`` (see module docstring).

    ``device`` defaults to the device of ``primals``' tensor leaves.
    """
    if _is_noise_provider(key):
        return key.normal(primals, device=device)
    device = torch.device(device) if device is not None else tree_device(primals)
    if isinstance(key, torch.Generator):
        return _draw_normal(key, primals, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return _draw_normal(gen, primals, device)


class HostKey:
    """Key whose noise is drawn on the host and copied to the target
    device, so that runs on different devices see identical numbers."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def split(self, num: int = 2):
        return [HostKey(s) for s in split(self.seed, num)]

    def normal(self, primals, device=None):
        device = torch.device(device) if device is not None else tree_device(primals)
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        return _draw_normal(gen, primals, device)

    def __repr__(self):
        return f"HostKey({self.seed})"


# --------------------------------------------------------------------------
# Map registry
# --------------------------------------------------------------------------


def get_map(map) -> Callable:
    """Resolve a map specifier to a callable.

    ``"smap"``/``"s"`` and ``"lmap"``/``"l"`` are loops over the leading
    axis.  ``"vmap"``/``"v"`` is the same loop for now: the solvers'
    data-dependent stopping rules do not run under ``torch.func.vmap``,
    and a batched lockstep solver is still to be written.
    """
    from .custom_map import lmap, smap

    if isinstance(map, str):
        m = {
            "vmap": smap, "v": smap,
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
    "HostKey", "ShapeWithDtype", "Vector", "from_numpy", "get_map",
    "norm", "random_like", "result_type", "shape_dtype_like", "size",
    "split", "stack", "to_numpy", "tree_add", "tree_axpy", "tree_device",
    "tree_leaves", "tree_map", "tree_sub", "tree_unflatten",
    "unstack", "vdot", "where", "zeros_like",
]
