"""Small numerical helpers (counterpart of :mod:`nifty_tpu.misc`)."""

from __future__ import annotations

from functools import wraps
from typing import Callable

import torch

from .tree import tree_leaves, tree_unflatten


def hvp(f: Callable, primals, tangents):
    """Hessian-vector product of scalar ``f`` (forward over reverse:
    ``torch.func.jvp`` of ``torch.func.grad``).  ``primals`` and
    ``tangents`` are tuples of arguments, as for ``jax.jvp``, each a tree of
    tensors; the gradient is taken with respect to the first argument, so
    the result is shaped like ``primals[0]``."""
    flat_p = [tree_leaves(p) for p in primals]

    def on_leaves(*leaves):
        it = iter(leaves)
        return f(*(tree_unflatten(p, [next(it) for _ in fp]) for p, fp in zip(primals, flat_p)))

    grad = torch.func.grad(on_leaves, argnums=tuple(range(len(flat_p[0]))))
    _, out = torch.func.jvp(grad, tuple(x for fp in flat_p for x in fp),
                            tuple(t for tan in tangents for t in tree_leaves(tan)))
    return tree_unflatten(primals[0], list(out))


def interpolate(xmin=-7.0, xmax=7.0, N=14000) -> Callable:
    """Decorator replacing a scalar function with a linear-interpolation
    lookup of itself, tabulated once on a float64 ``linspace`` of ``N``
    points; past the ends the lookup takes the end values."""

    def decorator(f):
        from .stats import interp

        x = torch.linspace(xmin, xmax, N, dtype=torch.float64)
        y = f(x)
        tables = {}

        @wraps(f)
        def wrapper(t):
            t = torch.as_tensor(t)
            if t.device not in tables:
                tables[t.device] = (x.to(t.device), y.to(t.device))
            xp, fp = tables[t.device]
            return interp(t, xp, fp)

        return wrapper

    return decorator


__all__ = ["hvp", "interpolate"]
