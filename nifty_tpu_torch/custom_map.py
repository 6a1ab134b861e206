"""Maps over the leading (sample) axis (counterpart of
:mod:`nifty_tpu.custom_map`).

``smap`` and ``lmap`` are both a Python loop here: each element runs as
its own sequence of eager operations, so only one element's
intermediates are alive at a time.  Mapped arguments are trees of tensors
(indexed along axis 0) or Python sequences such as lists of keys.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

from .tree import stack, tree_leaves, tree_map


def _parse_in_axes(args, in_axes):
    if isinstance(in_axes, int) or in_axes is None:
        in_axes = (in_axes,) * len(args)
    if len(in_axes) != len(args):
        raise ValueError("`in_axes` length does not match number of arguments")
    for ax in in_axes:
        if ax not in (0, None):
            raise ValueError("only mapping along axis 0 (or None) is supported")
    return tuple(in_axes)


def _length(a) -> int:
    if isinstance(a, list):
        return len(a)
    return tree_leaves(a)[0].shape[0]


def _element(a, i):
    if isinstance(a, list):
        return a[i]
    return tree_map(lambda x: x[i], a)


def lmap(fun: Callable, in_axes: Union[int, Tuple] = 0, out_axes=0):
    """Loop map: ``fun`` per element, results stacked along axis 0."""
    if out_axes != 0:
        raise ValueError("`lmap` only supports `out_axes=0`")

    def lmapped(*args):
        axes = _parse_in_axes(args, in_axes)
        lengths = {_length(a) for a, ax in zip(args, axes) if ax == 0}
        if not lengths:
            raise ValueError("at least one argument must be mapped")
        if len(lengths) > 1:
            raise ValueError("inconsistent mapped axis sizes")
        (n,) = lengths
        results = [
            fun(*(_element(a, i) if ax == 0 else a for a, ax in zip(args, axes)))
            for i in range(n)
        ]
        return stack(results)

    return lmapped


smap = lmap

__all__ = ["lmap", "smap"]
