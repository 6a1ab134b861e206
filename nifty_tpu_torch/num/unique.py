"""Tolerance-based uniquification of sub-arrays (host-side precompute;
counterpart of :mod:`nifty_tpu.num.unique`, whose numpy code it copies
because importing that package imports jax).

Used to deduplicate refinement matrices across chart locations: the
number of approximately unique kernels is tiny compared to the number of
sites, so refinement weights collapse to a small table plus an index map.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unique(ar, *, return_inverse=False, axis=-1, atol=1e-10, rtol=1e-5):
    """Unique sub-arrays of ``ar`` along ``axis`` within tolerances.

    Efficient when the number of approximately unique values is small.
    """
    if not isinstance(axis, int):
        raise TypeError(f"`axis` must be an int; got {type(axis)!r}")
    ar = np.asarray(ar)
    axis = int(np.arange(ar.ndim)[axis])
    reduce_axes = tuple(set(range(ar.ndim)) - {axis})

    uniqs = None
    inverse = np.full(ar.shape[axis], -1, dtype=int) if return_inverse else None
    to_sort = np.ones(ar.shape[axis], dtype=bool)
    while to_sort.any():
        i = np.nonzero(to_sort)[0][0]
        u = np.take(ar, (i,), axis=axis)
        uniqs = u if uniqs is None else np.concatenate((uniqs, u), axis=axis)
        isclose = np.zeros(to_sort.shape, dtype=bool)
        a = np.take(ar, np.nonzero(to_sort)[0], axis=axis)
        isclose[to_sort] = np.all(
            np.abs(u - a) <= (atol + rtol * np.abs(a)), axis=reduce_axes
        )
        to_sort &= ~isclose
        if return_inverse:
            inverse[isclose] = uniqs.shape[axis] - 1

    if return_inverse:
        assert inverse is not None and np.all(inverse != -1)
        return uniqs, inverse
    return uniqs


def amend_unique(ar, el, *, axis=-1, atol=1e-10, rtol=1e-5) -> Tuple[np.ndarray, int]:
    """Append ``el`` to ``ar`` along ``axis`` iff it is new (within
    tolerance); returns ``(array, index_of_el)``."""
    if not isinstance(axis, int):
        raise TypeError(f"`axis` must be an int; got {type(axis)!r}")
    ar = np.asarray(ar)
    el = np.asarray(el)
    axis = int(np.arange(ar.ndim)[axis])
    reduce_axes = tuple(set(range(ar.ndim)) - {axis})

    u = np.expand_dims(el, axis=axis)
    isclose = np.all(np.abs(u - ar) <= (atol + rtol * np.abs(ar)), axis=reduce_axes)
    idx = np.nonzero(isclose)[0]
    if idx.size:
        return ar, int(idx[0])
    return np.concatenate((ar, u), axis=axis), ar.shape[axis]
