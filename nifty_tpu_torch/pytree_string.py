"""Strings that stand for themselves in trees and solver names
(counterpart of :mod:`nifty_tpu.pytree_string`).

In the JAX package a :class:`PyTreeString` is a pytree with no leaves, so
that a tree holding names crosses ``jit`` as static data.  The port traces
nothing, so here the class only keeps that API: an immutable string that
compares, hashes, adds and prints as its content, accepted wherever a
solver takes a ``name`` (``static_cg``, ``newton_cg``).  The port's tree
functions treat it as a leaf.
"""

from __future__ import annotations

from .tree import tree_map


class PyTreeString:
    """An immutable string wrapper."""

    __slots__ = ("_str",)

    def __init__(self, s):
        object.__setattr__(self, "_str", str(s))

    @property
    def str(self) -> str:
        return self._str

    def __str__(self) -> str:
        return self._str

    def __repr__(self) -> str:
        return f"PyTreeString({self._str!r})"

    def __eq__(self, other) -> bool:
        o = other.str if isinstance(other, PyTreeString) else other
        return self._str == o

    def __hash__(self) -> int:
        return hash(self._str)

    def __add__(self, other):
        o = other.str if isinstance(other, PyTreeString) else other
        return PyTreeString(self._str + o)

    def __radd__(self, other):
        o = other.str if isinstance(other, PyTreeString) else other
        return PyTreeString(o + self._str)

    def __setattr__(self, *_):
        raise AttributeError("PyTreeString is immutable")


def hide_strings(tree):
    """Wrap every plain-``str`` leaf of ``tree`` in a :class:`PyTreeString`."""
    return tree_map(lambda x: PyTreeString(x) if isinstance(x, str) else x, tree)


def unhide_strings(tree):
    """Inverse of :func:`hide_strings`."""
    return tree_map(lambda x: x.str if isinstance(x, PyTreeString) else x, tree)


__all__ = ["PyTreeString", "hide_strings", "unhide_strings"]
