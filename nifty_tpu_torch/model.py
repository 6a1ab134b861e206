"""Models are ``torch.nn.Module``s (counterpart of :mod:`nifty_tpu.model`).

A :class:`Model` joins a callable with a ``domain`` (a tree of
:class:`~nifty_tpu_torch.tree.ShapeWithDtype`), a ``target`` and an
``init`` rule that draws the model's latent parameters from the
standardized prior.  Constant maps a model needs (distributor indices,
mode lengths, data) are registered buffers, so ``model.to(device)`` moves
them; the JAX package's ``Model.consts`` runtime-buffer route has no
counterpart because every tensor is already a runtime buffer.
"""

from __future__ import annotations

from functools import partial
from pprint import pformat
from typing import Callable, Optional

import torch
from torch import nn

from .tree import (
    ShapeWithDtype,
    random_like,
    shape_dtype_like,
    split,
    tree_leaves,
    tree_map,
    tree_unflatten,
    zeros_like,
)


class NoValue:
    """Sentinel distinguishing 'unset' from ``None``."""


class Initializer:
    """Composable per-key initialization rules.

    Wraps a single callable ``key -> tree`` ("opaque") or a tree of
    per-leaf callables; in the latter case the key is split across the
    leaves in flatten order, as the JAX package splits its PRNG key.
    """

    def __new__(cls, call_or_struct):
        if isinstance(call_or_struct, Initializer):
            return call_or_struct
        obj = super().__new__(cls)
        obj._call_or_struct = call_or_struct
        return obj

    @property
    def opaque(self) -> bool:
        return callable(self._call_or_struct)

    def __call__(self, key, *args, **kwargs):
        if self.opaque:
            return self._call_or_struct(key, *args, **kwargs)
        struct = self._call_or_struct
        subkeys = tree_unflatten(struct, split(key, len(tree_leaves(struct))))
        return tree_map(lambda init, k: init(k, *args, **kwargs), struct, subkeys)

    def __repr__(self):
        return f"Initializer({pformat(self._call_or_struct)})"


def module_device(module: nn.Module) -> torch.device:
    """Device of a module's first buffer or parameter (CPU if it has none)."""
    for t in module.buffers():
        return t.device
    for t in module.parameters():
        return t.device
    return torch.device("cpu")


class LazyModel(nn.Module):
    """Base class lazily deriving ``domain`` <-> ``target`` <-> ``init``."""

    def __init__(self, domain=NoValue, target=NoValue, init=NoValue):
        super().__init__()
        self._domain = domain
        self._target = target
        self._init = Initializer(init) if init is not NoValue else init

    def forward(self, *args, **kwargs):
        raise NotImplementedError()

    @property
    def domain(self):
        if self._domain is NoValue and self._init is not NoValue:
            return shape_dtype_like(self.init(0))
        return self._domain

    @property
    def target(self):
        """Output shapes; evaluated on zeros when not given (not cached)."""
        if self._target is NoValue and self.domain is not NoValue:
            x = zeros_like(self.domain, device=module_device(self))
            with torch.no_grad():
                return shape_dtype_like(self(x))
        return self._target

    @property
    def init(self) -> Initializer:
        if self._init is NoValue:
            return Initializer(
                tree_map(lambda p: partial(random_like, primals=p), self.domain)
            )
        return self._init

    def extra_repr(self):
        return f"domain={pformat(self._domain)}"


class Model(LazyModel):
    """Join a callable with a domain, target and init rule."""

    def __init__(
        self,
        call: Optional[Callable] = None,
        *,
        domain=NoValue,
        target=NoValue,
        init=NoValue,
        white_init: bool = False,
    ):
        if init is NoValue and domain is not NoValue and white_init:
            init = tree_map(lambda p: partial(random_like, primals=p), domain)
        elif init is NoValue and domain is NoValue:
            raise ValueError("one of `init` or `domain` must be set")
        super().__init__(domain=domain, target=target, init=init)
        self._call = call

    def forward(self, *args, **kwargs):
        return self._call(*args, **kwargs)


def wrap(call: Callable, name) -> Callable:
    """Lift ``call`` to act on ``input[name]`` instead of ``input``."""

    def named_call(p, *args, **kwargs):
        return call(p[name], *args, **kwargs)

    return named_call


class WrappedCall(Model):
    """Model selecting ``name`` from its input before applying ``call``."""

    def __init__(
        self,
        call: Callable,
        *,
        name=None,
        shape=(),
        dtype=None,
        white_init: bool = False,
        target=NoValue,
    ):
        leaves = tree_leaves(shape)
        is_swd = len(leaves) > 0 and all(
            isinstance(e, ShapeWithDtype) for e in leaves
        )
        domain = shape if is_swd else ShapeWithDtype(shape, dtype)
        if name is not None:
            call = wrap(call, name)
            domain = {name: domain}
        super().__init__(call, domain=domain, target=target, white_init=white_init)
