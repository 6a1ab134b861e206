"""Profiling and instrumentation (counterpart of
:mod:`nifty_tpu.instrumentation`).

- :func:`exec_time` times a model's or a likelihood's forward, jvp, vjp
  (``value_and_grad`` for a scalar output) and metric, synchronizing the
  card after the warm-up call and after the timed calls.
- :class:`CountingModel` wraps a callable and counts its forward,
  Jacobian and adjoint applications with plain Python counters: the port
  runs eagerly, so every call is counted (the JAX package bumps its
  counters through ``jax.debug.callback`` from compiled code).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from .likelihood import Likelihood, value_and_grad
from .tree import random_like, tree_leaves, tree_unflatten


def _on_leaves(fn: Callable, like):
    """``fn`` as a function of the tuple of ``like``'s leaves, returning the
    tuple of its output's leaves and the output's tree (in ``out_like``)."""
    out_like = []

    def flat(*leaves):
        out = fn(tree_unflatten(like, list(leaves)))
        out_like[:] = [out]
        return tuple(tree_leaves(out))

    return flat, out_like


def _jvp(fn: Callable, primals, tangents):
    flat, out_like = _on_leaves(fn, primals)
    _, t_out = torch.func.jvp(flat, tuple(tree_leaves(primals)), tuple(tree_leaves(tangents)))
    return tree_unflatten(out_like[0], list(t_out))


def _vjp(fn: Callable, primals, cotangents):
    flat, _ = _on_leaves(fn, primals)
    _, pull = torch.func.vjp(flat, *tree_leaves(primals))
    return tree_unflatten(primals, list(pull(tuple(tree_leaves(cotangents)))))


def _sync(out):
    leaves = [x for x in tree_leaves(out) if torch.is_tensor(x)]
    if any(x.is_cuda for x in leaves):
        torch.cuda.synchronize(leaves[0].device)


def _timeit(fn, *args, n: int = 3):
    _sync(fn(*args))  # warm-up
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / n


def exec_time(model, primals=None, *, key=None, want_metric: bool = True,
              n: int = 3, verbose: bool = True) -> dict:
    """Seconds a call of ``model``'s forward, jvp, vjp (or
    ``value_and_grad`` for a scalar output) and, for a likelihood, metric:
    one warm-up call, then the mean over ``n`` calls.  ``key`` (default the
    seed 42) draws ``primals`` where none are given, and the tangents."""
    key = 42 if key is None else key
    if primals is None:
        primals = random_like(key, model.domain)
    tangents = random_like(key, primals)

    def forward(p):
        with torch.no_grad():
            return model(p)

    res = {"forward": _timeit(forward, primals, n=n)}
    res["jvp"] = _timeit(lambda p, t: _jvp(model, p, t), primals, tangents, n=n)
    out = forward(primals)
    if torch.is_tensor(out) and out.ndim == 0:
        res["value_and_grad"] = _timeit(lambda p: value_and_grad(model, p), primals, n=n)
    else:
        cot = random_like(key, out)
        res["vjp"] = _timeit(lambda p, c: _vjp(model, p, c), primals, cot, n=n)
    if want_metric and isinstance(model, Likelihood):
        res["metric"] = _timeit(model.metric, primals, tangents, n=n)
    if verbose:
        from .logger import logger

        for k, v in res.items():
            logger.info(f"exec_time: {k:16s} {v * 1e3:9.3f} ms")
    return res


class CountingModel:
    """Wrap a callable and count forward/Jacobian/adjoint applications.

    Use ``.report()`` for a per-pass summary; ``reset()`` to zero.
    """

    def __init__(self, call: Callable, name: str = "model"):
        self._call = call
        self.name = name
        self.reset()

    def reset(self):
        self._counts = {"forward": 0, "jvp": 0, "vjp": 0}

    @property
    def counts(self):
        return dict(self._counts)

    def __call__(self, x, *args, **kwargs):
        self._counts["forward"] += 1
        return self._call(x, *args, **kwargs)

    def jvp(self, primals, tangents):
        self._counts["jvp"] += 1
        return _jvp(self._call, primals, tangents)

    def vjp(self, primals, cotangents):
        self._counts["vjp"] += 1
        return _vjp(self._call, primals, cotangents)

    def report(self) -> str:
        c = self._counts
        return (
            f"{self.name}: #forward {c['forward']},"
            f" #jvp {c['jvp']}, #vjp {c['vjp']}"
        )


__all__ = ["CountingModel", "exec_time"]
