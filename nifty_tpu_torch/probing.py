"""Stochastic probing of implicit operators (counterpart of
:mod:`nifty_tpu.probing`).

- :class:`StatCalculator`: running mean and variance of trees (Welford).
- :func:`probe_diagonal` / :func:`probe_trace`: Hutchinson estimates of
  the diagonal and the trace of an implicit linear map from Rademacher
  probes, one probe after the other.
- :func:`approximation2endo`: a diagonal preconditioner from samples.
- :func:`operator_spectrum`: the largest eigenvalues of a symmetric
  implicit map, ARPACK on the host with the matvec on the map's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .tree import (
    rademacher,
    random_like,
    ravel,
    size as tree_size,
    split,
    stack,
    tree_device,
    tree_map,
    unravel,
    vdot,
)


class StatCalculator:
    """Welford running mean/variance over trees."""

    def __init__(self):
        self._count = 0
        self._mean = None
        self._m2 = None

    def add(self, value):
        self._count += 1
        if self._mean is None:
            self._mean = tree_map(torch.as_tensor, value)
            self._m2 = tree_map(torch.zeros_like, self._mean)
            return
        delta = tree_map(torch.sub, value, self._mean)
        self._mean = tree_map(lambda m, d: m + d / self._count, self._mean, delta)
        delta2 = tree_map(torch.sub, value, self._mean)
        self._m2 = tree_map(lambda m2, d, d2: m2 + d * d2, self._m2, delta, delta2)

    @property
    def mean(self):
        if self._count == 0:
            raise RuntimeError("no values added")
        return self._mean

    @property
    def var(self):
        if self._count < 2:
            raise RuntimeError("need at least 2 values")
        return tree_map(lambda m2: m2 / (self._count - 1), self._m2)


def _probes(proto, key, n_probes):
    """Rademacher probes shaped like ``proto``, one a sub-key of ``key``."""
    for k in split(key, n_probes):
        yield random_like(k, proto, rng=rademacher)


def probe_diagonal(op: Callable, proto, key, n_probes: int = 16):
    """Hutchinson diagonal estimate of an endomorphic map ``op``: the mean
    of ``z * op(z)`` over Rademacher probes ``z`` shaped like ``proto``."""
    terms = [tree_map(torch.mul, z, op(z)) for z in _probes(proto, key, n_probes)]
    return tree_map(lambda p: torch.mean(p, dim=0), stack(terms))


def probe_trace(op: Callable, proto, key, n_probes: int = 16):
    """Hutchinson trace estimate of an endomorphic map ``op``: the mean of
    ``<z, op(z)>`` over Rademacher probes."""
    return torch.mean(torch.stack([vdot(z, op(z)).real for z in _probes(proto, key, n_probes)]))


def approximation2endo(samples_of_op, *, eps: float = 1e-12):
    """Diagonal approximation from samples ``y_i = A^{1/2} x_i`` stacked on
    the leading axis: the leafwise mean of ``y^2``, clipped at ``eps``; use
    ``lambda r: tree_map(torch.div, r, diag)`` as a CG preconditioner."""
    return tree_map(
        lambda s: torch.clamp_min(torch.mean(s ** 2, dim=0), eps), samples_of_op
    )


def operator_spectrum(op: Callable, proto, k: int = 6, *, which: str = "LM",
                      tol: float = 0.0) -> np.ndarray:
    """Largest-magnitude eigenvalues of a symmetric implicit operator by
    ARPACK on the raveled map: the Arnoldi bookkeeping on the host, each
    matvec on the device of ``proto`` (tensors, or shapes for the
    configured device)."""
    import scipy.sparse.linalg as ssl

    device = tree_device(proto)
    n = tree_size(proto)

    def matvec(v):
        x = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float64).reshape(-1)).to(device)
        return ravel(op(unravel(proto, x))).cpu().numpy()

    lo = ssl.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    vals = ssl.eigsh(lo, k=k, which=which, tol=tol, return_eigenvectors=False)
    return np.sort(vals)[::-1]


__all__ = [
    "StatCalculator", "approximation2endo", "operator_spectrum", "probe_diagonal",
    "probe_trace",
]
