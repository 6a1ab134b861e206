"""Concrete likelihoods: the Gaussian (counterpart of the ``Gaussian`` of
:mod:`nifty_tpu.likelihood_impl`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from . import config
from .likelihood import Likelihood
from .tree import shape_dtype_like, tree_leaves, tree_map, tree_unflatten, vdot


class _TreeBuffers(nn.Module):
    """A tree of tensors kept as one buffer a leaf, so ``.to()`` moves them;
    ``tree`` rebuilds the tree."""

    def __init__(self, tree):
        super().__init__()
        self._like = shape_dtype_like(tree)
        for i, leaf in enumerate(tree_leaves(tree)):
            self.register_buffer(str(i), leaf)

    @property
    def tree(self):
        return tree_unflatten(self._like, list(self.buffers()))


class Gaussian(Likelihood):
    """Gaussian likelihood with fixed noise covariance.

    ``energy = 0.5 (d - x)^dagger N^-1 (d - x)``; the metric is ``N^-1`` and
    its left square root ``N^-1/2``.  ``data`` is a tensor or a tree of
    tensors, real or complex.  ``noise_cov_inv`` and ``noise_std_inv`` are
    callables on such trees, or trees of diagonals (buffers, applied leaf by
    leaf); a missing one is inferred from the other assuming a diagonal
    covariance, from the ones of each leaf's real part.  Data that is not a
    tensor yet is placed on the configured default device; the diagonals
    follow the data.
    """

    def __init__(self, data, noise_cov_inv: Optional[Callable] = None,
                 noise_std_inv: Optional[Callable] = None):
        data = tree_map(
            lambda d: d if torch.is_tensor(d) else torch.as_tensor(d, device=config.default_device()),
            data,
        )
        shp = shape_dtype_like(data)
        super().__init__(domain=shp, lsm_tangents_shape=shp)
        self._data = _TreeBuffers(data)
        self._fns = {"cov_inv": noise_cov_inv if callable(noise_cov_inv) else None,
                     "std_inv": noise_std_inv if callable(noise_std_inv) else None}
        device = tree_leaves(data)[0].device
        self._diags = nn.ModuleDict({
            name: _TreeBuffers(tree_map(lambda v: torch.as_tensor(v, device=device), op))
            for name, op in (("cov_inv", noise_cov_inv), ("std_inv", noise_std_inv))
            if op is not None and not callable(op)
        })
        with torch.no_grad():
            ones = tree_map(lambda d: torch.ones_like(d.real), data)
            if noise_cov_inv is None and noise_std_inv is not None:
                self._diags["cov_inv"] = _TreeBuffers(tree_map(torch.square, self.noise_std_inv(ones)))
            elif noise_std_inv is None and noise_cov_inv is not None:
                self._diags["std_inv"] = _TreeBuffers(tree_map(torch.sqrt, self.noise_cov_inv(ones)))

    @property
    def data(self):
        return self._data.tree

    def _noise(self, name, x):
        fn = self._fns[name]
        if fn is not None:
            return fn(x)
        if name not in self._diags:
            return x
        return tree_map(torch.mul, x, self._diags[name].tree)

    def noise_cov_inv(self, x):
        return self._noise("cov_inv", x)

    def noise_std_inv(self, x):
        return self._noise("std_inv", x)

    def energy(self, primals):
        res = tree_map(torch.sub, self.data, primals)
        return 0.5 * vdot(res, self.noise_cov_inv(res)).real

    def normalized_residual(self, primals):
        return self.noise_std_inv(tree_map(torch.sub, self.data, primals))

    def metric(self, primals, tangents):
        return self.noise_cov_inv(tangents)

    def left_sqrt_metric(self, primals, tangents):
        return self.noise_std_inv(tangents)

    def transformation(self, primals):
        return self.noise_std_inv(primals)
