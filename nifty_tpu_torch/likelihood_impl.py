"""Concrete likelihoods: the Gaussian (counterpart of the ``Gaussian`` of
:mod:`nifty_tpu.likelihood_impl`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .likelihood import Likelihood
from .tree import shape_dtype_like, tree_map, vdot


class Gaussian(Likelihood):
    """Gaussian likelihood with fixed noise covariance.

    ``energy = 0.5 (d - x)^T N^-1 (d - x)``; the metric is ``N^-1`` and its
    left square root ``N^-1/2``.  ``noise_cov_inv`` and ``noise_std_inv``
    are callables or tensors (diagonals, kept as buffers); a missing one is
    inferred from the other assuming a diagonal covariance.
    """

    def __init__(self, data: torch.Tensor,
                 noise_cov_inv: Optional[Callable] = None,
                 noise_std_inv: Optional[Callable] = None):
        shp = shape_dtype_like(data)
        super().__init__(domain=shp, lsm_tangents_shape=shp)
        self.register_buffer("data", data)
        self._cov_inv_fn = noise_cov_inv if callable(noise_cov_inv) else None
        self._std_inv_fn = noise_std_inv if callable(noise_std_inv) else None
        for name, op in (("noise_cov_inv_diag", noise_cov_inv),
                         ("noise_std_inv_diag", noise_std_inv)):
            if op is not None and not callable(op):
                self.register_buffer(name, torch.as_tensor(op, device=data.device))
            else:
                self.register_buffer(name, None)
        with torch.no_grad():
            ones = torch.ones_like(data)
            if noise_cov_inv is None and noise_std_inv is not None:
                self.noise_cov_inv_diag = self.noise_std_inv(ones) ** 2
            elif noise_std_inv is None and noise_cov_inv is not None:
                self.noise_std_inv_diag = torch.sqrt(self.noise_cov_inv(ones))

    def noise_cov_inv(self, x):
        if self._cov_inv_fn is not None:
            return self._cov_inv_fn(x)
        return x if self.noise_cov_inv_diag is None else x * self.noise_cov_inv_diag

    def noise_std_inv(self, x):
        if self._std_inv_fn is not None:
            return self._std_inv_fn(x)
        return x if self.noise_std_inv_diag is None else x * self.noise_std_inv_diag

    def energy(self, primals):
        res = tree_map(torch.sub, self.data, primals)
        return 0.5 * vdot(res, self.noise_cov_inv(res)).real

    def normalized_residual(self, primals):
        return self.noise_std_inv(self.data - primals)

    def metric(self, primals, tangents):
        return self.noise_cov_inv(tangents)

    def left_sqrt_metric(self, primals, tangents):
        return self.noise_std_inv(tangents)

    def transformation(self, primals):
        return self.noise_std_inv(primals)
