"""Parametric ("black-box") variational inference: mean-field and
full-covariance Gaussian posteriors with the reparametrization trick
(counterpart of :mod:`nifty_tpu.variational`).

The loss (the sample-averaged standard Hamiltonian minus the Gaussian
entropy) draws its ``n_samples`` standard-normal ε as rows and evaluates
the Hamiltonian of the stacked samples in one call: the energy of a stack
is the sum of its rows' energies, as in the KL stage of ``OptimizeVI``.
The optimizer is a ``torch.optim`` one, Adam at ``lr=1e-2`` (optax's
``adam`` defaults) unless another is given.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .likelihood import Likelihood
from .optimize_kl import _StandardHamiltonian
from .tree import (
    ShapeWithDtype,
    random_like,
    ravel,
    size as tree_size,
    split,
    stack,
    tree_leaves,
    tree_map,
    tree_unflatten,
    unravel,
)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


class _GaussianVI:
    """What both families share: the Hamiltonian, the optimizer and the
    loop of :meth:`run`."""

    def __init__(self, likelihood: Likelihood, *, n_samples: int = 4,
                 optimizer: Optional[Callable] = None, mirror_samples: bool = True):
        self.hamiltonian = _StandardHamiltonian(likelihood)
        self.likelihood = likelihood
        self.n_samples = n_samples
        self.mirror_samples = mirror_samples
        # a callable from a list of tensors to a `torch.optim.Optimizer`
        self.optimizer = _adam if optimizer is None else optimizer

    def _expected_energy(self, offsets, mean_plus):
        """The sample mean of the Hamiltonian at ``mean + offset`` (and,
        mirrored, ``mean - offset``) for ``offsets`` stacked as rows."""
        h = self.hamiltonian(mean_plus(offsets, 1.0))
        if self.mirror_samples:
            h = 0.5 * (h + self.hamiltonian(mean_plus(offsets, -1.0)))
        return h / self.n_samples

    def run(self, key, n_steps: int = 500, params=None, callback=None):
        """``n_steps`` optimizer steps from ``params`` (default: drawn by
        ``init_params`` from a sub-key); a fresh sub-key a step.  Returns
        ``(params, losses)``."""
        if params is None:
            key, sub = split(key, 2)
            params = self.init_params(sub)
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        opt = self.optimizer(leaves)
        losses = []
        for i in range(n_steps):
            key, sub = split(key, 2)
            opt.zero_grad()
            loss = self.loss(params, sub)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if callback is not None:
                callback(i, params, loss)
        return tree_map(torch.Tensor.detach, params), torch.tensor(losses, dtype=torch.float64)


class MeanFieldVI(_GaussianVI):
    """Diagonal-covariance Gaussian variational posterior.

    Variational parameters: ``{"mean": tree, "log_std": tree}``; entropy
    is ``sum(log_std) + const``.
    """

    def init_params(self, key, initial_mean=None, initial_std: float = 1e-2):
        mean = (
            initial_mean if initial_mean is not None
            else random_like(key, self.likelihood.domain)
        )
        log_std = tree_map(lambda m: torch.full_like(m, np.log(initial_std)), mean)
        return {"mean": mean, "log_std": log_std}

    def sample(self, params, key):
        eps = random_like(key, params["mean"])
        return tree_map(
            lambda m, ls, e: m + torch.exp(ls) * e, params["mean"], params["log_std"], eps,
        )

    def entropy(self, params):
        # Gaussian entropy up to an additive constant.
        return sum(torch.sum(x) for x in tree_leaves(params["log_std"]))

    def loss(self, params, key):
        """Negative ELBO ≈ E_q[H] - S[q] (sample estimate)."""
        eps = stack([random_like(k, params["mean"]) for k in split(key, self.n_samples)])

        def mean_plus(e, sign):
            return tree_map(lambda m, ls, x: m + sign * torch.exp(ls) * x,
                            params["mean"], params["log_std"], e)

        return self._expected_energy(eps, mean_plus) - self.entropy(params)


class FullCovarianceVI(_GaussianVI):
    """Full-covariance Gaussian variational posterior: a Cholesky factor
    over the flattened latent vector (``ravel`` order, dict keys sorted).
    Practical for moderate dimensions."""

    def __init__(self, likelihood: Likelihood, **kwargs):
        super().__init__(likelihood, **kwargs)
        self.dim = tree_size(likelihood.domain)
        self._like = likelihood.domain

    def init_params(self, key, initial_std: float = 1e-2):
        mean = ravel(random_like(key, self.likelihood.domain))
        # Parametrize L via its strictly-lower part + log-diagonal.
        log_diag = torch.full((self.dim,), np.log(initial_std), dtype=mean.dtype,
                              device=mean.device)
        lower = mean.new_zeros((self.dim * (self.dim - 1)) // 2)
        return {"mean": mean, "log_diag": log_diag, "lower": lower}

    def _cholesky(self, params):
        log_diag = params["log_diag"]
        strict = torch.tril_indices(self.dim, self.dim, offset=-1, device=log_diag.device)
        L = log_diag.new_zeros((self.dim, self.dim)).index_put(tuple(strict), params["lower"])
        return L + torch.diag(torch.exp(log_diag))

    def _eps(self, key, params):
        like = ShapeWithDtype((self.dim,), params["mean"].dtype)
        return random_like(key, like, device=params["mean"].device)

    def sample(self, params, key):
        x = params["mean"] + self._cholesky(params) @ self._eps(key, params)
        return unravel(self._like, x)

    def entropy(self, params):
        return torch.sum(params["log_diag"])

    def loss(self, params, key):
        L = self._cholesky(params)
        eps = torch.stack([self._eps(k, params) for k in split(key, self.n_samples)])

        def mean_plus(e, sign):
            return unravel(self._like, params["mean"] + sign * (e @ L.T))

        return self._expected_energy(eps, mean_plus) - self.entropy(params)


__all__ = ["FullCovarianceVI", "MeanFieldVI"]
