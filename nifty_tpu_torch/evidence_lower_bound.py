"""Evidence lower bound (ELBO) estimation from the posterior metric
(counterpart of :mod:`nifty_tpu.evidence_lower_bound`).

``log p(d) >= -<H> + 0.5 (N + tr log Λ^-1)`` with Λ the metric of the
standardized Hamiltonian at the posterior mean: the trace-log is computed
from the largest metric eigenvalues (all others are 1 by construction of
the standardized latent space).

The metric is linearized once at the samples' position
(``_StandardHamiltonian.metric_at``) and that closure is applied to every
vector.  Two backends:

- ``method="eigsh"``: ARPACK (scipy) on the raveled metric with batched
  deflation of converged eigenpairs; the Arnoldi bookkeeping runs on the
  host, each matvec on the position's device.  When every relevant
  eigenvalue is asked for, the explicit matrix is built, its columns
  pushed through the metric together as rows.
- ``method="slq"``: stochastic Lanczos quadrature of ``log`` over the
  metric on the device (:mod:`nifty_tpu_torch.num.lanczos`); ``slq_map``
  runs the probes in lockstep (``"vmap"``) or one after the other
  (``"smap"``, for latent spaces whose Krylov block fits only once).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as slg
import scipy.sparse.linalg as ssl
import torch

from .custom_map import vmap
from .evi import Samples
from .likelihood import Likelihood
from .logger import logger
from .num.lanczos import stochastic_logdet_from_lanczos, stochastic_lq_tridiags
from .optimize_kl import _StandardHamiltonian
from .tree import ravel, size as tree_size, tree_device, tree_leaves, unravel


class _Projector(ssl.LinearOperator):
    """Projects out already-converged eigenvectors (deflation)."""

    def __init__(self, eigenvectors):
        super().__init__(np.float64, 2 * (eigenvectors.shape[0],))
        self.eigenvectors = eigenvectors

    def _matvec(self, x):
        res = x.copy()
        for ev in self.eigenvectors.T:
            res -= ev * (ev @ x)
        return res

    def _rmatvec(self, x):
        return self._matvec(x)


class _RavelMetric(ssl.LinearOperator):
    """The metric closure ``met`` at ``position`` as a host operator on
    raveled float64 vectors; counts the vectors it was applied to."""

    def __init__(self, met, position):
        n = tree_size(position)
        super().__init__(np.float64, (n, n))
        self.met, self.position = met, position
        self.device = tree_device(position)
        self.matvecs = 0

    def _matvec(self, x):
        self.matvecs += 1
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64).reshape(-1))
        return ravel(self.met(unravel(self.position, t.to(self.device)))).cpu().numpy()

    def explicit(self):
        """The dense matrix: the identity's columns through the metric as
        rows of one batched call."""
        n = self.shape[0]
        self.matvecs += n
        eye = torch.eye(n, dtype=torch.float64, device=self.device)
        out = vmap(self.met)(unravel(self.position, eye))
        # row i is the metric times the i-th unit vector: column i
        cols = torch.cat([x.reshape(n, -1) for x in tree_leaves(out)], dim=1)
        return cols.T.cpu().numpy()


def _eigsh(metric, n_eigenvalues, tot_dofs, min_lh_eval=1e-4, batch_size=10,
           tol=0.0, verbose=True):
    metric_size = metric.shape[0]
    eigenvectors = None
    if n_eigenvalues > tot_dofs:
        raise ValueError(
            "requested more eigenvalues than relevant degrees of freedom"
        )
    if tot_dofs == n_eigenvalues:
        if verbose:
            logger.info(f"Computing all {tot_dofs} relevant metric eigenvalues")
        eigenvalues = slg.eigh(
            metric.explicit(), eigvals_only=True,
            subset_by_index=[metric_size - tot_dofs, metric_size - 1],
        )
        eigenvalues = np.flip(eigenvalues)
    else:
        bs = max(1, n_eigenvalues // batch_size)
        batches = [bs] * (n_eigenvalues // bs)
        if n_eigenvalues % bs:
            batches += [n_eigenvalues % bs]
        eigenvalues, projected = None, metric
        for batch in batches:
            eigvals, eigvecs = ssl.eigsh(
                projected, k=batch, tol=tol, return_eigenvectors=True,
                which="LM",
            )
            i = np.argsort(-eigvals)
            eigvals, eigvecs = eigvals[i], eigvecs[:, i]
            eigenvalues = (
                eigvals if eigenvalues is None
                else np.concatenate((eigenvalues, eigvals))
            )
            eigenvectors = (
                eigvecs if eigenvectors is None
                else np.hstack((eigenvectors, eigvecs))
            )
            if abs(1.0 - np.min(eigenvalues)) < min_lh_eval:
                break
            projector = _Projector(eigenvectors)
            projected = projector @ metric @ projector.T
    return eigenvalues, eigenvectors


def estimate_evidence_lower_bound(
    likelihood: Likelihood,
    samples: Samples,
    n_eigenvalues: int,
    min_lh_eval: float = 1e-3,
    batch_size: int = 10,
    tol: float = 0.0,
    verbose: bool = True,
    method: str = "eigsh",
    slq_order: int = 30,
    slq_samples: int = 8,
    key=None,
    slq_map="vmap",
):
    """Estimate the ELBO from posterior ``samples``.

    Returns ``(elbo_samples, stats)`` where ``stats`` carries
    ``elbo_mean`` / ``elbo_up`` / ``elbo_lw`` / ``lower_error`` and, beyond
    the JAX package's, ``metric_matvecs`` (the vectors the metric was
    applied to), ``logdet`` (the metric's log-determinant estimate: the
    found eigenvalues' or SLQ's) and ``largest_eigenvalue`` (the largest
    found eigenvalue, or the largest Ritz value of the SLQ probes).
    ``key`` (default 0) gives the SLQ probes; see the module docstring.
    """
    if not isinstance(samples, Samples):
        raise TypeError("`samples` must be a Samples instance")
    if not isinstance(likelihood, Likelihood):
        raise TypeError("`likelihood` must be a Likelihood")

    ham = _StandardHamiltonian(likelihood)
    metric_size = tree_size(samples.pos)
    n_data = tree_size(likelihood.lsm_tangents_shape)
    n_relevant = min(n_data, metric_size)
    met = ham.metric_at(samples.pos)

    if method == "eigsh":
        metric = _RavelMetric(met, samples.pos)
        eigenvalues, _ = _eigsh(
            metric, n_eigenvalues, tot_dofs=n_relevant,
            min_lh_eval=min_lh_eval, batch_size=batch_size, tol=tol,
            verbose=verbose,
        )
        log_eigenvalues = np.log(eigenvalues)
        tr_log_lat_cov = -0.5 * np.sum(log_eigenvalues)
        lower_error = (
            0.5 * (n_relevant - log_eigenvalues.size) * np.min(log_eigenvalues)
        )
        matvecs, largest = metric.matvecs, float(np.max(eigenvalues))
    elif method == "slq":
        tridiags, n = stochastic_lq_tridiags(
            met, slq_order, slq_samples, 0 if key is None else key,
            probe_like=samples.pos, cmap=slq_map,
        )
        tr_log_lat_cov = -0.5 * float(stochastic_logdet_from_lanczos(tridiags, n))
        lower_error = 0.0  # stochastic; reflected in sample std instead
        matvecs = slq_order * slq_samples
        largest = float(torch.linalg.eigvalsh(tridiags).max())
    else:
        raise ValueError(f"unknown method {method!r}")

    posterior_contribution = tr_log_lat_cov + 0.5 * metric_size
    with torch.no_grad():
        elbo_samples = np.array([posterior_contribution - float(ham(s)) for s in samples])

    stats = {"lower_error": lower_error, "metric_matvecs": matvecs,
             "logdet": -2.0 * tr_log_lat_cov, "largest_eigenvalue": largest}
    elbo_mean = np.mean(elbo_samples)
    elbo_std = np.std(elbo_samples, ddof=1) if len(elbo_samples) > 1 else 0.0
    stats["elbo_mean"] = elbo_mean
    stats["elbo_up"] = elbo_mean + elbo_std
    stats["elbo_lw"] = elbo_mean - elbo_std - stats["lower_error"]
    if verbose:
        logger.info(
            f"ELBO mean : {elbo_mean:.4e}"
            f" (upper: {stats['elbo_up']:.4e}, lower: {stats['elbo_lw']:.4e})"
        )
    return elbo_samples, stats


__all__ = ["estimate_evidence_lower_bound"]
