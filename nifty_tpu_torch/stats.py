"""Standard-normal -> target-distribution transforms (the normal and
log-normal part of :mod:`nifty_tpu.stats` that the correlated field and
the Gauss-Markov processes use)."""

from __future__ import annotations

from functools import partial

import numpy as np
import torch


def _scalar_or_tensor(x):
    x = np.asarray(x, dtype=np.float64)
    return float(x) if x.ndim == 0 else torch.from_numpy(x.copy())


def _standard_to_normal(xi, *, mean, std):
    return mean + std * xi


def normal_prior(mean, std) -> partial:
    return partial(
        _standard_to_normal, mean=_scalar_or_tensor(mean), std=_scalar_or_tensor(std)
    )


def lognormal_moments(mean, std):
    """Log-space cumulants matching the given linear-space mean/std."""
    mean, std = np.asarray(mean), np.asarray(std)
    if np.any(mean <= 0.0):
        raise ValueError(f"`mean` must be greater zero; got {mean!r}")
    if np.any(std <= 0.0):
        raise ValueError(f"`std` must be greater zero; got {std!r}")
    logstd = np.sqrt(np.log1p((std / mean) ** 2))
    logmean = np.log(mean) - 0.5 * logstd ** 2
    return logmean, logstd


def _standard_to_lognormal(xi, *, log_mean, log_std):
    return torch.exp(log_mean + log_std * xi)


def lognormal_prior(mean, std, *, _log_mean=None, _log_std=None) -> partial:
    if _log_mean is None and _log_std is None:
        _log_mean, _log_std = lognormal_moments(mean, std)
    return partial(
        _standard_to_lognormal,
        log_mean=_scalar_or_tensor(_log_mean),
        log_std=_scalar_or_tensor(_log_std),
    )
