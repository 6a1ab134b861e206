"""Standard-normal -> target-distribution transforms (counterpart of
:mod:`nifty_tpu.stats`).

Every latent parameter is a priori standard normal; these transforms push
it to the desired marginal.  Distributions without a closed-form chain
(inverse gamma, gamma) are tabulated on the host with scipy once and
applied as a linear interpolation on the tensor's device.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from . import config
from .tree import tree_map


def _scalar_or_tensor(x):
    """A Python float, or a tensor of the default float dtype (fixed when
    the transform is made)."""
    x = np.asarray(x, dtype=np.float64)
    return float(x) if x.ndim == 0 else config.host_floats(x.copy())


# -- normal ----------------------------------------------------------------


def _standard_to_normal(xi, *, mean, std):
    return mean + std * xi


def normal_prior(mean, std) -> partial:
    return partial(
        _standard_to_normal, mean=_scalar_or_tensor(mean), std=_scalar_or_tensor(std)
    )


def _normal_to_standard(y, *, mean, std):
    return (y - mean) / std


def normal_invprior(mean, std) -> partial:
    return partial(
        _normal_to_standard, mean=_scalar_or_tensor(mean), std=_scalar_or_tensor(std)
    )


# -- log-normal ------------------------------------------------------------


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


def _lognormal_to_standard(y, *, log_mean, log_std):
    return (torch.log(y) - log_mean) / log_std


def lognormal_invprior(mean, std, *, _log_mean=None, _log_std=None) -> partial:
    if _log_mean is None and _log_std is None:
        _log_mean, _log_std = lognormal_moments(mean, std)
    return partial(
        _lognormal_to_standard,
        log_mean=_scalar_or_tensor(_log_mean),
        log_std=_scalar_or_tensor(_log_std),
    )


# -- laplace ---------------------------------------------------------------


def _standard_to_laplace(xi, *, alpha):
    # signed log-cdf construction; exact and overflow-safe in both tails
    log2 = float(np.log(2.0))
    res = torch.where(
        xi < 0,
        torch.special.log_ndtr(xi) + log2,
        -(torch.special.log_ndtr(-xi) + log2),
    )
    return res * alpha


def laplace_prior(alpha) -> partial:
    """P(x|a) = exp(-|x|/a) / (2a)."""
    return partial(_standard_to_laplace, alpha=_scalar_or_tensor(alpha))


# -- uniform ---------------------------------------------------------------


def ndtr(x):
    """The standard normal cdf, with ``erfc`` in both tails so that it keeps
    its relative precision down to the smallest numbers (as
    ``jax.scipy.special.ndtr``; ``torch.special.ndtr`` returns 0 below
    about -8.3)."""
    z = x.abs() * float(np.sqrt(0.5))
    tail = torch.special.erfc(z)
    y = torch.where(z < float(np.sqrt(0.5)), 1.0 + torch.special.erf(x * float(np.sqrt(0.5))),
                    torch.where(x > 0, 2.0 - tail, tail))
    return 0.5 * y


def _standard_to_uniform(xi, *, a_min, scale):
    return a_min + scale * ndtr(xi)


def uniform_prior(a_min=0.0, a_max=1.0) -> partial:
    if isinstance(a_min, float) and isinstance(a_max, float) \
            and a_min == 0.0 and a_max == 1.0:
        return partial(tree_map, ndtr)
    return partial(
        _standard_to_uniform,
        a_min=_scalar_or_tensor(a_min),
        scale=_scalar_or_tensor(np.asarray(a_max) - np.asarray(a_min)),
    )


# -- interpolation machinery ----------------------------------------------


def interp(x, xp, fp):
    """``jnp.interp`` / ``np.interp``: the piecewise linear interpolant of
    the table ``(xp, fp)`` at ``x``; outside the table it takes the end
    values."""
    i = torch.searchsorted(xp, x.detach().to(xp.dtype).contiguous(), right=True)
    i = i.clamp(1, xp.numel() - 1)
    x0, dx = xp[i - 1], xp[i] - xp[i - 1]
    f0, df = fp[i - 1], fp[i] - fp[i - 1]
    tiny = dx.abs() <= float(np.spacing(np.finfo(np.float64).eps))
    f = torch.where(tiny, f0, f0 + ((x - x0) / torch.where(tiny, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class _Table:
    """A host table computed in float64 and held in the default float dtype
    (fixed when the table is made), copied once to each device it is asked
    for."""

    def __init__(self, values):
        self._host = config.host_floats(values)
        self._on = {}

    def on(self, device):
        if device not in self._on:
            self._on[device] = self._host.to(device)
        return self._on[device]


def interpolator(
    func: Callable,
    xmin: float,
    xmax: float,
    *,
    step: Optional[float] = None,
    num: Optional[int] = None,
    table_func: Optional[Callable] = None,
    inv_table_func: Optional[Callable] = None,
    return_inverse: bool = False,
):
    """Tabulate the numpy function ``func`` on the host; return its linear
    interpolant (and, with ``return_inverse``, the interpolant of the
    inverse).  ``table_func`` / ``inv_table_func`` are tensor functions:
    the table holds ``table_func(func(x))`` and each lookup is mapped back
    through ``inv_table_func``."""
    if (step is None) == (num is None):
        raise ValueError("exactly one of `step` or `num` must be specified")
    if step is not None:
        xs = np.arange(xmin, xmax + step, step)
    else:
        xs = np.linspace(xmin, xmax, num)

    ys = torch.as_tensor(np.asarray(func(xs), dtype=np.float64))
    if table_func is not None:
        if inv_table_func is None:
            raise ValueError("no `inv_table_func` specified")
        ys = table_func(ys)
    xs_t, ys_t = _Table(xs), _Table(ys.numpy())

    def forward(x):
        res = interp(x, xs_t.on(x.device), ys_t.on(x.device))
        if inv_table_func is not None:
            res = inv_table_func(res)
        return res

    if return_inverse:
        def inverse(y):
            if table_func is not None:
                y = table_func(y)
            return interp(y, ys_t.on(y.device), xs_t.on(y.device))

        return forward, inverse
    return forward


# -- inverse gamma ---------------------------------------------------------

# (1 - Phi(8.2)) * 2 < 1e-15
_TABLE_MIN, _TABLE_MAX = -8.2, 8.2


def _ppf_of_normal(dist, **kw):
    from scipy.stats import norm as snorm

    return lambda x: dist.ppf(snorm.cdf(x), **kw)


def invgamma_prior(a, scale, loc=0.0, step=1e-2) -> Callable:
    """Standard normal -> inverse gamma via the tabulated ppf of the normal
    cdf (interpolated in log space); ``scale`` may be array-like when
    ``loc == 0``."""
    from scipy.stats import invgamma

    if np.ndim(a) != 0 or np.ndim(loc) != 0:
        raise TypeError("shape `a` and location `loc` must be scalar")
    if loc == 0.0:
        s2i = _ppf_of_normal(invgamma, a=a)
    elif np.ndim(scale) == 0:
        s2i = _ppf_of_normal(invgamma, a=a, loc=loc, scale=scale)
    else:
        raise TypeError("`scale` may only be array-like for `loc == 0.`")
    table = interpolator(s2i, _TABLE_MIN, _TABLE_MAX, step=step,
                         table_func=torch.log, inv_table_func=torch.exp)
    scale = _scalar_or_tensor(scale)

    def standard_to_invgamma(x):
        if loc == 0.0:
            return table(x) * scale
        return table(x)

    return standard_to_invgamma


def invgamma_invprior(a, scale, loc=0.0, step=1e-2) -> Callable:
    """Inverse transform of :func:`invgamma_prior`."""
    from scipy.stats import invgamma

    if loc == 0.0:
        s2i = _ppf_of_normal(invgamma, a=a)
    else:
        s2i = _ppf_of_normal(invgamma, a=a, loc=loc, scale=scale)
    _, inverse = interpolator(s2i, _TABLE_MIN, _TABLE_MAX, step=step,
                              table_func=torch.log, inv_table_func=torch.exp,
                              return_inverse=True)
    scale = _scalar_or_tensor(scale)

    def invgamma_to_standard(y):
        if loc == 0.0:
            y = y / scale
        return inverse(y)

    return invgamma_to_standard


# -- gamma / log-inverse-gamma --------------------------------------------


def gamma_prior(a, scale=1.0, loc=0.0, step=1e-2) -> Callable:
    """Standard normal -> Gamma(a, scale) via the tabulated ppf of the
    normal cdf."""
    from scipy.stats import gamma

    if np.ndim(a) != 0 or np.ndim(loc) != 0:
        raise TypeError("shape `a` and location `loc` must be scalar")
    if loc == 0.0:
        s2g = _ppf_of_normal(gamma, a=a)
    elif np.ndim(scale) == 0:
        s2g = _ppf_of_normal(gamma, a=a, loc=loc, scale=scale)
    else:
        raise TypeError("`scale` may only be array-like for `loc == 0.`")
    table = interpolator(s2g, _TABLE_MIN, _TABLE_MAX, step=step,
                         table_func=torch.log, inv_table_func=torch.exp)
    scale = _scalar_or_tensor(scale)

    def standard_to_gamma(x):
        if loc == 0.0:
            return table(x) * scale
        return table(x)

    return standard_to_gamma


def log_invgamma_prior(a, scale, loc=0.0, step=1e-2) -> Callable:
    """Standard normal -> the log of an inverse-gamma variable."""
    from scipy.stats import invgamma

    ppf = _ppf_of_normal(invgamma, a=a, loc=loc, scale=1.0)
    table = interpolator(lambda x: np.log(ppf(x)), _TABLE_MIN, _TABLE_MAX, step=step)
    log_scale = _scalar_or_tensor(np.log(scale))

    def standard_to_log_invgamma(x):
        return table(x) + log_scale

    return standard_to_log_invgamma
