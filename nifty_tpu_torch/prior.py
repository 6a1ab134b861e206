"""Prior model wrappers: named latent inputs with distribution transforms
(counterpart of :mod:`nifty_tpu.prior`)."""

from __future__ import annotations

from .model import WrappedCall
from .stats import (
    gamma_prior,
    invgamma_prior,
    laplace_prior,
    log_invgamma_prior,
    lognormal_prior,
    normal_prior,
    uniform_prior,
)


class NormalPrior(WrappedCall):
    """Standard normal -> N(mean, std)."""

    def __init__(self, mean, std, **kwargs):
        super().__init__(normal_prior(mean, std), white_init=True, **kwargs)
        self.mean, self.std = mean, std


class LogNormalPrior(WrappedCall):
    """Standard normal -> log-normal with linear-space moments (mean, std)."""

    def __init__(self, mean, std, **kwargs):
        super().__init__(lognormal_prior(mean, std), white_init=True, **kwargs)
        self.mean, self.std = mean, std


class UniformPrior(WrappedCall):
    """Standard normal -> Uniform[a_min, a_max]."""

    def __init__(self, a_min, a_max, **kwargs):
        super().__init__(uniform_prior(a_min, a_max), white_init=True, **kwargs)
        self.low = self.a_min = a_min
        self.high = self.a_max = a_max


class LaplacePrior(WrappedCall):
    """Standard normal -> Laplace(scale=alpha)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(laplace_prior(alpha), white_init=True, **kwargs)
        self.alpha = alpha


class InvGammaPrior(WrappedCall):
    """Standard normal -> inverse gamma (tabulated transform)."""

    def __init__(self, a, scale, loc=0.0, step=1e-2, **kwargs):
        super().__init__(invgamma_prior(a, scale, loc, step), white_init=True, **kwargs)
        self.a, self.scale, self.loc, self.step = a, scale, loc, step


class GammaPrior(WrappedCall):
    """Standard normal -> Gamma (tabulated transform)."""

    def __init__(self, a, scale=1.0, loc=0.0, step=1e-2, **kwargs):
        super().__init__(gamma_prior(a, scale, loc, step), white_init=True, **kwargs)
        self.a, self.scale, self.loc = a, scale, loc


class LogInvGammaPrior(WrappedCall):
    """Standard normal -> log inverse gamma (tabulated transform)."""

    def __init__(self, a, scale, loc=0.0, step=1e-2, **kwargs):
        super().__init__(log_invgamma_prior(a, scale, loc, step), white_init=True, **kwargs)
        self.a, self.scale, self.loc = a, scale, loc
