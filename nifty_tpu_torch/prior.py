"""Prior model wrappers: named latent inputs with distribution transforms
(the normal and log-normal wrappers of :mod:`nifty_tpu.prior`)."""

from __future__ import annotations

from .model import WrappedCall
from .stats import lognormal_prior, normal_prior


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
