"""Gauss-Markov processes: Wiener, integrated Wiener and Ornstein-Uhlenbeck
(counterpart of :mod:`nifty_tpu.models.gauss_markov`).

A realization is generated from i.i.d. standard-normal increments with the
exact discrete transition of the process; integration is a prefix sum
(:func:`_cumsum`, whose bits repeat on the card).  The process functions
take leading batch axes: ``xi`` is (..., N) (the integrated Wiener process:
(..., N, 2)) over the steps ``dt`` of shape (N,) or a scalar.  The other
parameters are per-sample scalars of ``xi``'s batch shape (or plain
numbers); a parameter with as many axes as ``xi`` (the integrated Wiener
process: one fewer) varies along the steps instead.

:class:`GaussMarkovProcess` turns a process function into a model whose
parameters are submodules: models (their latents join the domain) or
constants (buffers).  :func:`WienerProcess`, :func:`IntegratedWienerProcess`
and :func:`OrnsteinUhlenbeckProcess` build it with normal (``x0``) and
log-normal priors for tuple arguments.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import config
from ..model import LazyModel, Model
from ..prior import LogNormalPrior, NormalPrior
from ..tree import ShapeWithDtype, random_like

#: Longest axis that :func:`_cumsum` hands to ``torch.cumsum`` in one piece.
_SCAN_CHUNK = 2048


def _cumsum(x):
    """Cumulative sum along the last axis whose bits repeat from run to run.

    ``torch.cumsum`` of one long row on a CUDA device runs a multi-block
    scan that combines the blocks' partial sums in an order that varies
    between runs, so the unbinned spectrum of a large grid (82,798 steps at
    1024^2) came out with other last bits each run.  Longer axes are
    therefore cut into rows of ``_SCAN_CHUNK`` entries (each scanned by one
    block), and the rows' totals are scanned the same way and added.
    """
    n = x.shape[-1]
    if n <= _SCAN_CHUNK:
        return torch.cumsum(x, -1)
    pad = -n % _SCAN_CHUNK
    rows = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _SCAN_CHUNK)
    within = torch.cumsum(rows, -1)
    totals = within[..., -1]
    before = _cumsum(totals) - totals
    return (within + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _along_steps(v, ndim):
    """A parameter shaped to broadcast against step-shaped tensors of
    ``ndim`` axes: a per-sample scalar gets a trailing step axis."""
    return v[..., None] if torch.is_tensor(v) and v.ndim < ndim else v


def _as_steps(dt, xi_steps):
    """``dt`` (a scalar or one value a step) along the steps of ``xi_steps``."""
    if not torch.is_tensor(dt):
        dt = torch.as_tensor(dt, dtype=xi_steps.real.dtype, device=xi_steps.device)
    return torch.broadcast_to(dt, xi_steps.shape[-1:])


def wiener_process(xi, x0, sigma, dt):
    """``W_{i+1} = W_i + sigma sqrt(dt_i) xi_i``; returns (..., N+1)."""
    dt = _as_steps(dt, xi)
    amp = torch.sqrt(dt) * _along_steps(sigma, xi.ndim)
    x0 = torch.broadcast_to(torch.as_tensor(x0, dtype=xi.dtype, device=xi.device)[..., None],
                            xi.shape[:-1] + (1,))
    return _cumsum(torch.cat([x0, amp * xi], -1))


def integrated_wiener_process(xi, x0, sigma, dt, asperity=None):
    """Generalized IWP: dx/dt = y + sigma sqrt(asperity) xi1, dy/dt = sigma xi2.

    ``xi`` has shape (..., N, 2) and ``dt`` shape (N,); returns (..., N+1, 2)
    with rows (x_i, y_i).  Leading axes batch samples: ``x0`` (..., 2) and
    the scalars ``sigma``, ``asperity`` (...) broadcast against them.  The
    exact discrete transition of the pure IWP has per-step covariance
    ``sigma^2 [[dt^3/3, dt^2/2], [dt^2/2, dt]]``; the x-increment below is
    ``dt (y_i + dy/2) + sigma sqrt(dt) sqrt(dt^2/12 + asperity) xi1``.
    """
    nd = xi.ndim - 1
    dt = _as_steps(dt, xi[..., 0])
    asp = 0.0 if asperity is None else _along_steps(asperity, nd)
    amp = _along_steps(sigma, nd) * torch.sqrt(dt)
    dy = amp * xi[..., 1]
    lead = dy.shape[:-1] + (1,)
    x0_x = torch.broadcast_to(x0[..., 0:1], lead)
    x0_y = torch.broadcast_to(x0[..., 1:2], lead)
    y = x0_y + _cumsum(dy)
    y_prev = torch.cat([x0_y, y[..., :-1]], -1)
    dx = amp * torch.sqrt(dt ** 2 / 12.0 + asp) * xi[..., 0] + dt * (y_prev + 0.5 * dy)
    x = x0_x + _cumsum(dx)
    return torch.stack([torch.cat([x0_x, x], -1), torch.cat([x0_y, y], -1)], dim=-1)


def ornstein_uhlenbeck_process(xi, x0, sigma, gamma, dt):
    """OU: ``x_{i+1} = d_i x_i + sigma sqrt(1 - d_i^2) xi_i`` with the exact
    drift ``d_i = exp(-gamma dt_i)``; returns (..., N+1).

    The parallel form divides by the cumulative drift product
    ``exp(cumsum(log d))`` and scans, as the JAX package does; once
    ``gamma * sum(dt)`` exceeds about 709 (float64's largest number is
    e^709.8) the division overflows and the result is not finite.
    """
    dt = _as_steps(dt, xi)
    drift = torch.exp(-_along_steps(gamma, xi.ndim) * dt)
    amp = _along_steps(sigma, xi.ndim) * torch.sqrt(1.0 - drift ** 2)
    drift = torch.broadcast_to(drift, xi.shape)
    x0 = torch.broadcast_to(torch.as_tensor(x0, dtype=xi.dtype, device=xi.device)[..., None],
                            xi.shape[:-1] + (1,))
    c = torch.exp(_cumsum(torch.log(drift)))  # prod_{j<=i} drift_j
    x = c * (x0 + _cumsum(amp * xi / c))
    return torch.cat([x0, x], -1)


class _Constant(nn.Module):
    """A constant parameter as a model of the latents: its buffer."""

    def __init__(self, value):
        super().__init__()
        if not torch.is_tensor(value):
            value = config.host_floats(value)
        self.register_buffer("value", value)

    def forward(self, x):
        return self.value


class GaussMarkovProcess(Model):
    """A process function as a model of the excitations ``x[name]`` (shape
    ``dt.shape + x0``'s own shape) over the steps ``dt`` (a buffer).

    ``x0`` and each keyword parameter of ``process`` are models, whose
    latents join the domain, constants (kept as buffers), or None (left to
    the function's default).  Latents with leading batch axes evaluate the
    process once for all samples.
    """

    def __init__(self, process: Callable, x0, dt, name: str = "xi",
                 N_steps: Optional[int] = None, **params):
        dt = np.asarray(dt, dtype=np.float64)
        if dt.ndim == 0:
            if N_steps is None:
                raise ValueError("`N_steps` required when `dt` is scalar")
            dt = np.full(N_steps, float(dt))
        x0_shape = tuple(x0.target.shape) if isinstance(x0, LazyModel) else np.shape(x0)
        own = ShapeWithDtype(dt.shape + x0_shape)
        domain = {name: own}
        init = {name: partial(random_like, primals=own)}
        for part in (x0, *params.values()):
            if isinstance(part, LazyModel):
                domain.update(part.domain)
                init.update(part.init._call_or_struct)
        super().__init__(domain=domain, init=init)
        self.process = process
        self.name = name
        self.register_buffer("dt", config.host_floats(dt))
        self.x0 = x0 if isinstance(x0, LazyModel) else _Constant(x0)
        self.params = nn.ModuleDict({
            k: v if isinstance(v, LazyModel) else _Constant(v)
            for k, v in params.items() if v is not None
        })

    def forward(self, x):
        x0 = self.x0(x)
        kw = {k: part(x) for k, part in self.params.items()}
        return self.process(xi=x[self.name], x0=x0, dt=self.dt, **kw)


def WienerProcess(x0, sigma, dt, name="wp", N_steps=None):
    """Wiener-process model; tuple arguments become (log-)normal priors."""
    if isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    return GaussMarkovProcess(wiener_process, x0, dt, name=name, N_steps=N_steps, sigma=sigma)


def IntegratedWienerProcess(x0, sigma, dt, name="iwp", asperity=None, N_steps=None):
    """IWP model (the power-spectrum deviations of the correlated field);
    ``x0`` has two entries (position and slope)."""
    if isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], shape=(2,), name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(asperity, tuple):
        asperity = LogNormalPrior(asperity[0], asperity[1], name=name + "_asperity")
    return GaussMarkovProcess(
        integrated_wiener_process, x0, dt,
        name=name, N_steps=N_steps, sigma=sigma, asperity=asperity,
    )


class _SteadyStateStart(Model):
    """The OU process's start drawn from its stationary distribution:
    ``x[key] * sigma`` (sigma's first step where it varies along them)."""

    def __init__(self, key, sigma):
        domain = {key: ShapeWithDtype(())}
        init = {key: partial(random_like, primals=domain[key])}
        if isinstance(sigma, LazyModel):
            domain.update(sigma.domain)
            init.update(sigma.init._call_or_struct)
        super().__init__(domain=domain, init=init, target=ShapeWithDtype(()))
        self.key = key
        self.sigma = sigma if isinstance(sigma, LazyModel) else _Constant(sigma)

    def forward(self, x):
        start = x[self.key]
        sig = self.sigma(x)
        return start * (sig if sig.ndim <= start.ndim else sig[..., 0])


def OrnsteinUhlenbeckProcess(sigma, gamma, dt, name="oup", x0=None, N_steps=None):
    """OU-process model; ``x0`` starts in the steady state when unset."""
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(gamma, tuple):
        gamma = LogNormalPrior(gamma[0], gamma[1], name=name + "_gamma")
    if x0 is None:
        x0 = _SteadyStateStart(name + "_x0", sigma)
    elif isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    return GaussMarkovProcess(
        ornstein_uhlenbeck_process, x0, dt,
        name=name, N_steps=N_steps, sigma=sigma, gamma=gamma,
    )
