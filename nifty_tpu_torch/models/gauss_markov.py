"""The integrated Wiener process that models the correlated field's
power-spectrum deviations (the part of :mod:`nifty_tpu.models.gauss_markov`
that the field uses)."""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..model import LazyModel, Model
from ..prior import LogNormalPrior, NormalPrior
from ..tree import ShapeWithDtype, random_like


def _col(v):
    """A per-sample scalar as a column, broadcasting against step axes."""
    return v[..., None] if torch.is_tensor(v) else v


def integrated_wiener_process(xi, x0, sigma, dt, asperity=None):
    """Generalized IWP: dx/dt = y + sigma sqrt(asperity) xi1, dy/dt = sigma xi2.

    ``xi`` has shape (..., N, 2) and ``dt`` shape (N,); returns (..., N+1, 2)
    with rows (x_i, y_i).  Leading axes batch samples: ``x0`` (..., 2) and
    the scalars ``sigma``, ``asperity`` (...) broadcast against them.  The
    exact discrete transition of the pure IWP has per-step covariance
    ``sigma^2 [[dt^3/3, dt^2/2], [dt^2/2, dt]]``; the x-increment below is
    ``dt (y_i + dy/2) + sigma sqrt(dt) sqrt(dt^2/12 + asperity) xi1``.
    """
    asp = 0.0 if asperity is None else _col(asperity)
    amp = _col(sigma) * torch.sqrt(dt)
    dy = amp * xi[..., 1]
    lead = dy.shape[:-1] + (1,)
    x0_x = torch.broadcast_to(x0[..., 0:1], lead)
    x0_y = torch.broadcast_to(x0[..., 1:2], lead)
    y = x0_y + torch.cumsum(dy, -1)
    y_prev = torch.cat([x0_y, y[..., :-1]], -1)
    dx = amp * torch.sqrt(dt ** 2 / 12.0 + asp) * xi[..., 0] + dt * (y_prev + 0.5 * dy)
    x = x0_x + torch.cumsum(dx, -1)
    return torch.stack([torch.cat([x0_x, x], -1), torch.cat([x0_y, y], -1)], dim=-1)


def _evaluate(part, x):
    return part(x) if isinstance(part, LazyModel) else part


class IntegratedWienerProcess(Model):
    """IWP model: excitations ``x[name]`` of shape (N, 2) over the steps
    ``dt`` (a buffer).  ``x0``, ``sigma`` and ``asperity`` are constants or
    models (submodules whose latents join the domain); tuples become normal
    (``x0``) or log-normal priors."""

    def __init__(self, x0, sigma, dt, name="iwp", asperity=None, N_steps=None):
        if isinstance(x0, tuple):
            x0 = NormalPrior(x0[0], x0[1], shape=(2,), name=name + "_x0")
        if isinstance(sigma, tuple):
            sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
        if isinstance(asperity, tuple):
            asperity = LogNormalPrior(asperity[0], asperity[1], name=name + "_asperity")
        dt = np.asarray(dt, dtype=np.float64)
        if dt.ndim == 0:
            if N_steps is None:
                raise ValueError("`N_steps` required when `dt` is scalar")
            dt = np.full(N_steps, float(dt))

        own = ShapeWithDtype((dt.shape[0], 2))
        domain = {name: own}
        init = {name: partial(random_like, primals=own)}
        for part in (x0, sigma, asperity):
            if isinstance(part, LazyModel):
                domain.update(part.domain)
                init.update(part.init._call_or_struct)
        super().__init__(domain=domain, init=init)
        self.name = name
        self.register_buffer("dt", torch.from_numpy(dt))
        if isinstance(x0, LazyModel):
            self.x0 = x0
        else:
            self.register_buffer("x0", torch.as_tensor(np.asarray(x0, dtype=np.float64)))
        self.sigma = sigma
        self.asperity = asperity

    def forward(self, x):
        return integrated_wiener_process(
            x[self.name], _evaluate(self.x0, x), _evaluate(self.sigma, x),
            self.dt, asperity=_evaluate(self.asperity, x),
        )
