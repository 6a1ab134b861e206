"""High-level conveniences (counterpart of :mod:`nifty_tpu.sugar`):
``calculate_position``, an approximate preimage of a model's output, and
``density_estimator``, the padded correlated-field density model."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .likelihood_impl import Gaussian
from .model import Model
from .solvers.newton_cg import _newton_cg
from .tree import random_like, tree_leaves, tree_map, tree_scale


def calculate_position(model, output, *, key=None, n_iterations: int = 3,
                       newton_maxiter: int = 10):
    """Approximate preimage: latents ``x`` with ``model(x) ~ output``.

    Minimizes a tight Gaussian misfit around ``output`` plus the standard
    prior with ``n_iterations`` restarts of Newton-CG.  ``key`` (default:
    the seed 42) draws the start, a tenth of a prior sample.
    """
    from .optimize_kl import _StandardHamiltonian

    key = 42 if key is None else key
    scale = max(float(leaf.abs().max()) for leaf in tree_leaves(output))
    cov = 1e-3 * scale ** 2
    lh = Gaussian(output, noise_cov_inv=lambda x: tree_map(lambda v: v / cov, x)).amend(model)
    ham = _StandardHamiltonian(lh)
    pos = tree_scale(random_like(key, model.domain), 0.1)
    for _ in range(n_iterations):
        pos = _newton_cg(ham, pos, maxiter=newton_maxiter, xtol=1e-6,
                         cg_kwargs=dict(maxiter=50)).x
    return pos


class _Density(Model):
    """``exp`` of a correlated field, cropped to ``shape`` on the trailing
    axes (so that leading batch axes pass through)."""

    def __init__(self, field, shape):
        super().__init__(domain=field.domain, init=field.init)
        self.field = field
        self._crop = (Ellipsis,) + tuple(slice(0, s) for s in shape)

    def forward(self, p):
        return torch.exp(self.field(p)[self._crop])


def density_estimator(shape, distances, *, pad: float = 1.0,
                      cf_fluctuations: Optional[dict] = None,
                      cf_azm_uniform: Optional[tuple] = None, prefix: str = ""):
    """Non-parametric density model: ``exp`` of a Matern correlated field
    on a grid padded by ``pad`` times ``shape`` (to decouple the periodic
    boundary), cropped back to ``shape``.  Returns ``(density_model,
    correlated_field_maker)``."""
    from .models.correlated_field import CorrelatedFieldMaker
    from .stats import uniform_prior

    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = tuple(np.broadcast_to(distances, (len(shape),)).astype(float))
    cf_fluctuations = cf_fluctuations or {
        "scale": (0.5, 0.3),
        "cutoff": (4.0, 3.0),
        "loglogslope": (-6.0, 3.0),
    }
    azm_uniform = cf_azm_uniform or (1e-4, 1.0)

    padded_shape = tuple(int((1.0 + pad) * s) for s in shape)
    cfm = CorrelatedFieldMaker(prefix + "density")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=uniform_prior(*azm_uniform))
    cfm.add_fluctuations_matern(padded_shape, distances, **cf_fluctuations)
    return _Density(cfm.finalize(), shape), cfm
