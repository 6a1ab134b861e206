"""Linear Wiener filtering with implicit covariances (counterpart of
:mod:`nifty_tpu.wiener_filter`).

Solves ``(R^T N^{-1} R + S^{-1}) m = R^T N^{-1} d`` by CG with every
operator a callable on trees of tensors.  ``R^T`` defaults to the autograd
transpose of ``R``, recorded once (:func:`~nifty_tpu_torch.likelihood.vjp`)
and pulled back through at every CG step.  :func:`draw_posterior_sample`
draws from the Wiener posterior by the metric-sample and inverse-metric
CG construction of the VI samplers.
"""

from __future__ import annotations

from typing import Callable, Optional

from .likelihood import vjp
from .solvers.cg import _static_cg
from .tree import random_like, split, tree_add, zeros_like

_CG_DEFAULTS = dict(resnorm=1e-8, maxiter=500)


def wiener_filter_curvature(R: Callable, R_adj: Callable, N_inv: Callable,
                            S_inv: Callable) -> Callable:
    """Return the curvature map ``x -> R^T N^-1 R x + S^-1 x``."""

    def curv(x):
        return tree_add(R_adj(N_inv(R(x))), S_inv(x))

    return curv


def _transpose(R, domain_proto):
    """``y -> R^T y``: the pull-back of the linear ``R`` at zeros shaped
    like ``domain_proto`` (tensors, or shapes for the configured device)."""
    return vjp(R, zeros_like(domain_proto))[1]


def wiener_filter(
    data,
    R: Callable,
    N_inv: Callable,
    S_inv: Callable,
    *,
    domain_proto,
    R_adj: Optional[Callable] = None,
    cg_kwargs: Optional[dict] = None,
):
    """Posterior mean of the linear-Gaussian model ``d = R s + n``.

    ``R_adj`` defaults to the autograd transpose of ``R``.  Returns
    ``(mean, cg_info)``.
    """
    if R_adj is None:
        R_adj = _transpose(R, domain_proto)
    curv = wiener_filter_curvature(R, R_adj, N_inv, S_inv)
    j = R_adj(N_inv(data))
    res = _static_cg(curv, j, **(cg_kwargs or _CG_DEFAULTS))
    return res.x, res.info


def draw_posterior_sample(
    key,
    R: Callable,
    N_inv: Callable,
    S_inv: Callable,
    S_sqrt: Callable,
    N_inv_sqrt: Callable,
    *,
    domain_proto,
    data_proto,
    mean=None,
    R_adj: Optional[Callable] = None,
    S_inv_sqrt: Optional[Callable] = None,
    cg_kwargs: Optional[dict] = None,
):
    """Sample from the Wiener posterior ``N(m, (R^T N^-1 R + S^-1)^-1)``.

    A metric sample ``R^T N^{-1/2} xi_d + S^{-1/2} xi_s`` is pushed through
    the inverse curvature by CG; ``xi_d`` and ``xi_s`` are drawn from the
    two sub-keys of ``key`` like ``data_proto`` and ``domain_proto``.  Pass
    ``S_inv_sqrt`` when a closed form exists: the default
    ``S_inv(S_sqrt(xi))`` squares the condition number.  Returns
    ``(sample, cg_info)``, the sample about ``mean`` if one is given.
    """
    if R_adj is None:
        R_adj = _transpose(R, domain_proto)
    k1, k2 = split(key, 2)
    xi_d = random_like(k1, data_proto)
    xi_s = random_like(k2, domain_proto)
    prior_part = S_inv_sqrt(xi_s) if S_inv_sqrt is not None else S_inv(S_sqrt(xi_s))
    smpl = tree_add(R_adj(N_inv_sqrt(xi_d)), prior_part)
    curv = wiener_filter_curvature(R, R_adj, N_inv, S_inv)
    res = _static_cg(curv, smpl, **(cg_kwargs or _CG_DEFAULTS))
    sample = res.x
    if mean is not None:
        sample = tree_add(mean, sample)
    return sample, res.info


__all__ = ["draw_posterior_sample", "wiener_filter", "wiener_filter_curvature"]
