"""Sampling engine for MGVI / geoVI (counterpart of :mod:`nifty_tpu.evi`).

Linear (MGVI) residual samples solve ``(M_lh + 1) s = n_lh + n_pr`` with
CG against the implicit Fisher metric; geoVI then "curves" them by
minimizing ``0.5 ||m - g(x)||^2`` with Newton-CG, the metric serving as
the Hessian approximation.  All noise comes from explicit keys
(:func:`nifty_tpu_torch.tree.split` / ``random_like``), split at the
places the JAX package splits its PRNG keys.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Tuple, TypeVar, Union

import torch

from .likelihood import Likelihood, vjp
from .solvers import cg as conjugate_gradient
from .solvers.newton_cg import OptimizeResults, _newton_cg
from .tree import (
    random_like,
    split,
    tree_add,
    tree_device,
    tree_leaves,
    tree_map,
    tree_sub,
    vdot,
)

P = TypeVar("P")


def sample_likelihood(likelihood: Likelihood, primals, key):
    """Draw a data-space white sample and pull it back through the metric's
    left square root: a sample with covariance ``M_lh``."""
    white = random_like(
        key, likelihood.left_sqrt_metric_tangents_shape, device=tree_device(primals)
    )
    return likelihood.left_sqrt_metric(primals, white)


def draw_linear_residual(
    likelihood: Likelihood,
    pos: P,
    key,
    *,
    from_inverse: bool = True,
    point_estimates: Union[P, Tuple[str]] = (),
    cg: Callable = conjugate_gradient.static_cg,
    cg_name: Optional[str] = None,
    cg_kwargs: Optional[dict] = None,
    napprox: int = 0,
    _raise_nonposdef: bool = False,
) -> Tuple[P, Any]:
    """Draw one MGVI residual sample at ``pos``; returns ``(residual, info)``.

    With ``from_inverse`` the sample has covariance ``(M_lh + 1)^{-1}``.
    The ``napprox`` preconditioner is not ported yet.
    """
    if not isinstance(likelihood, Likelihood):
        raise TypeError(f"`likelihood` of invalid type {type(likelihood)!r}")
    if napprox:
        raise NotImplementedError("the `napprox` preconditioner is not ported yet")
    lh, live = likelihood.freeze(point_estimates=point_estimates, primals=pos)
    cg_kwargs = dict(cg_kwargs or {})

    key_data, key_latent = split(key, 2)
    # metric-covariance sample: white data-space noise pulled back through
    # the metric's left square root plus a white latent sample
    data_part = sample_likelihood(lh, live, key=key_data)
    latent_part = random_like(key_latent, live)
    sample = tree_add(data_part, latent_part)
    info = 0
    if from_inverse:
        met = lh.metric_at(live)  # linearization hoisted out of the CG loop
        sample, info = cg(
            lambda t: tree_add(met(t), t),
            sample,
            x0=latent_part,
            name=cg_name,
            _raise_nonposdef=_raise_nonposdef,
            **cg_kwargs,
        )
    return sample, info


def _nonlinear_update_funcs(likelihood: Likelihood, anchor):
    """Residual functional, metric and sample norm of the geoVI update at
    the expansion point (anchor) ``a``.

    The functional is ``0.5 || m - g(x) ||^2`` with
    ``g(x) = x - a + lsm_a(T(x) - T(a))``; its minimizer transports the
    metric sample ``m`` along the likelihood's geometry.  The anchor's
    square-root metrics are linearized once here and reused by every
    evaluation.
    """
    lsm_a, rsm_a = likelihood.sqrt_metric_at(anchor)

    def residual_vg(trafo_ref, target, x):
        # value and gradient of 0.5 ||target - g(x)||^2; `trafo_ref` is T(a)
        trafo_x, lsm_x = vjp(likelihood.transformation, x)
        dtrafo = tree_sub(trafo_x, trafo_ref)
        transported = tree_add(tree_sub(x, anchor), lsm_a(dtrafo))
        mismatch = tree_sub(target, transported)
        value = 0.5 * vdot(mismatch, mismatch).real
        cograd = tree_map(torch.conj, mismatch)
        cograd = tree_add(cograd, lsm_x(rsm_a(cograd)))
        return value, tree_map(torch.neg, cograd)

    def metric_at(primals):
        # (1 + lsm_x rsm_a)(1 + lsm_a rsm_x): the functional's
        # Gauss-Newton Hessian approximation at x = primals
        lsm_x, rsm_x = likelihood.sqrt_metric_at(primals)

        def matvec(tangents):
            inner = tree_add(lsm_a(rsm_x(tangents)), tangents)
            return tree_add(lsm_x(rsm_a(inner)), inner)

        return matvec

    def sample_norm(natgrad):
        # convergence norm in the sample geometry: latent part plus the
        # data-space image of the natural gradient
        data_image = rsm_a(natgrad)
        return torch.sqrt(vdot(natgrad, natgrad).real + vdot(data_image, data_image).real)

    return residual_vg, metric_at, sample_norm


def nonlinearly_update_residual(
    likelihood: Likelihood = None,
    pos: P = None,
    residual_sample=None,
    metric_sample_key=None,
    metric_sample_sign=1.0,
    *,
    point_estimates=(),
    minimize: Callable[..., OptimizeResults] = _newton_cg,
    minimize_kwargs: Optional[dict] = None,
    _raise_notconverged: bool = False,
) -> Tuple[P, OptimizeResults]:
    """geoVI nonlinear update of one (residual sample, sign) pair."""
    minimize_kwargs = dict(minimize_kwargs or {})
    lh, e_liquid = likelihood.freeze(point_estimates=point_estimates, primals=pos)

    sample = tree_add(pos, residual_sample)
    metric_sample, _ = draw_linear_residual(
        likelihood, pos, metric_sample_key,
        point_estimates=point_estimates, from_inverse=False,
    )
    metric_sample = tree_map(lambda x: metric_sample_sign * x, metric_sample)

    if minimize_kwargs.get("maxiter", None) == 0:
        opt_state = OptimizeResults(sample, True, 0, None, None)
    else:
        residual_vg, metric_at, sample_norm = _nonlinear_update_funcs(lh, e_liquid)
        trafo_at_p = lh.transformation(e_liquid)
        opt_state = minimize(
            None,
            x0=sample,
            fun_and_grad=partial(residual_vg, trafo_at_p, metric_sample),
            hessp=lambda x, t: metric_at(x)(t),
            hessp_at=metric_at,
            custom_gradnorm=sample_norm,
            **minimize_kwargs,
        )
    if _raise_notconverged and opt_state.status < 0:
        raise ValueError("geoVI nonlinear update did not converge")
    new_sample = tree_sub(opt_state.x, e_liquid)
    return new_sample, opt_state._replace(x=None, jac=None)


class Samples:
    """Posterior samples stored as (expansion point, stacked residuals).

    Absolute samples are ``pos + residual``, materialized on access; only
    the residuals carry the sample axis, so re-centering (``at``) is free.
    ``keys`` is the list of keys the antithetic pairs were drawn from.
    """

    def __init__(self, *, pos: P = None, samples: P = None, keys=None):
        self._pos, self._samples, self._keys = pos, samples, keys

    @property
    def pos(self):
        return self._pos

    @property
    def keys(self):
        return self._keys

    def _residuals(self):
        if self._samples is None:
            raise ValueError(f"{type(self).__name__} holds no residuals")
        return self._samples

    def _offset(self, leaf_fn=lambda r: r):
        resid = self._residuals()
        if self._pos is None:
            return tree_map(leaf_fn, resid)
        return tree_map(lambda p, r: p + leaf_fn(r), self._pos, resid)

    @property
    def samples(self):
        return self._offset(lambda r: r)

    def __len__(self):
        leaves = tree_leaves(self._samples)
        return int(leaves[0].shape[0]) if leaves else 0

    def __getitem__(self, index):
        return self._offset(lambda r: r[index])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def at(self, pos):
        """Move the expansion point; the residuals stay fixed."""
        return Samples(pos=pos, samples=self._samples, keys=self._keys)
