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
from .solvers.newton_cg import OptimizeResults, _newton_cg, _newton_cg_batched, batched_form
from .tree import (
    broadcast_rows,
    fold_in,
    random_like,
    scale_rows,
    split,
    stack,
    tree_add,
    tree_device,
    tree_leaves,
    tree_map,
    tree_sub,
    vdot,
    vdot_rows,
)

P = TypeVar("P")

#: ``fold_in`` tag that derives the preconditioner's keys from a sample's
#: key apart from its data/latent split (the JAX package's constant).
_NAPPROX_TAG = 0x9E37
_NAPPROX_EPS = 1e-12


def sample_likelihood(likelihood: Likelihood, primals, key):
    """Draw a data-space white sample and pull it back through the metric's
    left square root: a sample with covariance ``M_lh``."""
    white = random_like(
        key, likelihood.left_sqrt_metric_tangents_shape, device=tree_device(primals)
    )
    return likelihood.left_sqrt_metric(primals, white)


def _metric_sample_noise(lh: Likelihood, live, key):
    """The white noise of one metric sample: ``(data-space, latent)``, from
    the two halves of ``key``."""
    key_data, key_latent = split(key, 2)
    white = random_like(
        key_data, lh.left_sqrt_metric_tangents_shape, device=tree_device(live)
    )
    return white, random_like(key_latent, live)


def _preconditioner_keys(key, napprox: int):
    """Keys of the ``napprox`` metric samples behind the preconditioner.
    They are folded out of ``key``, not split from it, so the sample's own
    noise is the same with and without preconditioning."""
    return split(fold_in(key, _NAPPROX_TAG), napprox)


def _divide_by(diag):
    return lambda r: tree_map(torch.div, r, diag)


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
    ``napprox > 0`` builds a diagonal preconditioner for the metric CG from
    that many metric samples (their leafwise mean square,
    :func:`nifty_tpu_torch.probing.approximation2endo`).
    """
    if not isinstance(likelihood, Likelihood):
        raise TypeError(f"`likelihood` of invalid type {type(likelihood)!r}")
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
        if napprox and napprox > 0 and "preconditioner" not in cg_kwargs:
            from .probing import approximation2endo

            lsm, _ = lh.sqrt_metric_at(live)
            probes = []
            for k in _preconditioner_keys(key, napprox):
                white, latent = _metric_sample_noise(lh, live, k)
                probes.append(tree_add(lsm(white), latent))
            diag = approximation2endo(stack(probes), eps=_NAPPROX_EPS)
            cg_kwargs["preconditioner"] = _divide_by(diag)
        sample, info = cg(
            lambda t: tree_add(met(t), t),
            sample,
            x0=latent_part,
            name=cg_name,
            _raise_nonposdef=_raise_nonposdef,
            **cg_kwargs,
        )
    if point_estimates:
        sample = lh.insert_zeros(sample)
    return sample, info


def draw_linear_residuals(
    likelihood: Likelihood,
    pos: P,
    keys,
    *,
    from_inverse: bool = True,
    point_estimates: Union[P, Tuple[str]] = (),
    cg: Callable = conjugate_gradient.static_cg_batched,
    cg_name: Optional[str] = None,
    cg_kwargs: Optional[dict] = None,
    napprox: int = 0,
    _raise_nonposdef: bool = False,
) -> Tuple[P, Any]:
    """:func:`draw_linear_residual` for a list of keys in lockstep: one
    residual per key, stacked on a leading axis, and a (B,) ``info``.

    Each sample takes the noise its key gives it alone.  The position is
    shared: it is broadcast to one row per key (a view, no copy) and the
    metric is linearized once at those rows, so every matvec of the
    batched CG (:func:`~nifty_tpu_torch.solvers.cg.static_cg_batched`)
    serves all samples at once.  The likelihood must take latents with a
    leading batch axis, as the stacked KL stage requires too.
    """
    if not isinstance(likelihood, Likelihood):
        raise TypeError(f"`likelihood` of invalid type {type(likelihood)!r}")
    keys = list(keys)
    nrows = len(keys)
    lh, live = likelihood.freeze(point_estimates=point_estimates, primals=pos)
    cg_kwargs = dict(cg_kwargs or {})
    live_rows = broadcast_rows(live, nrows)

    noise = [_metric_sample_noise(lh, live, k) for k in keys]
    white = stack([w for w, _ in noise])
    latent_part = stack([lat for _, lat in noise])
    lsm, _ = lh.sqrt_metric_at(live_rows)
    sample = tree_add(lsm(white), latent_part)
    info = torch.zeros(nrows, dtype=torch.int64, device=tree_device(live))
    if from_inverse:
        met = lh.metric_at(live_rows)
        if napprox and napprox > 0 and "preconditioner" not in cg_kwargs:
            from .probing import approximation2endo

            probe_keys = [_preconditioner_keys(k, napprox) for k in keys]
            probes = []
            for m in range(napprox):
                noise_m = [_metric_sample_noise(lh, live, ks[m]) for ks in probe_keys]
                probes.append(tree_add(
                    lsm(stack([w for w, _ in noise_m])), stack([lat for _, lat in noise_m])))
            # (napprox, B, ...): the mean over the probes leaves one row a sample
            diag = approximation2endo(stack(probes), eps=_NAPPROX_EPS)
            cg_kwargs["preconditioner"] = _divide_by(diag)
        sample, info = cg(
            lambda t: tree_add(met(t), t),
            sample,
            x0=latent_part,
            name=cg_name,
            _raise_nonposdef=_raise_nonposdef,
            **cg_kwargs,
        )
    if point_estimates:
        sample = lh.insert_zeros(sample)
    return sample, info


def _nonlinear_update_funcs(likelihood: Likelihood, anchor, *, rows: bool = False):
    """Residual functional, metric and sample norm of the geoVI update at
    the expansion point (anchor) ``a``.

    The functional is ``0.5 || m - g(x) ||^2`` with
    ``g(x) = x - a + lsm_a(T(x) - T(a))``; its minimizer transports the
    metric sample ``m`` along the likelihood's geometry.  The anchor's
    square-root metrics are linearized once here and reused by every
    evaluation.  With ``rows`` every tree carries a leading batch axis
    (the anchor one equal row per sample) and the value and the norm are
    (B,) tensors.
    """
    lsm_a, rsm_a = likelihood.sqrt_metric_at(anchor)
    dot = vdot_rows if rows else vdot

    def transformation_and_lsm(x):
        # T(x) and the left square root at x: one vjp of T where that is
        # the left square root, else the likelihood's own
        if likelihood.lsm_is_transformation_vjp:
            return vjp(likelihood.transformation, x)
        return likelihood.transformation(x), likelihood.sqrt_metric_at(x)[0]

    def residual_vg(trafo_ref, target, x):
        # value and gradient of 0.5 ||target - g(x)||^2; `trafo_ref` is T(a)
        trafo_x, lsm_x = transformation_and_lsm(x)
        dtrafo = tree_sub(trafo_x, trafo_ref)
        transported = tree_add(tree_sub(x, anchor), lsm_a(dtrafo))
        mismatch = tree_sub(target, transported)
        value = 0.5 * dot(mismatch, mismatch).real
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
        return torch.sqrt(dot(natgrad, natgrad).real + dot(data_image, data_image).real)

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
    if point_estimates:
        sample = lh.remove(sample)
    metric_sample, _ = draw_linear_residual(
        likelihood, pos, metric_sample_key,
        point_estimates=point_estimates, from_inverse=False,
    )
    if point_estimates:
        metric_sample = lh.remove(metric_sample)
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
    if point_estimates:
        new_sample = lh.insert_zeros(new_sample)
    return new_sample, opt_state._replace(x=None, jac=None)


def nonlinearly_update_residuals(
    likelihood: Likelihood = None,
    pos: P = None,
    residual_samples=None,
    metric_sample_keys=None,
    metric_sample_signs=None,
    *,
    point_estimates=(),
    minimize: Callable[..., OptimizeResults] = _newton_cg_batched,
    minimize_kwargs: Optional[dict] = None,
    _raise_notconverged: bool = False,
) -> Tuple[P, OptimizeResults]:
    """:func:`nonlinearly_update_residual` for stacked residuals in
    lockstep: row ``b`` is curved with ``metric_sample_keys[b]`` and
    ``metric_sample_signs[b]``.  Every sample has its own ``x``; the anchor
    is shared (one equal row per sample, linearized once).  The result's
    ``nit``, ``status`` and ``fun`` are (B,) tensors.  ``minimize`` may be a
    single form (``_newton_cg``, ``_trust_ncg``, ``_lbfgs``, ...,
    ``minimize``, or a ``functools.partial`` of one): its lockstep form
    runs (:func:`~nifty_tpu_torch.solvers.newton_cg.batched_form`).
    """
    minimize = batched_form(minimize)
    minimize_kwargs = dict(minimize_kwargs or {})
    keys = list(metric_sample_keys)
    nrows = len(keys)
    lh, e_liquid = likelihood.freeze(point_estimates=point_estimates, primals=pos)
    anchor = broadcast_rows(e_liquid, nrows)

    liquid_resid = lh.remove(residual_samples) if point_estimates else residual_samples
    sample = tree_map(torch.add, anchor, liquid_resid)
    lsm_a, _ = lh.sqrt_metric_at(anchor)
    noise = [_metric_sample_noise(lh, e_liquid, k) for k in keys]
    metric_sample = tree_add(
        lsm_a(stack([w for w, _ in noise])), stack([lat for _, lat in noise]))
    leaves = tree_leaves(metric_sample)
    signs = torch.as_tensor(
        list(metric_sample_signs), dtype=leaves[0].real.dtype, device=leaves[0].device)
    metric_sample = scale_rows(signs, metric_sample)

    if minimize_kwargs.get("maxiter", None) == 0:
        opt_state = OptimizeResults(sample, True, 0, None, None)
    else:
        residual_vg, metric_at, sample_norm = _nonlinear_update_funcs(lh, anchor, rows=True)
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
    if _raise_notconverged and bool((torch.as_tensor(opt_state.status) < 0).any()):
        raise ValueError("geoVI nonlinear update did not converge")
    new_sample = tree_sub(opt_state.x, anchor)
    if point_estimates:
        new_sample = lh.insert_zeros(new_sample)
    return new_sample, opt_state._replace(x=None, jac=None)


def draw_residual(
    likelihood: Likelihood,
    pos: P,
    key,
    *,
    point_estimates: Union[P, Tuple[str]] = (),
    cg: Callable = conjugate_gradient.static_cg,
    cg_name: Optional[str] = None,
    cg_kwargs: Optional[dict] = None,
    minimize: Callable[..., OptimizeResults] = _newton_cg,
    minimize_kwargs: Optional[dict] = None,
    _raise_nonposdef: bool = False,
    _raise_notconverged: bool = False,
) -> Tuple[P, OptimizeResults]:
    """Draw an antithetic pair of geoVI samples: one linear draw, curved
    with both signs; the pair is stacked on a leading axis."""
    residual_sample, _ = draw_linear_residual(
        likelihood, pos, key,
        point_estimates=point_estimates,
        cg=cg, cg_name=cg_name, cg_kwargs=cg_kwargs,
        _raise_nonposdef=_raise_nonposdef,
    )
    curve = partial(
        nonlinearly_update_residual,
        likelihood, pos,
        metric_sample_key=key,
        point_estimates=point_estimates,
        minimize=minimize,
        minimize_kwargs=minimize_kwargs,
        _raise_notconverged=_raise_notconverged,
    )
    neg = tree_map(torch.neg, residual_sample)
    return stack((
        curve(residual_sample, metric_sample_sign=1.0),
        curve(neg, metric_sample_sign=-1.0),
    ))


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

    def at(self, pos, old_pos=None):
        """Move the expansion point; the residuals stay fixed (or, given
        ``old_pos``, the absolute samples are first re-expressed relative
        to it)."""
        if old_pos is not None:
            resid = tree_map(lambda q, smp: smp - q[None], old_pos, self.samples)
            return Samples(pos=pos, samples=resid, keys=self._keys)
        if self._pos is None:
            raise ValueError(
                "need `old_pos` to re-center samples without an expansion point"
            )
        return Samples(pos=pos, samples=self._samples, keys=self._keys)

    def squeeze(self):
        """Merge the two leading (batch, sample) axes of stacked samples."""
        resid = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), self._samples)
        return Samples(pos=self._pos, samples=resid, keys=self._keys)
