"""Likelihood calculus: energy, Fisher metric and its square roots, all
from autograd (counterpart of :mod:`nifty_tpu.likelihood`).

Every likelihood exposes

- ``energy(x)`` (also ``lh(x)``): the negative log-likelihood,
- ``transformation(x)``: a coordinate map under which the Fisher metric is
  the identity,
- ``left_sqrt_metric(x, t)`` = J_T^T t (vjp of the transformation),
- ``right_sqrt_metric(x, t)`` = J_T t (its transpose),
- ``metric(x, t)`` = lsm(rsm(t)), and ``metric_at(x)``, the same matvec
  with all primal work hoisted out of the solver loop.

PyTorch has no ``jax.linear_transpose``.  :func:`linearize` builds the
linearization at a fixed point from reverse mode alone: one forward pass
records the graph, one backward pass with ``create_graph=True`` records
``u -> J^T u`` as a graph linear in ``u``, and differentiating that graph
with respect to ``u`` gives ``t -> J t``.  Both closures reuse the
recorded graphs, so each matvec runs one linear forward and one linear
backward pass and never the nonlinear model again.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch import nn

from .model import LazyModel, NoValue
from .tree import (
    ShapeWithDtype,
    Vector,
    shape_dtype_like,
    tree_add,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _leaf_inputs(primals):
    leaves = tree_leaves(primals)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    return xs, tree_unflatten(primals, xs)


def _grad(outputs, inputs, cotangents, **kw):
    """``torch.autograd.grad`` that maps unused inputs to zeros."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    if not pairs:
        return [torch.zeros_like(x) for x in inputs]
    gs = torch.autograd.grad(
        [o for o, _ in pairs], inputs, [c for _, c in pairs],
        allow_unused=True, **kw,
    )
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs)]


def value_and_grad(f: Callable, primals):
    """``(f(primals), grad f(primals))`` for a scalar-valued ``f``."""
    xs, p = _leaf_inputs(primals)
    with torch.enable_grad():
        v = f(p)
        gs = _grad([v], xs, [torch.ones_like(v)])
    return v.detach(), tree_unflatten(primals, gs)


def hessian_vector_product(f: Callable, primals, tangents):
    """``H t`` of a scalar-valued ``f`` at ``primals`` (double backward)."""
    xs, p = _leaf_inputs(primals)
    with torch.enable_grad():
        v = f(p)
        gs = _grad([v], xs, [torch.ones_like(v)], create_graph=True)
        gt = sum((g * t).sum() for g, t in zip(gs, tree_leaves(tangents)))
        hv = _grad([gt], xs, [torch.ones_like(gt)])
    return tree_unflatten(primals, hv)


def vjp(f: Callable, primals):
    """``(f(primals), ct -> J^T ct)``; the closure can be applied often."""
    xs, p = _leaf_inputs(primals)
    with torch.enable_grad():
        y = f(p)
    ys = tree_leaves(y)

    def vjp_fn(cotangents):
        with torch.enable_grad():
            gs = _grad(ys, xs, tree_leaves(cotangents), retain_graph=True)
        return tree_unflatten(primals, gs)

    return tree_unflatten(y, [t.detach() for t in ys]), vjp_fn


def linearize(f: Callable, primals):
    """``(f(primals), t -> J t, ct -> J^T ct)`` at a fixed point, from a
    recorded forward graph and its recorded backward graph (see the module
    docstring).  The backward graph is recorded at the first ``J t``, so a
    caller that only pulls back pays for one forward pass.  Requires every
    operation in ``f`` to be twice differentiable in reverse mode, which the
    distributor's ``autograd.Function`` pair is."""
    xs, p = _leaf_inputs(primals)
    with torch.enable_grad():
        y = f(p)
        ys = tree_leaves(y)
    recorded = []  # the backward graph, recorded at the first jvp

    def jvp_fn(tangents):
        with torch.enable_grad():
            if not recorded:
                us = [torch.zeros_like(t, requires_grad=True) for t in ys]
                recorded.append((us, _grad(ys, xs, us, create_graph=True)))
            us, adj = recorded[0]
            out = _grad(adj, us, tree_leaves(tangents), retain_graph=True)
        return tree_unflatten(y, out)

    def vjp_fn(cotangents):
        with torch.enable_grad():
            gs = _grad(ys, xs, tree_leaves(cotangents), retain_graph=True)
        return tree_unflatten(primals, gs)

    return tree_unflatten(y, [t.detach() for t in ys]), jvp_fn, vjp_fn


# --------------------------------------------------------------------------
# Point estimates: leaves of the latent tree frozen to constants
# --------------------------------------------------------------------------


def _structure(tree):
    """A tree's structure without its leaves, for comparison."""
    return tree_map(lambda _: 0, tree.tree if isinstance(tree, Vector) else tree)


def parse_point_estimates(point_estimates, primals):
    """Normalize ``point_estimates`` to a tree of booleans congruent with
    ``primals`` and split the primals' leaves into liquid and frozen ones.

    ``point_estimates`` is a tuple or list of dict keys (for dict-like
    primals) or a tree of booleans.  Returns ``(bool_tree, liquid, frozen)``:
    ``liquid`` is a :class:`~nifty_tpu_torch.tree.Vector` of the tuple of
    non-frozen leaves, ``frozen`` the tuple of frozen ones.
    """
    if isinstance(point_estimates, (tuple, list)):
        tree = primals.tree if isinstance(primals, Vector) else primals
        if not isinstance(tree, dict):
            raise TypeError("tuple-shortcut point-estimates require dict-like primals")
        unknown = set(point_estimates) - set(tree)
        if unknown:
            raise ValueError(f"point-estimate keys {unknown} not in primals")
        pe = {
            k: tree_map(lambda _, frz=(k in point_estimates): frz, v)
            for k, v in tree.items()
        }
        point_estimates = Vector(pe) if isinstance(primals, Vector) else pe
    if _structure(primals) != _structure(point_estimates):
        raise TypeError("`primals` and `point_estimates` structures do not match")
    liquid, frozen = [], []
    for p, is_frozen in zip(tree_leaves(primals), tree_leaves(point_estimates)):
        (frozen if is_frozen else liquid).append(p)
    return point_estimates, Vector(tuple(liquid)), tuple(frozen)


def _insert_liquid(liquid, bool_tree, frozen, primals_like):
    """Merge liquid and frozen leaves back into the full tree."""
    liquid, frozen = list(tree_leaves(liquid)), list(frozen)
    leaves = [
        frozen.pop(0) if is_frozen else liquid.pop(0)
        for is_frozen in tree_leaves(bool_tree)
    ]
    return tree_unflatten(primals_like, leaves)


def _extract_liquid(full, bool_tree):
    return Vector(tuple(
        leaf for leaf, is_frozen in zip(tree_leaves(full), tree_leaves(bool_tree))
        if not is_frozen
    ))


def _bind(fn: Callable, kw: dict) -> Callable:
    """``fn`` with the keywords ``kw`` bound; ``fn`` itself without any."""
    return partial(fn, **kw) if kw else fn


def _parse_lsm_shape(shape):
    leaves = tree_leaves(shape)
    if leaves and all(isinstance(e, ShapeWithDtype) for e in leaves):
        return shape
    return ShapeWithDtype(shape)


class Likelihood(LazyModel):
    """Base class; see the module docstring.  ``lh(x)`` is the energy.

    Every method takes keyword arguments after its tensors (``**kw``) and
    hands them on: a likelihood composed with a model splits them between
    the model and the likelihood (:meth:`amend`'s ``likelihood_argnames``).
    """

    def __init__(self, *, domain=NoValue, init=NoValue, lsm_tangents_shape=None):
        super().__init__(domain=domain, init=init)
        self._lsm_tan_shp = _parse_lsm_shape(lsm_tangents_shape)

    def forward(self, primals, **kw):
        return self.energy(primals, **kw)

    def energy(self, primals, **kw):
        raise NotImplementedError("`energy` is not implemented")

    def transformation(self, primals, **kw):
        raise NotImplementedError("`transformation` is not implemented")

    def normalized_residual(self, primals, **kw):
        raise NotImplementedError("`normalized_residual` is not implemented")

    def metric(self, primals, tangents, **kw):
        return self.left_sqrt_metric(
            primals, self.right_sqrt_metric(primals, tangents, **kw), **kw)

    def metric_at(self, primals, **kw) -> Callable:
        """The metric matvec at fixed ``primals``, all primal work hoisted."""
        return lambda tangents: self.metric(primals, tangents, **kw)

    #: Whether ``left_sqrt_metric`` is the vjp of ``transformation``, so
    #: that both square roots can come from the transformation's
    #: linearization.  A likelihood without a transformation, or whose
    #: closed-form left square root is another one, takes its right square
    #: root from the transpose of the left one instead.
    lsm_is_transformation_vjp = True

    def left_sqrt_metric(self, primals, tangents, **kw):
        _, fn = vjp(_bind(self.transformation, kw), primals)
        return fn(tangents)

    def right_sqrt_metric(self, primals, tangents, **kw):
        # the transpose of the left square root, linearized at `primals`, so
        # leading batch axes of `primals` carry over to the tangents
        return self.sqrt_metric_at(primals, **kw)[1](tangents)

    def sqrt_metric_at(self, primals, **kw):
        """``(lsm, rsm)`` matvecs at fixed ``primals``: the transformation is
        linearized once, so each matvec is one linear pass.  Without a
        transformation ``rsm`` is the transpose of ``t -> lsm(primals, t)``:
        one backward pass of that linear map (``jax.linear_transpose`` in
        the JAX package)."""
        if (self.lsm_is_transformation_vjp
                and type(self).transformation is not Likelihood.transformation):
            _, fwd, bwd = linearize(_bind(self.transformation, kw), primals)
            return bwd, fwd

        def lsm(t):
            return self.left_sqrt_metric(primals, t, **kw)

        _, rsm = vjp(lsm, self._lsm_zeros(primals))
        return lsm, rsm

    def _lsm_zeros(self, primals):
        """Zero tangents of the left square root, with the leading batch
        axes that ``primals`` has beyond the domain."""
        leaves, like = tree_leaves(primals), tree_leaves(self.domain)
        batch = ()
        if leaves and like:
            batch = tuple(leaves[0].shape[: leaves[0].ndim - len(like[0].shape)])
        device = leaves[0].device if leaves else None
        return tree_map(
            lambda s: torch.zeros(batch + s.shape, dtype=s.dtype, device=device),
            self.lsm_tangents_shape,
        )

    @property
    def left_sqrt_metric_tangents_shape(self):
        return self._lsm_tan_shp

    #: :func:`~nifty_tpu_torch.parallel.shard_position` runs this hook
    #: after the models' (it reads the grids they record)
    _shard_data_ = True

    def _shard_(self, mesh, min_ndim=2):
        """On a field-sharded mesh the data-space white noise is the rank's
        slab where the data is a field (:meth:`~nifty_tpu_torch.parallel.
        Mesh.cuts`, the rule the data follows): such a leaf takes the
        rank's rows."""
        if getattr(self, "_lsm_sharded", False):
            return
        p = mesh.size(mesh.field_axis)

        def local(s):
            if mesh.cuts(s.shape, min_ndim):
                return ShapeWithDtype((s.shape[0] // p,) + tuple(s.shape[1:]), s.dtype)
            return s

        self._lsm_tan_shp = tree_map(local, self._lsm_tan_shp)
        self._lsm_sharded = True

    lsm_tangents_shape = left_sqrt_metric_tangents_shape

    @property
    def right_sqrt_metric_tangents_shape(self):
        return self.domain

    rsm_tangents_shape = right_sqrt_metric_tangents_shape

    def amend(self, f: Callable, /, *, domain=NoValue, likelihood_argnames=None):
        """Compose a forward model to the right of this likelihood; the
        keywords named in ``likelihood_argnames`` go to the likelihood, the
        others to ``f``."""
        return LikelihoodWithModel(self, f, domain=domain,
                                   likelihood_argnames=likelihood_argnames)

    def __add__(self, other):
        return LikelihoodSum(self, other)

    def freeze(self, *, primals, point_estimates):
        """``(partial_likelihood, liquid_primals)`` with the point-estimated
        leaves of ``primals`` inserted as constants."""
        if not point_estimates:
            return self, primals
        lp = LikelihoodPartial(self, primals=primals, point_estimates=point_estimates)
        return lp, lp.splitx(primals)[0]


class LikelihoodPartial(Likelihood):
    """Likelihood with some leaves of its latent tree frozen to constants.

    Liquid primals travel as a :class:`~nifty_tpu_torch.tree.Vector` of the
    tuple of non-frozen leaves.  Liquid leaves with leading batch axes (the
    lockstep stages) get the frozen leaves broadcast to the same axes.
    """

    def __init__(self, likelihood, /, *, primals, point_estimates):
        bool_tree, liquid, frozen = parse_point_estimates(point_estimates, primals)
        super().__init__(
            domain=shape_dtype_like(liquid),
            lsm_tangents_shape=likelihood.lsm_tangents_shape,
        )
        self.likelihood = likelihood
        self.lsm_is_transformation_vjp = likelihood.lsm_is_transformation_vjp
        self.point_estimates = bool_tree
        self.primals_frozen = tuple(f.detach() for f in frozen)
        self._primals_like = shape_dtype_like(primals)
        self._liquid_ndim = tuple(x.ndim for x in tree_leaves(liquid))

    def _batch_shape(self, liquid) -> tuple:
        leaves = tree_leaves(liquid)
        if not leaves:
            return ()
        return tuple(leaves[0].shape[: leaves[0].ndim - self._liquid_ndim[0]])

    def insert(self, liquid):
        batch = self._batch_shape(liquid)
        frozen = tuple(f.expand(batch + tuple(f.shape)) for f in self.primals_frozen)
        return _insert_liquid(liquid, self.point_estimates, frozen, self._primals_like)

    def insert_zeros(self, liquid_tangents):
        batch = self._batch_shape(liquid_tangents)
        zeros = tuple(f.new_zeros(batch + tuple(f.shape)) for f in self.primals_frozen)
        return _insert_liquid(
            liquid_tangents, self.point_estimates, zeros, self._primals_like)

    def remove(self, full):
        return _extract_liquid(full, self.point_estimates)

    def splitx(self, primals):
        return parse_point_estimates(self.point_estimates, primals)[1:]

    def energy(self, primals, **kw):
        return self.likelihood.energy(self.insert(primals), **kw)

    def transformation(self, primals, **kw):
        return self.likelihood.transformation(self.insert(primals), **kw)

    def normalized_residual(self, primals, **kw):
        return self.likelihood.normalized_residual(self.insert(primals), **kw)

    def metric(self, primals, tangents, **kw):
        full = self.likelihood.metric(self.insert(primals), self.insert_zeros(tangents), **kw)
        return self.remove(full)

    def metric_at(self, primals, **kw):
        inner = self.likelihood.metric_at(self.insert(primals), **kw)
        return lambda t: self.remove(inner(self.insert_zeros(t)))

    def left_sqrt_metric(self, primals, tangents, **kw):
        return self.remove(
            self.likelihood.left_sqrt_metric(self.insert(primals), tangents, **kw))

    def right_sqrt_metric(self, primals, tangents, **kw):
        return self.likelihood.right_sqrt_metric(
            self.insert(primals), self.insert_zeros(tangents), **kw)

    def sqrt_metric_at(self, primals, **kw):
        lsm, rsm = self.likelihood.sqrt_metric_at(self.insert(primals), **kw)
        return (
            lambda t: self.remove(lsm(t)),
            lambda t: rsm(self.insert_zeros(t)),
        )


class _Chained(nn.Module):
    """``outer(inner(x, **kw), **left)``: ``left`` the keywords named in
    ``left_argnames``, the others going to ``inner``."""

    def __init__(self, outer: Callable, inner: Callable, left_argnames: tuple):
        super().__init__()
        self.outer, self.inner, self.left_argnames = outer, inner, left_argnames

    def forward(self, primals, **kw):
        left = {k: kw.pop(k) for k in self.left_argnames if k in kw}
        return self.outer(self.inner(primals, **kw), **left)


class LikelihoodWithModel(Likelihood):
    """Likelihood composed with a forward model.

    The model is the submodule ``model`` (``forward`` is taken by
    ``nn.Module``).  The metric pulls the likelihood's metric back through
    the model's hoisted linearization.  Of the keywords of a call, those
    named in ``likelihood_argnames`` go to the likelihood, the others to the
    model.
    """

    def __init__(self, likelihood: Likelihood, f: Callable, /, *, domain=NoValue,
                 init=NoValue, likelihood_argnames=None):
        if not callable(f):
            raise TypeError(f"forward model must be callable; got {f!r}")
        if domain is NoValue and isinstance(f, LazyModel):
            domain = f.domain
        if init is NoValue and isinstance(f, LazyModel):
            init = f.init
        super().__init__(
            domain=domain, init=init,
            lsm_tangents_shape=likelihood.lsm_tangents_shape,
        )
        self.likelihood = likelihood
        self.lsm_is_transformation_vjp = likelihood.lsm_is_transformation_vjp
        self.model = f
        self.likelihood_argnames = tuple(likelihood_argnames or ())

    def _split_kwargs(self, kw):
        """``(the likelihood's keywords, the model's)``; a name of
        ``likelihood_argnames`` that the call does not pass is left to the
        likelihood's default (the JAX package raises there)."""
        kr = dict(kw)
        return {k: kr.pop(k) for k in self.likelihood_argnames if k in kr}, kr

    def energy(self, primals, **kw):
        kl, kr = self._split_kwargs(kw)
        return self.likelihood.energy(self.model(primals, **kr), **kl)

    def transformation(self, primals, **kw):
        kl, kr = self._split_kwargs(kw)
        return self.likelihood.transformation(self.model(primals, **kr), **kl)

    def normalized_residual(self, primals, **kw):
        kl, kr = self._split_kwargs(kw)
        return self.likelihood.normalized_residual(self.model(primals, **kr), **kl)

    def metric(self, primals, tangents, **kw):
        return self.metric_at(primals, **kw)(tangents)

    def metric_at(self, primals, **kw) -> Callable:
        kl, kr = self._split_kwargs(kw)
        y, fwd, bwd = linearize(_bind(self.model, kr), primals)
        inner = self.likelihood.metric_at(y, **kl)
        return lambda tangents: bwd(inner(fwd(tangents)))

    def left_sqrt_metric(self, primals, tangents, **kw):
        kl, kr = self._split_kwargs(kw)
        y, bwd = vjp(_bind(self.model, kr), primals)
        return bwd(self.likelihood.left_sqrt_metric(y, tangents, **kl))

    def sqrt_metric_at(self, primals, **kw):
        kl, kr = self._split_kwargs(kw)
        y, fwd, bwd = linearize(_bind(self.model, kr), primals)
        lsm, rsm = self.likelihood.sqrt_metric_at(y, **kl)
        return lambda t: bwd(lsm(t)), lambda t: rsm(fwd(t))

    def amend(self, f: Callable, /, *, domain=NoValue, left_argnames=None,
              likelihood_argnames=None):
        """Compose ``f`` to the right of this likelihood's model: the
        keywords named in ``left_argnames`` go to the model already here,
        those in ``likelihood_argnames`` (default: this likelihood's) to the
        likelihood, the others to ``f``."""
        if domain is NoValue and isinstance(f, LazyModel):
            domain = f.domain
        la = self.likelihood_argnames if likelihood_argnames is None else likelihood_argnames
        chained = _Chained(self.model, f, tuple(left_argnames or ()))
        return LikelihoodWithModel(self.likelihood, chained, domain=domain,
                                   likelihood_argnames=la)


class LikelihoodSum(Likelihood):
    """Sum of two likelihoods over their united latent domain.

    The data-space trees of the two summands (white noise, the
    transformation, normalized residuals) are kept apart under the keys
    ``lh_left`` / ``lh_right``; each summand keeps its own square roots of
    the metric, and the latent-space results add.
    """

    _lkey, _rkey = "lh_left", "lh_right"

    def __init__(self, left, right, /, domain=NoValue, init=NoValue):
        if not (isinstance(left, Likelihood) and isinstance(right, Likelihood)):
            raise TypeError("both summands must be Likelihoods")
        joined_shape = {self._lkey: left.lsm_tangents_shape,
                        self._rkey: right.lsm_tangents_shape}
        if domain is NoValue and left.domain is not NoValue and right.domain is not NoValue:
            lvec, rvec = isinstance(left.domain, Vector), isinstance(right.domain, Vector)
            domain = {**(left.domain.tree if lvec else left.domain),
                      **(right.domain.tree if rvec else right.domain)}
            domain = Vector(domain) if lvec or rvec else domain
        super().__init__(domain=domain, init=init, lsm_tangents_shape=joined_shape)
        self.left_likelihood = left
        self.right_likelihood = right
        self.lsm_is_transformation_vjp = (left.lsm_is_transformation_vjp
                                          and right.lsm_is_transformation_vjp)

    def _both(self, fn):
        return {self._lkey: fn(self.left_likelihood), self._rkey: fn(self.right_likelihood)}

    def energy(self, primals, **kw):
        return (self.left_likelihood.energy(primals, **kw)
                + self.right_likelihood.energy(primals, **kw))

    def transformation(self, primals, **kw):
        return self._both(lambda lh: lh.transformation(primals, **kw))

    def normalized_residual(self, primals, **kw):
        return self._both(lambda lh: lh.normalized_residual(primals, **kw))

    def metric(self, primals, tangents, **kw):
        return tree_add(self.left_likelihood.metric(primals, tangents, **kw),
                        self.right_likelihood.metric(primals, tangents, **kw))

    def metric_at(self, primals, **kw):
        lm = self.left_likelihood.metric_at(primals, **kw)
        rm = self.right_likelihood.metric_at(primals, **kw)
        return lambda t: tree_add(lm(t), rm(t))

    def left_sqrt_metric(self, primals, tangents, **kw):
        return tree_add(
            self.left_likelihood.left_sqrt_metric(primals, tangents[self._lkey], **kw),
            self.right_likelihood.left_sqrt_metric(primals, tangents[self._rkey], **kw),
        )

    def sqrt_metric_at(self, primals, **kw):
        (l_lsm, l_rsm), (r_lsm, r_rsm) = (self.left_likelihood.sqrt_metric_at(primals, **kw),
                                          self.right_likelihood.sqrt_metric_at(primals, **kw))
        return (
            lambda t: tree_add(l_lsm(t[self._lkey]), r_lsm(t[self._rkey])),
            lambda t: {self._lkey: l_rsm(t), self._rkey: r_rsm(t)},
        )


__all__ = [
    "Likelihood", "LikelihoodPartial", "LikelihoodSum", "LikelihoodWithModel",
    "hessian_vector_product", "linearize",
    "parse_point_estimates", "value_and_grad", "vjp",
]
