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

PyTorch has no ``linear_transpose``.  :func:`linearize` builds the
linearization at a fixed point from reverse mode alone: one forward pass
records the graph, one backward pass with ``create_graph=True`` records
``u -> J^T u`` as a graph linear in ``u``, and differentiating that graph
with respect to ``u`` gives ``t -> J t``.  Both closures reuse the
recorded graphs, so each matvec runs one linear forward and one linear
backward pass and never the nonlinear model again.
"""

from __future__ import annotations

from typing import Callable

import torch

from .model import LazyModel, NoValue
from .tree import ShapeWithDtype, tree_leaves, tree_unflatten


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
    docstring).  Requires every operation in ``f`` to be twice
    differentiable in reverse mode, which the distributor's
    ``autograd.Function`` pair is."""
    xs, p = _leaf_inputs(primals)
    with torch.enable_grad():
        y = f(p)
        ys = tree_leaves(y)
        us = [torch.zeros_like(t, requires_grad=True) for t in ys]
        adj = _grad(ys, xs, us, create_graph=True)

    def jvp_fn(tangents):
        with torch.enable_grad():
            out = _grad(adj, us, tree_leaves(tangents), retain_graph=True)
        return tree_unflatten(y, out)

    def vjp_fn(cotangents):
        with torch.enable_grad():
            gs = _grad(ys, xs, tree_leaves(cotangents), retain_graph=True)
        return tree_unflatten(primals, gs)

    return tree_unflatten(y, [t.detach() for t in ys]), jvp_fn, vjp_fn


def linear_transpose(f: Callable, like):
    """Transpose of the linear map ``f`` whose inputs look like ``like``
    (a tree of :class:`ShapeWithDtype` or tensors)."""

    def transposed(cotangents):
        device = tree_leaves(cotangents)[0].device

        def zero(s):
            return torch.zeros(s.shape, dtype=s.dtype, device=device)

        probe = tree_unflatten(like, [zero(s) for s in tree_leaves(like)])
        _, fn = vjp(f, probe)
        return fn(cotangents)

    return transposed


def _parse_lsm_shape(shape):
    leaves = tree_leaves(shape)
    if leaves and all(isinstance(e, ShapeWithDtype) for e in leaves):
        return shape
    return ShapeWithDtype(shape)


class Likelihood(LazyModel):
    """Base class; see the module docstring.  ``lh(x)`` is the energy."""

    def __init__(self, *, domain=NoValue, init=NoValue, lsm_tangents_shape=None):
        super().__init__(domain=domain, init=init)
        self._lsm_tan_shp = _parse_lsm_shape(lsm_tangents_shape)

    def forward(self, primals):
        return self.energy(primals)

    def energy(self, primals):
        raise NotImplementedError("`energy` is not implemented")

    def transformation(self, primals):
        raise NotImplementedError("`transformation` is not implemented")

    def normalized_residual(self, primals):
        raise NotImplementedError("`normalized_residual` is not implemented")

    def metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, self.right_sqrt_metric(primals, tangents))

    def metric_at(self, primals) -> Callable:
        """The metric matvec at fixed ``primals``, all primal work hoisted."""
        return lambda tangents: self.metric(primals, tangents)

    def left_sqrt_metric(self, primals, tangents):
        _, fn = vjp(self.transformation, primals)
        return fn(tangents)

    def right_sqrt_metric(self, primals, tangents):
        lsm_t = linear_transpose(
            lambda t: self.left_sqrt_metric(primals, t), self.lsm_tangents_shape
        )
        return lsm_t(tangents)

    def sqrt_metric_at(self, primals):
        """``(lsm, rsm)`` matvecs at fixed ``primals``."""
        return (
            lambda t: self.left_sqrt_metric(primals, t),
            lambda t: self.right_sqrt_metric(primals, t),
        )

    @property
    def left_sqrt_metric_tangents_shape(self):
        return self._lsm_tan_shp

    lsm_tangents_shape = left_sqrt_metric_tangents_shape

    @property
    def right_sqrt_metric_tangents_shape(self):
        return self.domain

    rsm_tangents_shape = right_sqrt_metric_tangents_shape

    def amend(self, f: Callable, /, *, domain=NoValue):
        """Compose a forward model to the right of this likelihood."""
        return LikelihoodWithModel(self, f, domain=domain)

    def freeze(self, *, primals, point_estimates):
        """``(likelihood, liquid_primals)``; point estimates are not ported
        yet, so only an empty set is accepted."""
        if point_estimates:
            raise NotImplementedError("point estimates are not ported yet")
        return self, primals


class LikelihoodWithModel(Likelihood):
    """Likelihood composed with a forward model.

    The model is the submodule ``model`` (``forward`` is taken by
    ``nn.Module``).  The metric pulls the likelihood's metric back through
    the model's hoisted linearization.
    """

    def __init__(self, likelihood: Likelihood, f: Callable, /, *, domain=NoValue,
                 init=NoValue):
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
        self.model = f

    def energy(self, primals):
        return self.likelihood.energy(self.model(primals))

    def transformation(self, primals):
        return self.likelihood.transformation(self.model(primals))

    def normalized_residual(self, primals):
        return self.likelihood.normalized_residual(self.model(primals))

    def metric(self, primals, tangents):
        return self.metric_at(primals)(tangents)

    def metric_at(self, primals) -> Callable:
        y, fwd, bwd = linearize(self.model, primals)
        inner = self.likelihood.metric_at(y)
        return lambda tangents: bwd(inner(fwd(tangents)))

    def left_sqrt_metric(self, primals, tangents):
        y, bwd = vjp(self.model, primals)
        return bwd(self.likelihood.left_sqrt_metric(y, tangents))

    def right_sqrt_metric(self, primals, tangents):
        return self.sqrt_metric_at(primals)[1](tangents)

    def sqrt_metric_at(self, primals):
        y, fwd, bwd = linearize(self.model, primals)
        lh = self.likelihood
        return (
            lambda t: bwd(lh.left_sqrt_metric(y, t)),
            lambda t: lh.right_sqrt_metric(y, fwd(t)),
        )


__all__ = [
    "Likelihood", "LikelihoodWithModel", "hessian_vector_product",
    "linear_transpose", "linearize", "value_and_grad", "vjp",
]
