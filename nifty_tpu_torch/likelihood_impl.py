"""Concrete likelihoods (counterpart of :mod:`nifty_tpu.likelihood_impl`).

Each class gives the negative log-likelihood, its Fisher metric and a
closed-form left square root of the metric.  Data is a tensor or a tree of
tensors (a dict, a list, a tuple), held as buffers so that ``.to()`` moves
it; data that is not a tensor yet lands on the configured default device.
Every method also takes primals with leading batch axes against the
unbatched data (the lockstep stages and the stacked KL stage): the energy
of a stack is then the sum of the rows' energies.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from . import config
from .likelihood import Likelihood
from .tree import (
    ShapeWithDtype,
    result_type,
    shape_dtype_like,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tsum,
    vdot,
)


class _TreeBuffers(nn.Module):
    """A tree of tensors kept as one buffer a leaf, so ``.to()`` moves them;
    ``tree`` rebuilds the tree."""

    def __init__(self, tree):
        super().__init__()
        self._like = shape_dtype_like(tree)
        for i, leaf in enumerate(tree_leaves(tree)):
            self.register_buffer(str(i), leaf)

    @property
    def tree(self):
        return tree_unflatten(self._like, list(self.buffers()))

    #: placed after the models (:func:`~nifty_tpu_torch.parallel.
    #: shard_position`)
    _shard_data_ = True

    def _shard_(self, mesh, min_ndim=2):
        """Keep this rank's slab of each field-sharded leaf on ``mesh``
        (:func:`~nifty_tpu_torch.parallel.mesh.shard_position`)."""
        if getattr(self, "_sharded", False):
            return
        from .parallel.mesh import shard_tree_buffers

        shard_tree_buffers(self, mesh, min_ndim)
        self._sharded = True


def _as_tensors(tree, device=None):
    """Leaves that are not tensors yet become tensors on ``device`` (default:
    the configured default device); every leaf takes the precision in force
    (:func:`~nifty_tpu_torch.config.canonical`)."""
    if device is None and not all(torch.is_tensor(d) for d in tree_leaves(tree)):
        device = config.default_device()
    return tree_map(lambda d: config.canonical(
        d if torch.is_tensor(d) else torch.as_tensor(d, device=device)), tree)


def _sampling_dtype(dtype) -> torch.dtype:
    """The white noise's dtype: Python's ``float`` (the JAX package's
    default) is the default float dtype, ``complex`` the default complex
    one; numpy dtypes map to their torch namesakes, in the precision in
    force."""
    if dtype is float:
        return config.default_float_dtype()
    if dtype is complex:
        return config.default_complex_dtype()
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, np.dtype(dtype).name)
    return config.canonical_dtype(dtype)


def _shapes(tree, dtype):
    dtype = _sampling_dtype(dtype)
    return tree_map(lambda d: ShapeWithDtype(tuple(d.shape), dtype), tree)


def _require_integer(data, name):
    dt = result_type(data)
    if dt.is_floating_point or dt.is_complex or dt == torch.bool:
        raise TypeError(f"{name} `data` must have integer dtype")


def _as_diag_ops(cov_inv, std_inv, data):
    """The noise of a likelihood with fixed (diagonal) noise: returns
    ``(fns, diags)``, the callables among ``cov_inv`` / ``std_inv`` and a
    ``ModuleDict`` of the others, trees of diagonals applied leaf by leaf.
    A missing one is inferred from the other assuming a diagonal
    covariance, from the ones of each leaf's real part; with neither the
    noise is the identity."""
    fns = {"cov_inv": cov_inv if callable(cov_inv) else None,
           "std_inv": std_inv if callable(std_inv) else None}
    device = tree_leaves(data)[0].device
    diags = nn.ModuleDict({
        name: _TreeBuffers(tree_map(
            lambda v: config.canonical(torch.as_tensor(v, device=device)), op))
        for name, op in (("cov_inv", cov_inv), ("std_inv", std_inv))
        if op is not None and not callable(op)
    })
    noise = _DiagNoise(fns, diags)
    with torch.no_grad():
        ones = tree_map(lambda d: torch.ones_like(d.real), data)
        if cov_inv is None and std_inv is not None:
            diags["cov_inv"] = _TreeBuffers(tree_map(torch.square, noise.noise_std_inv(ones)))
        elif std_inv is None and cov_inv is not None:
            diags["std_inv"] = _TreeBuffers(tree_map(torch.sqrt, noise.noise_cov_inv(ones)))
    return fns, diags


class _DiagNoise:
    """``noise_cov_inv`` / ``noise_std_inv`` from the pair
    :func:`_as_diag_ops` returns, held as ``_fns`` and ``_diags``."""

    def __init__(self, fns, diags):
        self._fns, self._diags = fns, diags

    def _noise(self, name, x):
        fn = self._fns[name]
        if fn is not None:
            return fn(x)
        if name not in self._diags:
            return x
        return tree_map(torch.mul, x, self._diags[name].tree)

    def noise_cov_inv(self, x):
        return self._noise("cov_inv", x)

    def noise_std_inv(self, x):
        return self._noise("std_inv", x)


class _DataLikelihood(Likelihood):
    """A likelihood holding a tree of data tensors as buffers, whose domain
    and white noise are both shaped like ``shapes``."""

    def __init__(self, data, shapes):
        super().__init__(domain=shapes, lsm_tangents_shape=shapes)
        self._data = _TreeBuffers(data)

    @property
    def data(self):
        return self._data.tree


class Gaussian(_DiagNoise, _DataLikelihood):
    """Gaussian likelihood with fixed noise covariance.

    ``energy = 0.5 (d - x)^dagger N^-1 (d - x)``; the metric is ``N^-1`` and
    its left square root ``N^-1/2``.  ``data`` is a tensor or a tree of
    tensors, real or complex.  ``noise_cov_inv`` and ``noise_std_inv`` are
    callables on such trees, or trees of diagonals (see
    :func:`_as_diag_ops`); the diagonals follow the data's device.
    """

    def __init__(self, data, noise_cov_inv: Optional[Callable] = None,
                 noise_std_inv: Optional[Callable] = None):
        data = _as_tensors(data)
        _DataLikelihood.__init__(self, data, shape_dtype_like(data))
        self._fns, self._diags = _as_diag_ops(noise_cov_inv, noise_std_inv, data)

    def energy(self, primals):
        res = tree_map(torch.sub, self.data, primals)
        return 0.5 * vdot(res, self.noise_cov_inv(res)).real

    def normalized_residual(self, primals):
        return self.noise_std_inv(tree_map(torch.sub, self.data, primals))

    def metric(self, primals, tangents):
        return self.noise_cov_inv(tangents)

    def left_sqrt_metric(self, primals, tangents):
        return self.noise_std_inv(tangents)

    def transformation(self, primals):
        return self.noise_std_inv(primals)


def _studentt_energy(nwr, dof):
    """Negative log-pdf of a standard Student-t of ``dof`` degrees of
    freedom, summed over the entries (up to a constant)."""
    def leaf(r):
        sq = (r.conj() * r).real if r.is_complex() else r * r
        return torch.log1p(sq / dof) * (dof + 1)

    return tsum(tree_map(leaf, nwr)) / 2.0


def _scalar_or_buffer(module, name, value, device):
    """``value`` as a Python number, or as a buffer ``name`` of ``module``."""
    if isinstance(value, (int, float)):
        setattr(module, name, float(value))
    else:
        module.register_buffer(name, config.canonical(torch.as_tensor(value, device=device)))


class StudentT(_DiagNoise, _DataLikelihood):
    """Student's t likelihood with fixed scale and ``dof`` degrees of
    freedom; the noise is given as for :class:`Gaussian`."""

    def __init__(self, data, dof, noise_cov_inv=None, noise_std_inv=None):
        data = _as_tensors(data)
        _DataLikelihood.__init__(self, data, shape_dtype_like(data))
        self._fns, self._diags = _as_diag_ops(noise_cov_inv, noise_std_inv, data)
        _scalar_or_buffer(self, "dof", dof, tree_leaves(data)[0].device)

    def _fct(self):
        return (self.dof + 1) / (self.dof + 3)

    def energy(self, primals):
        res = tree_map(torch.sub, self.data, primals)
        return _studentt_energy(self.noise_std_inv(res), self.dof)

    def metric(self, primals, tangents):
        fct = self._fct()
        return self.noise_cov_inv(tree_map(lambda t: fct * t, tangents))

    def left_sqrt_metric(self, primals, tangents):
        fct = self._fct() ** 0.5
        return self.noise_std_inv(tree_map(lambda t: fct * t, tangents))

    def normalized_residual(self, primals):
        return self.left_sqrt_metric(None, tree_map(torch.sub, self.data, primals))

    def transformation(self, primals):
        fct = self._fct() ** 0.5
        return self.noise_std_inv(tree_map(lambda p: fct * p, primals))


class Poissonian(_DataLikelihood):
    """Poisson counts likelihood; ``energy = sum(x) - d^T log(x)``.

    The transformation ``2 sqrt(x)`` maps to a unit-metric space, so
    ``lsm(t) = t / sqrt(x)`` and the metric is ``1/x``.  ``data`` must be of
    an integer type.
    """

    def __init__(self, data, sampling_dtype=float):
        data = _as_tensors(data)
        _require_integer(data, "Poissonian")
        super().__init__(data, _shapes(data, sampling_dtype))

    def energy(self, primals):
        return tsum(primals) - vdot(tree_map(torch.log, primals), self.data)

    def metric(self, primals, tangents):
        return tree_map(torch.div, tangents, primals)

    def left_sqrt_metric(self, primals, tangents):
        return tree_map(lambda t, p: t / torch.sqrt(p), tangents, primals)

    def normalized_residual(self, primals):
        res = tree_map(lambda d, p: d - p, self.data, primals)
        return self.left_sqrt_metric(primals, res)

    def transformation(self, primals):
        return tree_map(lambda p: 2.0 * torch.sqrt(p), primals)


class VariableCovarianceGaussian(_DataLikelihood):
    """Gaussian likelihood with an inferred diagonal covariance.

    Acts on a tuple ``(mean, std_inv)``.  The Fisher metric is diagonal in
    these coordinates, ``diag(std_inv^2, 2 ndof / std_inv^2)``, where ``ndof``
    is the number of real degrees of freedom of an entry (2 with
    ``iscomplex``).  The left square root is that diagonal's root, not the
    vjp of the (local) transformation, so the right one is its transpose.
    """

    lsm_is_transformation_vjp = False

    def __init__(self, data, iscomplex=False):
        data = _as_tensors(data)
        super().__init__(data, shape_dtype_like((data, data.real)))
        self.iscomplex = iscomplex

    @property
    def _ndof(self) -> int:
        return 2 if self.iscomplex else 1

    def energy(self, primals):
        mean, std_inv = primals
        res = (self.data - mean) * std_inv
        return 0.5 * vdot(res, res).real - self._ndof * torch.log(std_inv).sum()

    def metric(self, primals, tangents):
        prec = primals[1] ** 2
        return type(primals)((prec * tangents[0], (2 * self._ndof) * tangents[1] / prec))

    def left_sqrt_metric(self, primals, tangents):
        scale_curv = 2.0 ** (0.5 * self._ndof)
        return type(primals)((primals[1] * tangents[0], scale_curv * tangents[1] / primals[1]))

    def transformation(self, primals):
        # no global Euclidean transformation exists; the local
        # residual-based one, as in the JAX package
        return type(primals)((primals[1] * (primals[0] - self.data),
                              self._ndof * torch.log(primals[1])))

    def normalized_residual(self, primals):
        return (self.data - primals[0]) * primals[1]


class VariableCovarianceStudentT(_DataLikelihood):
    """Student's t likelihood with an inferred scale; acts on ``(mean,
    std)``.  It has no transformation: the right square root of the metric
    is the transpose of the closed-form left one."""

    def __init__(self, data, dof):
        data = _as_tensors(data)
        super().__init__(data, shape_dtype_like((data, data)))
        _scalar_or_buffer(self, "dof", dof, data.device)

    def energy(self, primals):
        t = _studentt_energy((self.data - primals[0]) / primals[1], self.dof)
        return t + torch.log(primals[1]).sum()

    def metric(self, primals, tangents):
        d = self.dof
        return type(primals)((
            tangents[0] * (d + 1) / (d + 3) / primals[1] ** 2,
            tangents[1] * 2 * d / (d + 3) / primals[1] ** 2,
        ))

    def left_sqrt_metric(self, primals, tangents):
        d = self.dof
        c0 = (d + 1) / (d + 3) / primals[1] ** 2
        c1 = 2 * d / (d + 3) / primals[1] ** 2
        return type(primals)((torch.sqrt(c0) * tangents[0], torch.sqrt(c1) * tangents[1]))

    def normalized_residual(self, primals):
        d = self.dof
        return (self.data - primals[0]) / primals[1] * ((d + 1) / (d + 3)) ** 0.5


class Categorical(_DataLikelihood):
    """Categorical (cross-entropy) likelihood over logits.

    ``data`` holds integer labels with the logits' shape but 1 along
    ``axis``, as ``take_along_axis`` wants them.  ``axis`` counts from the
    end, so that logits with leading batch axes work.  It has no
    transformation: the right square root is the transpose of the left.
    """

    def __init__(self, data, axis=-1, sampling_dtype=float):
        data = _as_tensors(data)
        super().__init__(data, _shapes(data, sampling_dtype))
        ndim = tree_leaves(data)[0].ndim
        self.axis = axis - ndim if axis >= 0 else axis

    def energy(self, primals):
        def nll(p, d):
            logits = torch.log_softmax(p, dim=self.axis)
            labels = d.expand(tuple(p.shape[: p.ndim - d.ndim]) + tuple(d.shape))
            return -torch.gather(logits, self.axis, labels).sum()

        return tsum(tree_map(nll, primals, self.data))

    def metric(self, primals, tangents):
        def leaf(p, t):
            pred = torch.softmax(p, dim=self.axis)
            norm = (pred * t).sum(dim=self.axis, keepdim=True)
            return pred * t - pred * norm

        return tree_map(leaf, primals, tangents)

    def left_sqrt_metric(self, primals, tangents):
        def leaf(p, t):
            s = torch.sqrt(torch.softmax(p, dim=self.axis))
            norm = (s * t).sum(dim=self.axis, keepdim=True)
            return s * (t - s * norm)

        return tree_map(leaf, primals, tangents)


class Bernoulli(_DataLikelihood):
    """Bernoulli event likelihood; ``energy = -d^T log p - (1-d)^T
    log(1-p)`` for event frequencies ``p`` in (0, 1) and integer events
    ``d`` (1) / non-events (0).  The metric is ``1/(p(1-p))`` and the
    arcsine transformation ``2 asin(sqrt(p))`` maps to a unit-metric
    space."""

    def __init__(self, data, sampling_dtype=float):
        data = _as_tensors(data)
        _require_integer(data, "Bernoulli")
        super().__init__(data, _shapes(data, sampling_dtype))

    def energy(self, primals):
        return -vdot(tree_map(torch.log, primals), self.data) + vdot(
            tree_map(lambda p: torch.log1p(-p), primals),
            tree_map(lambda d: d - 1, self.data),
        )

    def metric(self, primals, tangents):
        return tree_map(lambda t, p: t / (p * (1.0 - p)), tangents, primals)

    def left_sqrt_metric(self, primals, tangents):
        return tree_map(lambda t, p: t / torch.sqrt(p * (1.0 - p)), tangents, primals)

    def normalized_residual(self, primals):
        res = tree_map(lambda d, p: d - p, self.data, primals)
        return self.left_sqrt_metric(primals, res)

    def transformation(self, primals):
        return tree_map(lambda p: 2.0 * torch.arcsin(torch.sqrt(p)), primals)


class InverseGamma(Likelihood):
    """Inverse-gamma likelihood of a variance field ``x``:
    ``energy = sum((alpha+1) log x + beta / x)``, the likelihood of the
    variance ``x = S_k`` given ``beta = 0.5 |s_k|^2``.  Transformation
    ``sqrt(alpha+1) log x`` (metric ``(alpha+1)/x^2``).  A scalar ``alpha``
    is broadcast over every leaf of ``beta``."""

    def __init__(self, beta, alpha=-0.5, sampling_dtype=float):
        beta = _as_tensors(beta)
        shp = _shapes(beta, sampling_dtype)
        super().__init__(domain=shp, lsm_tangents_shape=shp)
        if isinstance(alpha, dict) or (torch.is_tensor(beta) and torch.is_tensor(alpha)
                                       and alpha.ndim > 0):
            alpha = _as_tensors(alpha, tree_leaves(beta)[0].device)
        else:
            alpha = tree_map(lambda b: torch.as_tensor(
                alpha, dtype=torch.promote_types(b.dtype, config.default_float_dtype()),
                device=b.device,
            ).expand(b.shape).clone(), beta)
        self._beta = _TreeBuffers(beta)
        self._alpha = _TreeBuffers(alpha)

    @property
    def beta(self):
        return self._beta.tree

    @property
    def alpha(self):
        return self._alpha.tree

    def energy(self, primals):
        ap1 = tree_map(lambda a: a + 1.0, self.alpha)
        return vdot(tree_map(torch.log, primals), ap1) + vdot(
            tree_map(torch.reciprocal, primals), self.beta)

    def metric(self, primals, tangents):
        return tree_map(lambda t, p, a: (a + 1.0) * t / (p * p), tangents, primals, self.alpha)

    def left_sqrt_metric(self, primals, tangents):
        return tree_map(lambda t, p, a: torch.sqrt(a + 1.0) * t / p,
                        tangents, primals, self.alpha)

    def normalized_residual(self, primals):
        res = tree_map(lambda b, p: 2.0 * b - p, self.beta, primals)
        return self.left_sqrt_metric(primals, res)

    def transformation(self, primals):
        return tree_map(lambda p, a: torch.sqrt(a + 1.0) * torch.log(p), primals, self.alpha)


__all__ = [
    "Bernoulli", "Categorical", "Gaussian", "InverseGamma", "Poissonian",
    "StudentT", "VariableCovarianceGaussian", "VariableCovarianceStudentT",
]
