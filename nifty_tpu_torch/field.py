"""Volume-aware fields over :class:`~nifty_tpu_torch.domains.DomainTuple`
(counterpart of :mod:`nifty_tpu.field`).

A :class:`Field` is one tensor plus its domain tuple; arithmetic is
elementwise, and the volume-aware operations (``weight``, ``vdot``,
``integrate``) read the domains' ``dvol``.  ``power_analyze`` and
``dof_distributor`` run through the power distributor
(:mod:`nifty_tpu_torch.ops.bin_gather`), so on the card its kernels serve
them.  Tensors land on the configured device unless given.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from . import config
from .domains import DOFSpace, DomainTuple, PowerSpace, RGSpace
from .ops.bin_gather import BinIndex, distribute_power, segment_sum
from .tree import ShapeWithDtype, random_like


class Field:
    """A tensor and a DomainTuple, with volume calculus."""

    def __init__(self, domain, val):
        self._domain = DomainTuple.make(domain)
        self._val = val

    @property
    def domain(self):
        return self._domain

    @property
    def val(self):
        return self._val

    @property
    def shape(self):
        return self._domain.shape

    @property
    def size(self):
        return self._domain.size

    @property
    def dtype(self):
        return self._val.dtype

    # -- constructors -----------------------------------------------------
    @classmethod
    def full(cls, domain, value):
        domain = DomainTuple.make(domain)
        return cls(domain, torch.full(domain.shape, value, dtype=config.default_float_dtype(),
                                      device=config.default_device()))

    @classmethod
    def from_random(cls, domain, key, dtype=None):
        """Standard-normal values from ``key`` (an int seed, a
        ``torch.Generator`` or a noise provider such as ``HostKey``)."""
        domain = DomainTuple.make(domain)
        return cls(domain, random_like(key, ShapeWithDtype(domain.shape, dtype)))

    # -- volume calculus --------------------------------------------------
    def _dvol_factor(self, power=1):
        fct = 1.0
        arrays = []
        for i, d in enumerate(self._domain):
            sd = d.scalar_dvol
            if sd is not None:
                fct *= sd ** power
            else:
                dv = np.asarray(d.dvol) ** power
                ax = self._domain.axes[i]
                arrays.append(dv.reshape(
                    [self.shape[a] if a in ax else 1 for a in range(len(self.shape))]))
        return fct, arrays

    def weight(self, power=1):
        """Multiply by the pixel volume to the given power."""
        fct, arrays = self._dvol_factor(power)
        val = self._val * fct
        for a in arrays:
            val = val * torch.as_tensor(a, dtype=val.dtype, device=val.device)
        return Field(self._domain, val)

    def vdot(self, other: "Field"):
        if self._domain != other._domain:
            raise ValueError("domain mismatch")
        return torch.sum(self.weight(1)._val.conj() * other._val)

    def integrate(self):
        return torch.sum(self.weight(1)._val)

    def s_sum(self):
        return torch.sum(self._val)

    def s_mean(self):
        return torch.mean(self._val)

    def s_var(self):
        return torch.var(self._val, correction=0)

    def s_std(self):
        return torch.std(self._val, correction=0)

    def norm(self, ord=2):
        return torch.linalg.vector_norm(self._val.reshape(-1), ord=ord)

    # -- arithmetic -------------------------------------------------------
    def _binary(self, other, op):
        if isinstance(other, Field):
            if self._domain != other._domain:
                raise ValueError("domain mismatch")
            return Field(self._domain, op(self._val, other._val))
        return Field(self._domain, op(self._val, other))

    def __add__(self, o):
        return self._binary(o, operator.add)

    def __radd__(self, o):
        return self._binary(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __rmul__(self, o):
        return self._binary(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binary(o, operator.pow)

    def __neg__(self):
        return Field(self._domain, -self._val)

    def __abs__(self):
        return Field(self._domain, torch.abs(self._val))

    def ptw(self, name, *args, **kwargs):
        """Pointwise function application by name (exp/log/sqrt/...)."""
        return Field(self._domain, getattr(torch, name)(self._val, *args, **kwargs))

    def exp(self):
        return self.ptw("exp")

    def log(self):
        return self.ptw("log")

    def sqrt(self):
        return self.ptw("sqrt")

    def __repr__(self):
        return f"Field(domain={self._domain}, shape={self.shape}, dtype={self.dtype})"


def makeField(domain, arr) -> Field:
    """A field of ``arr`` (a tensor, kept where it is, or an array, placed on
    the configured device)."""
    if not torch.is_tensor(arr):
        arr = torch.as_tensor(np.asarray(arr), device=config.default_device())
    return Field(DomainTuple.make(domain), arr)


def full(domain, value) -> Field:
    return Field.full(domain, value)


def from_random(domain, key, dtype=None) -> Field:
    return Field.from_random(domain, key, dtype)


def power_analyze(field: Field, binbounds=None) -> Field:
    """The power spectrum of a field on a harmonic RGSpace: the mean of
    |f_k|^2 over each bin, the per-bin sums by the distributor's segment sum."""
    if len(field.domain) != 1 or not isinstance(field.domain[0], RGSpace) \
            or not field.domain[0].harmonic:
        raise ValueError("power_analyze requires a single harmonic RGSpace")
    pspace = PowerSpace(field.domain[0], binbounds=binbounds)
    val = field.val
    dist = BinIndex(pspace.pindex, nb=pspace.shape[0]).to(val.device)
    power = segment_sum(torch.abs(val) ** 2, dist)
    counts = torch.as_tensor(pspace.dvol, dtype=power.dtype, device=val.device)
    return Field(DomainTuple.make(pspace), power / counts)


def dof_distributor(dofdex, partner=None):
    """Linear map distributing degrees of freedom onto a target grid.

    ``dofdex`` is a static integer array associating every pixel of the
    target with one DOF (bins contiguous from 0, none empty).  Returns
    ``(times, dof_space)``: ``times`` maps a ``(..., n_dof)`` tensor onto
    ``(..., *dofdex.shape)`` through the power distributor, whose autograd
    transpose is the per-DOF segment sum; ``dof_space`` carries each DOF's
    target volume (pixel counts, weighted by the partner's pixel volumes).
    """
    idx = np.asarray(dofdex)
    if not np.issubdtype(idx.dtype, np.integer):
        raise TypeError("dofdex must contain integer numbers")
    nbin = int(idx.max()) + 1 if idx.size else 0
    if partner is not None and partner.scalar_dvol is None:
        wgt = np.bincount(idx.ravel(), minlength=nbin, weights=np.asarray(partner.dvol).ravel())
    else:
        wgt = np.bincount(idx.ravel(), minlength=nbin).astype(np.float64)
        if partner is not None:
            wgt = wgt * partner.scalar_dvol
    if (wgt == 0).any():
        raise ValueError("empty bins detected")
    dof_space = DOFSpace(wgt)
    dists = {}

    def times(x):
        if x.device not in dists:
            dists[x.device] = BinIndex(idx, nb=nbin).to(x.device)
        return distribute_power(x, dists[x.device])

    return times, dof_space


def create_power_operator(harmonic_domain: RGSpace, power_spectrum):
    """Diagonal covariance from a spectrum on a harmonic grid, as a callable
    ``x -> diag * x`` (a function of |k| or the values themselves)."""
    k = harmonic_domain.get_k_length_array()
    diag = power_spectrum(k) if callable(power_spectrum) else torch.as_tensor(
        power_spectrum, device=k.device)

    def apply(x):
        return diag.to(x.device) * x

    return apply
