"""Domain descriptors (counterpart of :mod:`nifty_tpu.domains`).

Domains are immutable host metadata, hashable and compared by value:
shape and pixel volumes.  :class:`RGSpace` (a regular grid, position or
harmonic), :class:`UnstructuredDomain`, :class:`DOFSpace`,
:class:`PowerSpace`, :class:`LMSpace`, :class:`GLSpace`, :class:`HPSpace`
and their product :class:`DomainTuple`.  Volumes are numpy (host) values;
``get_k_length_array`` gives a float64 tensor on the configured device.
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from . import config


class Domain:
    """Abstract grid descriptor: shape + volume metadata."""

    _shape: Tuple[int, ...] = ()
    harmonic: bool = False

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(np.prod(self._shape, dtype=np.int64)) if self._shape else 1

    @property
    def scalar_dvol(self) -> Optional[float]:
        """Pixel volume if constant across the domain, else None."""
        return None

    @property
    def dvol(self):
        """Pixel volume(s); scalar or array of shape ``self.shape``."""
        sd = self.scalar_dvol
        return sd if sd is not None else self._dvol_array()

    def _dvol_array(self):
        raise NotImplementedError()

    @property
    def total_volume(self):
        sd = self.scalar_dvol
        if sd is not None:
            return sd * self.size
        return float(np.sum(self._dvol_array()))

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__, self._key()))

    def _key(self):
        return self._shape

    def __repr__(self):
        return f"{type(self).__name__}(shape={self._shape})"


def _on_device(arr):
    return torch.as_tensor(np.asarray(arr, dtype=np.float64), device=config.default_device())


class UnstructuredDomain(Domain):
    """Structureless data arrays (unit volume)."""

    def __init__(self, shape):
        self._shape = (shape,) if isinstance(shape, int) else tuple(shape)

    @property
    def scalar_dvol(self):
        return 1.0


class DOFSpace(Domain):
    """Space of generic degrees of freedom with per-DOF multiplicities: the
    domain of a :func:`nifty_tpu_torch.field.dof_distributor`, entry ``i``
    carrying the total volume of the target pixels mapped onto DOF ``i``."""

    def __init__(self, dof_weights):
        w = np.asarray(dof_weights, dtype=np.float64)
        if w.ndim != 1 or w.size == 0:
            raise ValueError("dof_weights must be a non-empty 1-D sequence")
        self._weights = tuple(w.tolist())
        self._shape = (w.size,)

    def _dvol_array(self):
        return np.asarray(self._weights)

    def _key(self):
        return self._weights


class RGSpace(Domain):
    """Regular Cartesian grid, position-space or harmonic."""

    def __init__(self, shape, distances=None, harmonic: bool = False):
        self._shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.harmonic = bool(harmonic)
        if distances is None:
            if harmonic:
                distances = (1.0,) * len(self._shape)
            else:
                distances = tuple(1.0 / s for s in self._shape)
        elif np.isscalar(distances):
            distances = (float(distances),) * len(self._shape)
        self._distances = tuple(float(d) for d in distances)

    @property
    def distances(self):
        return self._distances

    @property
    def scalar_dvol(self):
        return float(np.prod(self._distances))

    def _key(self):
        return (self._shape, self._distances, self.harmonic)

    def k_lengths_numpy(self):
        """|k| of every mode (host float64); on a harmonic grid the
        distances are the mode spacings."""
        if not self.harmonic:
            raise ValueError("k-lengths only defined on harmonic grids")
        m2 = np.zeros(self._shape)
        for i, (n, d) in enumerate(zip(self._shape, self._distances)):
            k = np.arange(n)
            k = np.minimum(k, n - k) * d
            sl = [None] * len(self._shape)
            sl[i] = slice(None)
            m2 = m2 + (k ** 2)[tuple(sl)]
        return np.sqrt(m2)

    def get_k_length_array(self):
        return _on_device(self.k_lengths_numpy())

    def get_default_codomain(self) -> "RGSpace":
        distances = tuple(1.0 / (n * d) for n, d in zip(self._shape, self._distances))
        return RGSpace(self._shape, distances, harmonic=not self.harmonic)

    def get_fft_smoothing_kernel_function(self, sigma):
        if not self.harmonic:
            raise ValueError("smoothing kernel defined on harmonic grids")
        return lambda k: torch.exp(-2.0 * (np.pi * sigma) ** 2 * k ** 2)


class PowerSpace(Domain):
    """1-D space of power-spectrum bins over a harmonic partner: ``pindex``
    maps every mode to its bin, ``k_lengths`` are the bins' mean |k| and the
    bins' volumes their multiplicities."""

    def __init__(self, harmonic_partner: RGSpace, binbounds=None):
        if not isinstance(harmonic_partner, RGSpace) or not harmonic_partner.harmonic:
            raise ValueError("harmonic partner must be a harmonic RGSpace")
        self._hp = harmonic_partner
        k = harmonic_partner.k_lengths_numpy()
        if binbounds is None:
            um = np.unique(k)
            tol = 1e-12 * um[-1]
            um = um[np.diff(np.append(um, 2 * um[-1])) > tol]
            bb = 0.5 * (um[:-1] + um[1:])
        else:
            bb = np.asarray(binbounds)
        self._binbounds = tuple(bb.tolist())
        self._pindex = np.searchsorted(bb, k).astype(np.int32)
        nbin = int(self._pindex.max()) + 1
        self._shape = (nbin,)
        counts = np.bincount(self._pindex.ravel(), minlength=nbin)
        ksum = np.bincount(self._pindex.ravel(), weights=k.ravel(), minlength=nbin)
        self._k_lengths = ksum / counts
        self._dvol = counts.astype(float)

    @classmethod
    def useful_binbounds(cls, space, logarithmic=False, nbin=None):
        um = np.unique(space.k_lengths_numpy())
        if not logarithmic and nbin is None:
            return None
        kmax, kmin = um[-1], um[1]
        if logarithmic:
            nbin = nbin if nbin is not None else 2 * int(np.log2(len(um)))
            return np.geomspace(kmin, kmax, nbin)[:-1]
        return np.linspace(kmin, kmax, nbin)[:-1]

    @property
    def harmonic_partner(self):
        return self._hp

    @property
    def pindex(self):
        return self._pindex

    @property
    def k_lengths(self):
        return self._k_lengths

    @property
    def binbounds(self):
        return self._binbounds

    def _dvol_array(self):
        return self._dvol

    def _key(self):
        return (self._hp._key(), self._binbounds)


def _gauss_legendre(nlat):
    x, w = np.polynomial.legendre.leggauss(nlat)
    # colatitude in [0, pi], descending z = cos(theta)
    return np.arccos(x[::-1]), w[::-1]


class LMSpace(Domain):
    """Spherical-harmonic coefficient space in the real packing: the m = 0
    column and the real and imaginary parts of a_lm for m > 0,
    ``(lmax+1)^2`` coefficients at ``mmax = lmax``."""

    def __init__(self, lmax: int, mmax: Optional[int] = None):
        self._lmax = int(lmax)
        self._mmax = int(mmax) if mmax is not None else self._lmax
        n = (self._lmax + 1) + sum(2 * (self._lmax + 1 - m) for m in range(1, self._mmax + 1))
        self._shape = (n,)
        self.harmonic = True

    @property
    def lmax(self):
        return self._lmax

    @property
    def mmax(self):
        return self._mmax

    @property
    def scalar_dvol(self):
        return 1.0

    def _key(self):
        return (self._lmax, self._mmax)

    def get_default_codomain(self):
        return GLSpace(self._lmax + 1)

    def get_k_length_array(self):
        """l of every real coefficient (for smoothing kernels)."""
        ls = [np.arange(self._lmax + 1)]
        for m in range(1, self._mmax + 1):
            ls.append(np.repeat(np.arange(m, self._lmax + 1), 2))
        return _on_device(np.concatenate(ls).astype(float))

    def get_fft_smoothing_kernel_function(self, sigma):
        return lambda l: torch.exp(-0.5 * l * (l + 1) * sigma ** 2)


class GLSpace(Domain):
    """Gauss-Legendre sphere pixelization (exact quadrature; weights from
    ``numpy.polynomial.legendre.leggauss``)."""

    def __init__(self, nlat: int, nlon: Optional[int] = None):
        self._nlat = int(nlat)
        self._nlon = int(nlon) if nlon is not None else 2 * self._nlat - 1
        self._shape = (self._nlat * self._nlon,)

    @property
    def nlat(self):
        return self._nlat

    @property
    def nlon(self):
        return self._nlon

    @cached_property
    def _quad(self):
        return _gauss_legendre(self._nlat)

    @property
    def colatitudes(self):
        return self._quad[0]

    @property
    def quad_weights(self):
        return self._quad[1]

    def _dvol_array(self):
        theta_w = self._quad[1] * (2 * np.pi / self._nlon)
        return np.repeat(theta_w, self._nlon)

    def _key(self):
        return (self._nlat, self._nlon)

    def get_default_codomain(self):
        return LMSpace(self._nlat - 1)


class HPSpace(Domain):
    """HEALPix sphere pixelization (equal-area pixels; the pixel functions
    are :mod:`nifty_tpu_torch.ops.healpix`)."""

    def __init__(self, nside: int):
        self._nside = int(nside)
        if self._nside < 1:
            raise ValueError("nside must be >= 1")
        self._shape = (12 * self._nside ** 2,)

    @property
    def nside(self):
        return self._nside

    @property
    def scalar_dvol(self):
        return np.pi / (3 * self._nside ** 2)

    def _key(self):
        return (self._nside,)

    def get_default_codomain(self):
        return LMSpace(2 * self._nside)


class DomainTuple:
    """Cached product of domains, compared by its domains."""

    _cache: dict = {}

    def __init__(self, domains: Tuple[Domain, ...]):
        self._domains = tuple(domains)
        self._shape = sum((d.shape for d in self._domains), ())

    @classmethod
    def make(cls, domain) -> "DomainTuple":
        if isinstance(domain, DomainTuple):
            return domain
        if isinstance(domain, Domain):
            domain = (domain,)
        key = tuple(domain)
        if key not in cls._cache:
            cls._cache[key] = cls(key)
        return cls._cache[key]

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(np.prod(self._shape, dtype=np.int64)) if self._shape else 1

    def __len__(self):
        return len(self._domains)

    def __getitem__(self, i):
        return self._domains[i]

    def __iter__(self):
        return iter(self._domains)

    def __eq__(self, other):
        return isinstance(other, DomainTuple) and self._domains == other._domains

    def __hash__(self):
        return hash(self._domains)

    @property
    def axes(self):
        out, ax = [], 0
        for d in self._domains:
            n = len(d.shape)
            out.append(tuple(range(ax, ax + n)))
            ax += n
        return tuple(out)

    def __repr__(self):
        return f"DomainTuple({self._domains!r})"
