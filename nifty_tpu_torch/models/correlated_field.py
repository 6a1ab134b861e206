"""Correlated field model: a GP prior on a product of regular Fourier
subgrids, or on the sphere (counterpart of
:mod:`nifty_tpu.models.correlated_field`).

A field is modeled as

    s = offset + HT( A_1(p) x ... x A_n(p) * xi ) / V

with ``xi`` white in harmonic space, ``A_i`` the amplitude spectrum of
subgrid ``i`` (non-parametric: power law plus integrated-Wiener-process
deviations over log-k; or Matern) distributed from power-space bins onto
every mode of the subgrid by the hand-written distributor kernels
(:mod:`nifty_tpu_torch.ops.bin_gather`), ``x`` the outer product, ``HT``
the Hartley transform of each subgrid over its axes and ``V`` the
subgrids' total volumes.

Ported: ``make_grid`` with optional log binning, ``non_parametric_amplitude``,
``matern_amplitude``, ``CorrelatedFieldMaker`` with any number of Fourier
subgrids, ``total_N`` / ``dofdex`` batching and the maker's read-outs,
``SimpleCorrelatedField`` and ``adjust_variances``.

A spherical subgrid (:func:`make_spherical_grid`; ``harmonic_type``
``"spherical"`` for a Gauss-Legendre grid, ``"healpix"`` for HEALPix) has
``(lmax+1)^2`` real harmonic modes, power binned by multipole ``l``, and
synthesizes the field with a spherical harmonic transform
(:mod:`nifty_tpu_torch.ops.sht`, :mod:`nifty_tpu_torch.ops.healpix_sht`)
scaled by ``1/sqrt(4π)``, with volume factor 1; it must be the field's
only subgrid.
"""

from __future__ import annotations

import math
from collections import namedtuple
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import config
from ..model import Model, WrappedCall, wrap
from ..ops.bin_gather import BinIndex, distribute_power, distribute_power_slab, row_bin_index
from ..ops.harmonic import (
    fourier_mode_distributor,
    fourier_mode_index_quarter,
    hartley,
)
from ..ops.healpix_sht import HEALPixSHT
from ..ops.sht import SphericalHarmonicTransform
from ..stats import lognormal_moments, lognormal_prior, normal_prior
from ..tree import ShapeWithDtype, random_like
from .gauss_markov import IntegratedWienerProcess

RegularCartesianGrid = namedtuple(
    "RegularCartesianGrid",
    ("shape", "total_volume", "distances", "harmonic_grid"),
    defaults=(None,),
)

RegularFourierGrid = namedtuple(
    "RegularFourierGrid",
    (
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
        # the same map on the per-axis folded quarter grid (axis length
        # n//2+1): idx_full == idx_q[fold(i0), fold(i1), ...]
        "power_distributor_quarter",
    ),
    defaults=(None,),
)

# the sphere's "grid": the modes are the (lmax+1)^2 real coefficients,
# binned by l; `transform` is the spherical synthesis (a module holding the
# transform's tables)
SphericalHarmonicGrid = namedtuple(
    "SphericalHarmonicGrid",
    (
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
        "lmax",
        "transform",
    ),
)


class SphericalSynthesis(nn.Module):
    """The harmonic transform of a spherical subgrid: real coefficients
    ``(..., (lmax+1)^2)`` -> maps, ``sht.synthesize_real(x) / sqrt(4π)``, so
    that ``fluctuations`` is the pointwise std of the field."""

    def __init__(self, sht):
        super().__init__()
        self.sht = sht

    def forward(self, x):
        return self.sht.synthesize_real(x) / np.sqrt(4.0 * np.pi)


def make_spherical_grid(lmax, nlat=None, nphi=None, *, grid_type: str = "gl",
                        nside=None) -> RegularCartesianGrid:
    """Sphere 'grid' metadata (host precompute): l-binned power over
    (lmax+1)^2 real coefficients; the transform is the exact Gauss-Legendre
    synthesis (or HEALPix's two-stage synthesis for ``grid_type="healpix"``,
    default ``nside = (lmax+1) // 2``).  The transform's tables are built on
    the CPU; ``finalize`` moves them with the field."""
    lmax = int(lmax)
    if grid_type.lower() in ("healpix", "hp"):
        nside = int(nside) if nside is not None else max(1, (lmax + 1) // 2)
        sht = HEALPixSHT(lmax, nside, device="cpu")
        sht_grid_shape = (sht.npix,)
    else:
        sht = SphericalHarmonicTransform(lmax, nlat=nlat, nphi=nphi, device="cpu")
        sht_grid_shape = sht.grid_shape
    ls = np.concatenate(
        [np.arange(lmax + 1)] + [np.repeat(np.arange(m, lmax + 1), 2) for m in range(1, lmax + 1)]
    ).astype(np.int32)
    m_length = np.arange(lmax + 1, dtype=np.float64)
    m_count = 2 * np.arange(lmax + 1) + 1
    um = m_length.copy()
    um[1:] = np.log(um[1:])
    um[1:] -= um[1]
    log_vol = um[2:] - um[1:-1]
    harmonic_grid = SphericalHarmonicGrid(
        shape=((lmax + 1) ** 2,),
        power_distributor=ls,
        mode_multiplicity=m_count,
        mode_lengths=m_length,
        relative_log_mode_lengths=um,
        log_volume=log_vol,
        lmax=lmax,
        transform=SphericalSynthesis(sht),
    )
    return RegularCartesianGrid(
        shape=sht_grid_shape, total_volume=4.0 * np.pi, distances=None,
        harmonic_grid=harmonic_grid,
    )


def make_grid(shape, distances, harmonic_type="fourier",
              n_bins: Optional[int] = None) -> RegularCartesianGrid:
    """Grid metadata incl. the power distributor (host precompute).

    ``n_bins`` groups the nonzero modes into at most ``n_bins - 1``
    log-uniform ``|k|`` bins (bin 0 is the zero mode).  For the spherical
    types (``"spherical"`` / ``"sphere"`` / ``"sh"``: Gauss-Legendre;
    ``"healpix"`` / ``"hp"``) ``shape`` is lmax and ``distances`` and
    ``n_bins`` are not used.
    """
    kind = harmonic_type.lower()
    if kind in ("spherical", "sphere", "sh"):
        return make_spherical_grid(shape)
    if kind in ("healpix", "hp"):
        return make_spherical_grid(shape, grid_type="healpix")
    if kind != "fourier":
        raise ValueError(f"invalid `harmonic_type` {harmonic_type!r}")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = tuple(np.broadcast_to(distances, (len(shape),)).astype(float))
    totvol = float(np.prod(np.array(shape) * np.array(distances)))

    m_length_idx, m_length, m_count = fourier_mode_distributor(shape, distances)
    m_length_idx_q = fourier_mode_index_quarter(shape, distances, m_length)
    if n_bins is not None and m_length.size > n_bins:
        m_length_idx, m_length, m_count, dense = _log_binned_distributor(
            m_length_idx, m_length, m_count, int(n_bins)
        )
        m_length_idx_q = dense[m_length_idx_q].astype(np.int32)
    # um[0] = 0 (zero mode), um[k>=1] = log(k_len) - log(k_len[1]);
    # log_vol are the log-k bin widths the IWP integrates over.
    um = m_length.copy()
    um[1:] = np.log(um[1:])
    um[1:] -= um[1]
    log_vol = um[2:] - um[1:-1]

    harmonic_grid = RegularFourierGrid(
        shape=shape,
        power_distributor=m_length_idx,
        mode_multiplicity=m_count,
        mode_lengths=m_length,
        relative_log_mode_lengths=um,
        log_volume=log_vol,
        power_distributor_quarter=m_length_idx_q,
    )
    return RegularCartesianGrid(
        shape=shape, total_volume=totvol, distances=distances,
        harmonic_grid=harmonic_grid,
    )


def _log_binned_distributor(m_length_idx, m_length, m_count, n_bins):
    """Regroup unique-|k| modes into log-uniform bins (host precompute).

    Bin 0 keeps the zero mode alone; the nonzero lengths go into at most
    ``n_bins - 1`` log-uniform bins (empty bins dropped), each represented
    by the multiplicity-weighted mean of its member lengths.
    """
    k1, kmax = m_length[1], m_length[-1]
    edges = np.exp(np.linspace(np.log(k1), np.log(kmax), n_bins))
    ub = np.zeros(m_length.size, dtype=np.int64)
    ub[1:] = 1 + np.searchsorted(edges[1:-1], m_length[1:], side="right")
    occupied, dense = np.unique(ub, return_inverse=True)
    nb = occupied.size
    w = m_count.astype(np.float64)
    b_count = np.bincount(dense, weights=w, minlength=nb)
    b_len = np.bincount(dense, weights=w * m_length, minlength=nb) / b_count
    b_len[0] = 0.0
    new_idx = dense[m_length_idx].astype(np.int32)
    return new_idx, b_len, b_count.astype(np.int64), dense


def _mirror_expand(a, axis, n):
    """Expand a per-axis folded (quarter-grid) tensor to the full
    fft-ordered axis of length ``n``: full index ``i`` reads folded index
    ``min(i, n - i)``.  Slices, a flip and a concatenation; autograd's
    adjoint is the matching slice-and-add fold."""
    q = a.shape[axis]
    if q != n // 2 + 1:
        raise ValueError(f"folded axis has length {q}; expected {n // 2 + 1}")
    tail = a.narrow(axis, 1, n - q).flip(axis)
    return torch.cat([a, tail], dim=axis)


def _detrend(log_k_rel, x):
    """Subtract the straight line through the origin and ``x``'s endpoint
    (in relative-log-k coordinates), so deviations carry no net slope."""
    return x - x[..., -1:] * (log_k_rel / log_k_rel[-1])


def _divide_out_zero_mode(amp, azm):
    """Amplitude table with every nonzero mode divided by the zero-mode
    scale ``azm`` (one value per sample)."""
    return torch.cat([amp[..., :1], amp[..., 1:] * (1.0 / azm)[..., None]], -1)


def _as_prior(x, default, what):
    if isinstance(x, (tuple, list)):
        return default(*x)
    if callable(x):
        return x
    raise TypeError(f"invalid `{what}` specified; got {type(x)!r}")


class NonParametricAmplitude(Model):
    """Amplitude spectrum on the power bins: power law (slope) plus
    de-trended IWP deviations, normalized so that ``fluctuations`` is the
    a-priori total std of the field."""

    def __init__(self, grid, fluctuations, loglogavgslope, flexibility=None,
                 asperity=None, prefix="", kind="amplitude"):
        if kind.lower() not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        fluct_m = WrappedCall(fluctuations, name=prefix + "fluctuations", white_init=True)
        slope_m = WrappedCall(loglogavgslope, name=prefix + "loglogavgslope", white_init=True)
        latents = dict(fluct_m.domain)
        latents.update(slope_m.domain)

        hg = grid.harmonic_grid
        bin_log_vol = np.asarray(hg.log_volume)
        wiggle_m = None
        if flexibility is not None and bin_log_vol.size > 0:
            flex_m = WrappedCall(flexibility, name=prefix + "flexibility", white_init=True)
            asp_m = None
            if asperity is not None:
                asp_m = WrappedCall(asperity, name=prefix + "asperity", white_init=True)
            wiggle_m = IntegratedWienerProcess(
                np.zeros((2,)), flex_m, bin_log_vol,
                name=prefix + "spectrum", asperity=asp_m,
            )
            latents.update(wiggle_m.domain)

        super().__init__(domain=dict(latents), init=partial(random_like, primals=latents))
        # `expo` decides whether the table multiplies harmonic modes
        # directly ("amplitude") or is a power whose sqrt does ("power")
        self.expo = 2.0 if kind.lower() == "amplitude" else 1.0
        self.total_volume = float(grid.total_volume)
        self.fluctuation_amplitude = fluct_m
        self.slope = slope_m
        self.wiggle = wiggle_m
        self.register_buffer("log_k_rel", config.host_floats(hg.relative_log_mode_lengths))
        self.register_buffer("multiplicity", config.host_floats(hg.mode_multiplicity))

    def forward(self, primals):
        """The table on the power bins, shape (..., nb); leading axes of the
        latents batch samples."""
        log_k_rel = self.log_k_rel
        log_shape = self.slope(primals)[..., None] * log_k_rel
        if self.wiggle is not None:
            path = self.wiggle(primals)[..., 0]  # IWP position component
            # pin the zero mode
            path = torch.cat([path.new_zeros(path.shape[:-1] + (1,)), path], -1)
            log_shape = log_shape + _detrend(log_k_rel, path)
        shape = torch.exp(log_shape)
        band = torch.sum(self.multiplicity[1:] * shape[..., 1:] ** self.expo, -1)
        scale = self.fluctuation_amplitude(primals) * self.total_volume / torch.sqrt(band)
        amp = scale[..., None] * shape ** (self.expo / 2.0)
        vol = amp.new_full(amp.shape[:-1] + (1,), self.total_volume)
        return torch.cat([vol, amp[..., 1:]], -1)


def non_parametric_amplitude(grid, fluctuations, loglogavgslope, flexibility=None,
                             asperity=None, prefix="", kind="amplitude"):
    """Non-parametric amplitude model (see :class:`NonParametricAmplitude`)."""
    return NonParametricAmplitude(
        grid, fluctuations, loglogavgslope, flexibility, asperity, prefix, kind
    )


class MaternAmplitude(Model):
    """Matern-kernel amplitude spectrum on the power bins:
    ``A(k) = a (1 + (k / b)^2)^(c / 4)`` with ``a`` the scale, ``b`` the
    cutoff and ``c`` the log-log slope; optionally renormalized so that the
    scale is the a-priori total std of the field."""

    def __init__(self, grid, scale, cutoff, loglogslope, renormalize_amplitude=False,
                 prefix="", kind="amplitude"):
        if kind.lower() not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        # no `white_init`, unlike the non-parametric amplitude's parts: the
        # init rule is derived from the domain when asked for
        scale_m = WrappedCall(scale, name=prefix + "scale")
        cutoff_m = WrappedCall(cutoff, name=prefix + "cutoff")
        slope_m = WrappedCall(loglogslope, name=prefix + "loglogslope")
        ptree = dict(scale_m.domain)
        ptree.update(cutoff_m.domain)
        ptree.update(slope_m.domain)
        super().__init__(domain=dict(ptree), init=partial(random_like, primals=ptree))
        self.kind = kind.lower()
        self.renormalize_amplitude = bool(renormalize_amplitude)
        self.total_volume = float(grid.total_volume)
        self.fluctuation_amplitude = scale_m
        self.cutoff = cutoff_m
        self.loglogslope = slope_m
        hg = grid.harmonic_grid
        self.register_buffer("mode_lengths", config.host_floats(hg.mode_lengths))
        self.register_buffer("multiplicity", config.host_floats(hg.mode_multiplicity))

    def forward(self, primals):
        """The table on the power bins, shape (..., nb); leading axes of the
        latents batch samples."""
        scl = self.fluctuation_amplitude(primals)
        ctf = self.cutoff(primals)
        slp = self.loglogslope(primals)
        ln_spectrum = 0.25 * slp[..., None] * torch.log1p((self.mode_lengths / ctf[..., None]) ** 2)
        spectrum = torch.exp(ln_spectrum)
        sqrt_vol = math.sqrt(self.total_volume)
        norm = 1.0
        if self.renormalize_amplitude:
            expo = 4 if self.kind == "amplitude" else 2
            norm = torch.sqrt(torch.sum(self.multiplicity[1:] * spectrum[..., 1:] ** expo, -1))
            norm = norm / sqrt_vol
        spectrum = (scl * (sqrt_vol / norm))[..., None] * spectrum
        vol = spectrum.new_full(spectrum.shape[:-1] + (1,), self.total_volume)
        spectrum = torch.cat([vol, spectrum[..., 1:]], -1)
        return torch.sqrt(spectrum) if self.kind == "power" else spectrum


def matern_amplitude(grid, scale, cutoff, loglogslope, renormalize_amplitude=False,
                     prefix="", kind="amplitude"):
    """Matern amplitude model (see :class:`MaternAmplitude`)."""
    return MaternAmplitude(grid, scale, cutoff, loglogslope, renormalize_amplitude, prefix, kind)


class CorrelatedField(Model):
    """The finalized field.  Each subgrid keeps its own distributor map
    (full grid or quarter grid, a :class:`BinIndex` of buffers) and its
    amplitude model.

    The field is ``offset + HT_n(... HT_1(A_1 x ... x A_n * xi) / V_1 ...) / V_n``:
    the subgrids' amplitudes on every harmonic mode, their outer product
    (left to right), the excitation, then each subgrid's Hartley transform
    over its own axes followed by its ``1 / V``.  The latents' leading axes
    batch samples.  With ``dofdex`` (``total_N`` fields) every parameter
    leaf carries a set axis after the sample axes, gathered by ``dofdex``
    into one axis of ``total_N`` fields, and the excitation has that axis
    too: the tables of every sample and field go to one distributor call
    per subgrid.
    """

    def __init__(self, amplitudes, azm, grids, offset_mean, xi_key, use_quarter, domain, *,
                 hartley_fn=None, dofdex=None, parameter_ndims=None):
        init = {k: partial(random_like, primals=v) for k, v in domain.items()}
        super().__init__(domain=dict(domain), init=init)
        self.amplitudes = nn.ModuleList(amplitudes)
        self.azm = azm
        self.offset_mean = offset_mean
        self.xi_key = xi_key
        self.use_quarters = tuple(bool(u) for u in use_quarter)
        self.grid_shapes = tuple(tuple(g.harmonic_grid.shape) for g in grids)
        self.total_volumes = tuple(float(g.total_volume) for g in grids)
        self.dists = nn.ModuleList(
            BinIndex(
                g.harmonic_grid.power_distributor_quarter if uq
                else g.harmonic_grid.power_distributor,
                nb=np.asarray(g.harmonic_grid.mode_lengths).size,
            )
            for g, uq in zip(grids, self.use_quarters)
        )
        self.target_grids = tuple(grids)
        # a spherical subgrid (only ever the sole one) has its own transform
        spherical = isinstance(grids[0].harmonic_grid, SphericalHarmonicGrid)
        self.spherical_transform = grids[0].harmonic_grid.transform if spherical else None
        self.hartley_fn = hartley if hartley_fn is None else hartley_fn
        self.register_buffer(
            "dofdex", None if dofdex is None else torch.as_tensor(dofdex, dtype=torch.int64)
        )
        self._dofdex_is_identity = dofdex is not None and list(dofdex) == list(range(len(dofdex)))
        self.parameter_ndims = dict(parameter_ndims or {})
        # on a field-sharded mesh (`_shard_`): the mesh, and each subgrid's
        # (row, bin) map of its slab
        self.field_mesh = None
        self.rowbins = None

    def _shard_(self, mesh, min_ndim=2):
        """Take this rank's rows of the field on ``mesh``'s field axis: the
        distributor runs on the slab's rows of the full-grid map (the
        quarter map's mirror would cross ranks) and, for
        ``deterministic_reductions``, on their (row, bin) map; the
        replicated amplitude table's gradient then reduces over the field
        group.  One Fourier subgrid without ``total_N``; the harmonic
        transform must be a distributed one (``finalize(hartley_fn=...)``)
        where the field axis has more than one rank."""
        if self.field_mesh is not None:
            return
        if len(self.dists) != 1 or self.spherical_transform is not None or self.dofdex is not None:
            raise NotImplementedError(
                "a field-sharded correlated field has one Fourier subgrid and no total_N")
        p, f = mesh.size(mesh.field_axis), mesh.index(mesh.field_axis)
        if p > 1 and self.hartley_fn is hartley:
            raise ValueError("a field-sharded correlated field needs a distributed Hartley "
                             "transform: finalize(hartley_fn=...)")
        hg = self.target_grids[0].harmonic_grid
        full = np.asarray(hg.power_distributor)
        n0 = full.shape[0]
        if n0 % p:
            raise ValueError(f"the field's first axis ({n0}) does not divide among {p} ranks")
        rows = full[f * (n0 // p):(f + 1) * (n0 // p)]
        device = self.dists[0].idx.device
        nb = self.dists[0].nb
        self.dists = nn.ModuleList([BinIndex(rows, nb=nb).to(device)])
        self.rowbins = nn.ModuleList([row_bin_index(rows, nb).to(device)])
        self.use_quarters = (False,)
        self.field_mesh = mesh
        mesh.sharded_latents.add(self.xi_key)
        mesh.field_grids.add(tuple(full.shape))

    def _one(self, what):
        if len(self.dists) != 1:
            raise ValueError(f"this field has {len(self.dists)} subgrids; use `{what}s`")
        return getattr(self, what + "s")[0]

    @property
    def dist(self):
        """The distributor map of a field with one subgrid."""
        return self._one("dist")

    @property
    def use_quarter(self):
        return self._one("use_quarter")

    @property
    def amplitude(self):
        """The amplitude model of a field with one subgrid."""
        return self._one("amplitude")

    def field_parameters(self, p):
        """The latents with every parameter leaf gathered by ``dofdex`` along
        its set axis (the axis before the leaf's own shape), so that each
        of the ``total_N`` fields reads its set's parameters."""
        if self.dofdex is None or self._dofdex_is_identity:
            return p
        out = dict(p)
        for k, nd in self.parameter_ndims.items():
            out[k] = torch.index_select(p[k], p[k].ndim - nd - 1, self.dofdex)
        return out

    def harmonic_amplitude(self, p):
        """The outer product of the subgrids' amplitudes on every harmonic
        mode, shape (..., *excitation)."""
        outer, before = None, 0
        for i, (amp_m, dist, shape, uq) in enumerate(
                zip(self.amplitudes, self.dists, self.grid_shapes, self.use_quarters)):
            if i == 0:
                # the zero-mode scale multiplies the small table before
                # distribution, as in the JAX package.  Evaluated in this
                # order (scale, table, the table's division): the order
                # in which autograd records the nodes decides the order of
                # its sums, and with it the bits of every update.
                table = self.azm(p)[..., None] * _divide_out_zero_mode(amp_m(p), self.azm(p))
            else:
                table = _divide_out_zero_mode(amp_m(p), self.azm(p))
            if self.field_mesh is not None:
                amp = distribute_power_slab(
                    table, dist, self.rowbins[i], self.field_mesh.group(self.field_mesh.field_axis),
                    config.get("deterministic_reductions"))
            else:
                amp = distribute_power(table, dist)
            if uq:
                for ax, n in enumerate(shape):
                    amp = _mirror_expand(amp, ax - len(shape), n)
            if outer is None:
                outer = amp
            else:
                lead = amp.shape[: amp.ndim - len(shape)]
                outer = outer[(Ellipsis,) + (None,) * len(shape)] * amp.reshape(
                    lead + (1,) * before + shape)
            before += len(shape)
        return outer

    def forward(self, p):
        """The field; leading axes of the latents (all of them alike) batch
        samples, which then share one distributor launch per subgrid."""
        p = self.field_parameters(p)
        x = self.harmonic_amplitude(p) * p[self.xi_key]
        tcd = config.get("transform_compute_dtype")
        start = x.ndim - sum(len(s) for s in self.grid_shapes)
        for shape, vol in zip(self.grid_shapes, self.total_volumes):
            axes = tuple(range(start, start + len(shape)))
            start += len(shape)
            xin = x
            if tcd is not None and x.is_floating_point() and x.dtype != torch.float32:
                xin = x.to(torch.float32)
            if self.spherical_transform is not None:
                # the sphere's transform carries its own normalization
                # (volume factor 1)
                y = self.spherical_transform(xin)
                x = y.to(x.dtype) if y.dtype != x.dtype else y
                continue
            y = self.hartley_fn(xin, axes=axes)
            y = y.to(x.dtype) if y.dtype != x.dtype else y
            x = (1.0 / vol) * y
        return self.offset_mean + x


class CorrelatedFieldMaker:
    """Construction helper for correlated fields on one or more Fourier
    subgrids.

    Each ``add_fluctuations*`` call adds one subgrid; ``finalize`` composes
    power distribution, zero-mode scaling, the outer product, the Hartley
    transforms and the offset into a :class:`CorrelatedField`.
    """

    #: Full-grid maps with at least this many entries are distributed on
    #: the per-axis folded quarter grid and mirror-expanded (decided for
    #: each subgrid on its own).  The port's rule: the quarter route cuts
    #: the distributor's index and value traffic 2^d-fold but adds a
    #: full-grid mirror expansion (flip and concatenation, and their
    #: adjoint); below about a million modes (1024^2) the distributor
    #: kernels are launch-bound, so the route with fewer launches, the
    #: full-grid map, is kept.
    QUARTER_MIN_ENTRIES = 2**20

    def __init__(self, prefix: str):
        self._azm = None
        self._offset_mean = None
        self._fluct_logparams = []
        self._fluctuations = []
        self._target_grids = []
        self._parameter_tree = {}
        self._prefix = prefix

    def add_fluctuations(
        self,
        shape: Union[tuple, int],
        distances: Union[tuple, float],
        fluctuations: Union[tuple, Callable],
        loglogavgslope: Union[tuple, Callable],
        flexibility: Union[tuple, Callable, None] = None,
        asperity: Union[tuple, Callable, None] = None,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        n_bins: Optional[int] = None,
    ):
        """Add a non-parametric correlation structure on a new subgrid;
        ``n_bins`` bins the power spectrum logarithmically (see
        :func:`make_grid`)."""
        grid = make_grid(shape, distances, harmonic_type, n_bins=n_bins)
        self._fluct_logparams.append(
            lognormal_moments(*fluctuations)
            if isinstance(fluctuations, (tuple, list)) else None
        )
        npa = non_parametric_amplitude(
            grid=grid,
            fluctuations=_as_prior(fluctuations, lognormal_prior, "fluctuations"),
            loglogavgslope=_as_prior(loglogavgslope, normal_prior, "loglogavgslope"),
            flexibility=(
                None if flexibility is None
                else _as_prior(flexibility, lognormal_prior, "flexibility")
            ),
            asperity=(
                None if asperity is None
                else _as_prior(asperity, lognormal_prior, "asperity")
            ),
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
        )
        self._add(npa, grid)

    def add_fluctuations_matern(
        self,
        shape: Union[tuple, int],
        distances: Union[tuple, float],
        scale: Union[tuple, Callable],
        cutoff: Union[tuple, Callable],
        loglogslope: Union[tuple, Callable],
        renormalize_amplitude: bool = False,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        n_bins: Optional[int] = None,
    ):
        """Add a Matern-kernel correlation structure on a new subgrid."""
        grid = make_grid(shape, distances, harmonic_type, n_bins=n_bins)
        self._fluct_logparams.append(None)  # the scale has its own parametrization
        ma = matern_amplitude(
            grid=grid,
            scale=_as_prior(scale, lognormal_prior, "scale"),
            cutoff=_as_prior(cutoff, lognormal_prior, "cutoff"),
            loglogslope=_as_prior(loglogslope, normal_prior, "loglogslope"),
            renormalize_amplitude=renormalize_amplitude,
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
        )
        self._add(ma, grid)

    def _add(self, amplitude, grid):
        clash = set(amplitude.domain) & set(self._parameter_tree)
        if clash:
            raise ValueError(
                f"latent parameter keys {sorted(clash)} already exist; "
                "pass a distinct `prefix=` to each add_fluctuations* call"
            )
        self._fluctuations.append(amplitude)
        self._target_grids.append(grid)
        self._parameter_tree.update(amplitude.domain)

    def set_amplitude_total_offset(self, offset_mean, offset_std):
        """Set the global offset mean and the zero-mode std prior."""
        self._offset_mean = offset_mean
        zm = offset_std
        if not callable(zm):
            if zm is None or len(zm) != 2:
                raise TypeError(f"invalid `offset_std` {zm!r}")
            zm = lognormal_prior(*zm)
        self._azm = wrap(zm, self._prefix + "zeromode")
        self._parameter_tree[self._prefix + "zeromode"] = ShapeWithDtype(())

    @property
    def amplitude_total_offset(self) -> Callable:
        if self._azm is None:
            raise RuntimeError("set `amplitude_total_offset` first")
        return self._azm

    azm = amplitude_total_offset

    @property
    def fluctuations(self) -> Tuple[Callable, ...]:
        return tuple(self._fluctuations)

    def get_normalized_amplitudes(self) -> Tuple[Callable, ...]:
        """Amplitudes with the degenerate zero mode divided out."""

        def normalized(amp):
            return lambda p: _divide_out_zero_mode(amp(p), self.azm(p))

        return tuple(normalized(a) for a in self._fluctuations)

    @property
    def amplitude(self) -> Callable:
        """The amplitude of a field with one subgrid, its zero mode scaled
        by the zero-mode std."""
        if len(self._fluctuations) > 1:
            raise NotImplementedError("multiple spectra have no unique absolute amplitude")
        amp = self._fluctuations[0]

        def amplitude_w_zm(p):
            a = amp(p)
            return torch.cat([a[..., :1] * self.azm(p)[..., None], a[..., 1:]], -1)

        return amplitude_w_zm

    @property
    def power_spectrum(self) -> Callable:
        amp = self.amplitude
        return lambda p: amp(p) ** 2

    # -- a-priori moment statistics ----------------------------------------

    def fluctuation_amplitudes(self) -> Tuple[Callable, ...]:
        return tuple(a.fluctuation_amplitude for a in self._fluctuations)

    def total_fluctuation(self) -> Callable:
        """A-priori total fluctuation of the field over all subgrids (a
        callable on latent positions)."""
        if not self._fluctuations:
            raise NotImplementedError
        if len(self._fluctuations) == 1:
            return self.average_fluctuation(0)
        fls = self.fluctuation_amplitudes()
        azm = self.azm

        def total(p):
            q = 1.0
            for fl in fls:
                q = q * (1.0 + (fl(p) / azm(p)) ** 2)
            return torch.sqrt(q - 1.0) * azm(p)

        return total

    def average_fluctuation(self, space: int) -> Callable:
        """Fluctuations of the field averaged over the other subgrids."""
        fls = self.fluctuation_amplitudes()
        if space >= len(fls):
            raise ValueError(f"invalid space {space!r}")
        return fls[0] if len(fls) == 1 else fls[space]

    def slice_fluctuation(self, space: int) -> Callable:
        """Fluctuations of a single slice along subgrid ``space``."""
        fls = self.fluctuation_amplitudes()
        if space >= len(fls):
            raise ValueError(f"invalid space {space!r}")
        if len(fls) == 1:
            return self.average_fluctuation(0)
        azm = self.azm

        def slice_fl(p):
            q = 1.0
            for j, fl in enumerate(fls):
                r = (fl(p) / azm(p)) ** 2
                q = q * (r if j == space else 1.0 + r)
            return torch.sqrt(q) * azm(p)

        return slice_fl

    def moment_slice_to_average(self, fluctuations_slice_mean: float, key=None,
                                nsamples: int = 1000) -> float:
        """Translate single-subgrid slice fluctuations into the average
        fluctuations of a multi-subgrid field (a Monte Carlo estimate over
        ``nsamples`` prior draws on the host).  ``key`` is a
        ``torch.Generator`` or an int seed (default 42); each subgrid's
        draws are ``random_like(generator, ...)`` of its fluctuation
        latents and the zero mode, with a leading axis of ``nsamples``."""
        fluctuations_slice_mean = float(fluctuations_slice_mean)
        if fluctuations_slice_mean <= 0:
            raise ValueError("fluctuations_slice_mean must be positive")
        gen = key
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(42 if key is None else int(key))
        scm = torch.ones(nsamples, dtype=config.default_float_dtype())
        for fl in self.fluctuation_amplitudes():
            dom = {**fl.domain, self._prefix + "zeromode": ShapeWithDtype(())}
            batched = {k: ShapeWithDtype((nsamples,) + tuple(v.shape), v.dtype)
                       for k, v in dom.items()}
            p = random_like(gen, batched, device=gen.device)
            vals = fl(p) / self.azm(p)
            scm = scm * (vals ** 2 + 1.0)
        return fluctuations_slice_mean / float(torch.mean(torch.sqrt(scm)))

    # -- realized statistics of stacked field samples (N, *grid) -----------

    @staticmethod
    def total_fluctuation_realized(samples) -> float:
        """Spatial-std statistic over stacked field samples (N, *grid)."""
        s = torch.as_tensor(samples)
        ax = tuple(range(1, s.ndim))
        res = (s - s.mean(dim=ax, keepdim=True)) ** 2
        return float(torch.sqrt(res.mean()))

    @staticmethod
    def average_fluctuation_realized(samples, sub_axes, space: int) -> float:
        """Fluctuations of samples averaged over the other subgrids;
        ``sub_axes`` are each subgrid's axes (without the sample axis 0)."""
        s = torch.as_tensor(samples)
        other = tuple(a + 1 for j, axes in enumerate(sub_axes) if j != space for a in axes)
        r = s.mean(dim=other) if other else s
        ax = tuple(range(1, r.ndim))
        res = (r - r.mean(dim=ax, keepdim=True)) ** 2
        return float(torch.sqrt(res.mean()))

    @staticmethod
    def slice_fluctuation_realized(samples, sub_axes, space: int) -> float:
        """Variability within slices along subgrid ``space``."""
        s = torch.as_tensor(samples)
        space_axes = tuple(a + 1 for a in sub_axes[space])
        res = s ** 2 - s.mean(dim=space_axes, keepdim=True) ** 2
        return float(torch.sqrt(res.mean()))

    def finalize(self, hartley_fn: Optional[Callable] = None, total_N: int = 0, dofdex=None,
                 *, device=None) -> CorrelatedField:
        """Compose and return the correlated field with its buffers on
        ``device`` (default: the configured device, the card).

        ``hartley_fn(x, axes=...)`` replaces the Hartley transform of each
        subgrid (``axes`` index the tensor it is given, leading batch axes
        included).  ``total_N`` fields (0: one field) share ``n_sets =
        max(dofdex) + 1`` parameter sets, ``dofdex[b]`` naming the set of
        field ``b`` (default: ``range(total_N)``); every parameter leaf gets
        a leading axis of ``n_sets`` and the excitation one of ``total_N``.
        """
        device = torch.device(device) if device is not None else config.default_device()
        grids = tuple(self._target_grids)
        if not grids:
            raise ValueError("add a subgrid with `add_fluctuations*` first")
        spherical = [isinstance(g.harmonic_grid, SphericalHarmonicGrid) for g in grids]
        if any(spherical) and len(grids) > 1:
            raise NotImplementedError(
                "spherical subgrids are only supported as the sole subgrid")
        excitation_shape = sum((tuple(g.harmonic_grid.shape) for g in grids), ())
        xi_key = self._prefix + "xi"
        self._parameter_tree[xi_key] = ShapeWithDtype(excitation_shape)
        use_quarter = tuple(
            not sph and int(np.prod(g.harmonic_grid.shape)) >= self.QUARTER_MIN_ENTRIES
            for g, sph in zip(grids, spherical)
        )
        domain, parameter_ndims = dict(self._parameter_tree), None
        if total_N > 0:
            dofdex = list(range(total_N)) if dofdex is None else [int(d) for d in dofdex]
            if len(dofdex) != total_N:
                raise ValueError("len(dofdex) must equal total_N")
            n_sets = max(dofdex) + 1
            domain = {
                k: ShapeWithDtype((n_sets,) + tuple(v.shape), v.dtype)
                for k, v in self._parameter_tree.items() if k != xi_key
            }
            domain[xi_key] = ShapeWithDtype(
                (total_N,) + excitation_shape, self._parameter_tree[xi_key].dtype)
            parameter_ndims = {
                k: len(v.shape) for k, v in self._parameter_tree.items() if k != xi_key
            }
        else:
            dofdex = None
        return CorrelatedField(
            self._fluctuations, self.azm, grids, self._offset_mean, xi_key, use_quarter,
            domain, hartley_fn=hartley_fn, dofdex=dofdex, parameter_ndims=parameter_ndims,
        ).to(device)


def SimpleCorrelatedField(
    shape,
    distances,
    *,
    offset_mean=0.0,
    offset_std=(1e-1, 1e-2),
    fluctuations=(1.0, 0.5),
    loglogavgslope=(-3.0, 0.5),
    flexibility=(1.0, 0.5),
    asperity=None,
    prefix: str = "cf",
    harmonic_type: str = "fourier",
    hartley_fn=None,
    n_bins: Optional[int] = None,
    device=None,
) -> CorrelatedField:
    """A correlated field on one subgrid in one call; the maker is the
    field's ``maker``."""
    cfm = CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(offset_mean=offset_mean, offset_std=offset_std)
    cfm.add_fluctuations(
        shape, distances, fluctuations=fluctuations, loglogavgslope=loglogavgslope,
        flexibility=flexibility, asperity=asperity, harmonic_type=harmonic_type,
        n_bins=n_bins,
    )
    cf = cfm.finalize(hartley_fn=hartley_fn, device=device)
    cf.maker = cfm
    return cf


def adjust_variances(position: dict, maker: CorrelatedFieldMaker, space: int = 0) -> dict:
    """Rebalance the excitation / amplitude split of a position.

    Rescales the harmonic excitations (all but the first zero mode) to unit
    sample variance and absorbs the factor into subgrid ``space``'s
    ``fluctuations`` latent (exact for log-normal fluctuation priors), so
    that the field of a one-subgrid model is unchanged.
    """
    lp = maker._fluct_logparams[space]
    if lp is None:
        raise ValueError("adjust_variances requires (mean, std) `fluctuations`")
    xi_key = maker._prefix + "xi"
    flu_key = next(k for k in maker._fluctuations[space].domain if k.endswith("fluctuations"))
    pos = dict(position)
    xi = pos[xi_key]
    fct = torch.sqrt(torch.mean(xi ** 2))
    scaled = (xi / fct).reshape(-1)
    # the zero mode is left as it was
    pos[xi_key] = torch.cat([xi.reshape(-1)[:1], scaled[1:]]).reshape(xi.shape)
    # flu = exp(mu + sigma z); flu_new = flu * fct  =>  z += log(fct) / sigma
    _, log_std = lp
    pos[flu_key] = pos[flu_key] + torch.log(fct) / log_std
    return pos
