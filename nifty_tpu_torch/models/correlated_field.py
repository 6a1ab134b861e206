"""Correlated field model: a GP prior with a non-parametric power spectrum
on one regular Fourier grid (counterpart of
:mod:`nifty_tpu.models.correlated_field`).

A field on a regular grid is modeled as

    s = offset + HT( A(p) * xi ) / V

with ``xi`` white in harmonic space, ``A`` the amplitude spectrum (power
law plus integrated-Wiener-process deviations over log-k) distributed
from power-space bins onto every mode by the hand-written distributor
kernels (:mod:`nifty_tpu_torch.ops.bin_gather`), ``HT`` the Hartley
transform and ``V`` the total volume.

Ported: ``make_grid`` with optional log binning, ``non_parametric_amplitude``
and ``CorrelatedFieldMaker`` (``add_fluctuations``,
``set_amplitude_total_offset``, ``get_normalized_amplitudes``, ``finalize``)
for one Fourier subgrid.  Spherical subgrids, ``total_N`` batching,
Matern amplitudes and several subgrids are still to be ported.
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import config
from ..model import Model, WrappedCall, wrap
from ..ops.bin_gather import BinIndex, distribute_power
from ..ops.harmonic import (
    fourier_mode_distributor,
    fourier_mode_index_quarter,
    hartley,
)
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


def make_grid(shape, distances, harmonic_type="fourier",
              n_bins: Optional[int] = None) -> RegularCartesianGrid:
    """Grid metadata incl. the power distributor (host precompute).

    ``n_bins`` groups the nonzero modes into at most ``n_bins - 1``
    log-uniform ``|k|`` bins (bin 0 is the zero mode).
    """
    if harmonic_type.lower() != "fourier":
        raise NotImplementedError(
            f"harmonic_type {harmonic_type!r}: only 'fourier' grids are ported"
        )
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
        self.register_buffer(
            "log_k_rel", torch.from_numpy(np.asarray(hg.relative_log_mode_lengths, np.float64))
        )
        self.register_buffer(
            "multiplicity", torch.from_numpy(np.asarray(hg.mode_multiplicity, np.float64))
        )

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


class CorrelatedField(Model):
    """The finalized field: buffers hold the distributor map (full grid or
    quarter grid) with its sort permutation and CSR offsets."""

    def __init__(self, amplitude, azm, grid, offset_mean, xi_key, use_quarter,
                 domain):
        init = {k: partial(random_like, primals=v) for k, v in domain.items()}
        super().__init__(domain=dict(domain), init=init)
        hg = grid.harmonic_grid
        self.amplitude = amplitude
        self.azm = azm
        self.offset_mean = offset_mean
        self.xi_key = xi_key
        self.use_quarter = bool(use_quarter)
        self.grid_shape = tuple(hg.shape)
        self.total_volume = float(grid.total_volume)
        dist = hg.power_distributor_quarter if use_quarter else hg.power_distributor
        self.dist = BinIndex(dist, nb=np.asarray(hg.mode_lengths).size)
        self.target_grids = (grid,)

    def normalized_amplitude(self, p):
        """Amplitude table with the degenerate zero mode divided out."""
        return _divide_out_zero_mode(self.amplitude(p), self.azm(p))

    def harmonic_amplitude(self, p):
        """The amplitude on every harmonic mode (full grid)."""
        # the zero-mode scale multiplies the small table before
        # distribution, as in the JAX package
        table = self.azm(p)[..., None] * self.normalized_amplitude(p)
        amp = distribute_power(table, self.dist)
        if self.use_quarter:
            ndim = len(self.grid_shape)
            for ax, n in enumerate(self.grid_shape):
                amp = _mirror_expand(amp, ax - ndim, n)
        return amp

    def forward(self, p):
        """The field; leading axes of the latents (all of them alike) batch
        samples, which then share one distributor launch per call."""
        x = self.harmonic_amplitude(p) * p[self.xi_key]
        tcd = config.get("transform_compute_dtype")
        xin = x
        if tcd is not None and x.is_floating_point() and x.dtype != torch.float32:
            xin = x.to(torch.float32)
        y = hartley(xin, axes=tuple(range(-len(self.grid_shape), 0)))
        y = y.to(x.dtype) if y.dtype != x.dtype else y
        return self.offset_mean + (1.0 / self.total_volume) * y


class CorrelatedFieldMaker:
    """Construction helper for a correlated field on one Fourier subgrid.

    ``finalize`` composes power distribution, zero-mode scaling, the
    Hartley transform and the offset into a :class:`CorrelatedField`.
    """

    #: Full-grid maps with at least this many entries are distributed on
    #: the per-axis folded quarter grid and mirror-expanded.  The port's
    #: rule: the quarter route cuts the distributor's index and value
    #: traffic 2^d-fold but adds a full-grid mirror expansion (flip and
    #: concatenation, and their adjoint); below about a million modes
    #: (1024^2) the distributor kernels are launch-bound, so the route
    #: with fewer launches, the full-grid map, is kept.
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
        """Add a non-parametric correlation structure; ``n_bins`` bins the
        power spectrum logarithmically (see :func:`make_grid`)."""
        if self._fluctuations:
            raise NotImplementedError("several subgrids are not ported yet")
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
        self._fluctuations.append(npa)
        self._target_grids.append(grid)
        self._update_parameter_tree(npa.domain)

    def _update_parameter_tree(self, dom):
        clash = set(dom) & set(self._parameter_tree)
        if clash:
            raise ValueError(
                f"latent parameter keys {sorted(clash)} already exist; "
                "pass a distinct `prefix=` to each add_fluctuations call"
            )
        self._parameter_tree.update(dom)

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

    def finalize(self) -> CorrelatedField:
        """Compose and return the correlated field model (on the CPU;
        ``.to(device)`` moves its buffers)."""
        if len(self._target_grids) != 1:
            raise ValueError("add exactly one subgrid with `add_fluctuations`")
        grid = self._target_grids[0]
        xi_key = self._prefix + "xi"
        self._parameter_tree[xi_key] = ShapeWithDtype(grid.harmonic_grid.shape)
        full_entries = int(np.prod(grid.harmonic_grid.shape))
        return CorrelatedField(
            self._fluctuations[0], self.azm, grid, self._offset_mean, xi_key,
            use_quarter=full_entries >= self.QUARTER_MIN_ENTRIES,
            domain=self._parameter_tree,
        )
