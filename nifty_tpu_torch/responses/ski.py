"""Structured kernel interpolation (KISS-GP style) (counterpart of
:mod:`nifty_tpu.responses.ski`).

A GP at arbitrary sampling points is modeled as ``W f`` with ``f`` a field
on a regular inducing grid (with a stationary kernel applied in the
harmonic domain or as a Toeplitz matmul) and ``W`` a multilinear
interpolation operator.  ``W`` is stored as ``(2^ndim, n_points)`` index
and weight tables (:func:`interpolation_matrix`, host numpy) and applied,
with its adjoint, by the line-of-sight kernel pair K11
(:mod:`nifty_tpu_torch.ops.los_interp`): a sampling point is a ray of one
point and ``2^ndim`` corners with scale 1 (:func:`interpolation_table`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..model import Model
from ..ops import los_interp
from ..ops.harmonic import fourier_mode_distributor, fourier_mode_lengths, hartley
from ..tree import ShapeWithDtype


def matmul_toeplitz(c, x):
    """Multiply the Toeplitz matrix with first column ``c`` (rows =
    conj(c)) onto ``x`` via circulant FFT embedding."""
    c = c.reshape(-1)
    r = c.conj()
    n = c.shape[0]
    x_shp = x.shape
    if x.shape[0] != n or x.ndim > 2:
        raise ValueError("invalid matrix product dimensions")
    x2 = x.reshape(n, -1)
    embedded = torch.cat((c, r[1:].flip(0)))
    p = 2 * n - 1
    if embedded.is_complex() or x2.is_complex():
        prod = torch.fft.ifft(torch.fft.fft(embedded)[:, None] * torch.fft.fft(x2, n=p, dim=0),
                              n=p, dim=0)[:n]
    else:
        prod = torch.fft.irfft(torch.fft.rfft(embedded)[:, None]
                               * torch.fft.rfft(x2, n=p, dim=0), n=p, dim=0)[:n]
    return prod.reshape(x_shp[0], *x_shp[1:]) if x.ndim > 1 else prod.reshape(-1)


def interpolation_matrix(grid_shape, grid_bounds, sampling_points, *, distances=None):
    """Multilinear interpolation tables: ``(indices, weights)``, host numpy.

    ``indices`` (int64) / ``weights`` (float64) have shape ``(2^ndim,
    n_points)``; applying is ``(w * f.ravel()[idx]).sum(0)`` and the adjoint
    a segment sum (:func:`interpolation_table` runs both as K11).
    """
    sampling_points = np.asarray(sampling_points)
    if sampling_points.ndim != 2:
        raise ValueError("sampling_points must have shape (ndim, n_points)")
    ndim, n_points = sampling_points.shape
    if (distances is None) == (grid_bounds is None):
        raise ValueError("exactly one of `distances` or `grid_bounds` expected")
    if grid_bounds is not None:
        grid_bounds = np.asarray(grid_bounds)
        offset = grid_bounds[:, 0]
        distances = (grid_bounds[:, 1] - grid_bounds[:, 0]) / np.asarray(grid_shape)
    else:
        offset = np.zeros(ndim)
        distances = np.broadcast_to(np.asarray(distances), (ndim,))

    corners = np.mgrid[(slice(0, 2),) * ndim].reshape(ndim, -1)  # (ndim, 2^ndim)
    pos = (sampling_points - offset[:, None]) / distances[:, None]
    frac, base = np.modf(pos)
    base = base.astype(np.int64)

    n_corners = 2 ** ndim
    weights = np.zeros((n_corners, n_points))
    indices = np.zeros((n_corners, n_points), dtype=np.int64)
    for i in range(n_corners):
        weights[i] = np.prod(np.abs(1 - corners[:, i][:, None] - frac), axis=0)
        idx_nd = base + corners[:, i][:, None]
        indices[i] = np.ravel_multi_index(idx_nd, grid_shape, mode="clip")
    return indices, weights


def interpolation_table(indices, weights, grid_size: int, device=None,
                        dtype=torch.float64) -> los_interp.LosTable:
    """K11's table of the interpolation ``(indices, weights)`` onto a flat
    grid of ``grid_size`` cells, its weights in ``dtype`` (float64 or
    float32), on ``device`` (the configured one by default)."""
    device = config.default_device() if device is None else torch.device(device)
    weights = np.asarray(weights, dtype=str(dtype).replace("torch.", ""))
    return los_interp.LosTable.from_interpolation(indices, weights, (int(grid_size),)).to(device)


def apply_interpolation(table: los_interp.LosTable, field_flat):
    """``W f`` for flat fields ``(..., grid_size)`` -> ``(..., n_points)``."""
    return los_interp.integrate(field_flat, table)


def adjoint_interpolation(table: los_interp.LosTable, values):
    """``W^T v`` for ``(..., n_points)`` -> ``(..., grid_size)``."""
    return los_interp.integrate_adjoint(values, table)


def matmul_bttb(kernel_row, x):
    """Multiply the n-D (block-)Toeplitz covariance defined by
    ``K[i,j] = kernel_row[|i-j|]`` onto a grid-shaped ``x`` — exact, via
    circulant embedding to ``2N-1`` per axis and one n-D FFT.

    ``kernel_row`` holds the kernel evaluated at the distance of every grid
    point to the zero corner (shape = grid shape).
    """
    shp = tuple(kernel_row.shape)
    if tuple(x.shape) != shp:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match grid {shp}")
    emb_shp = tuple(2 * s - 1 for s in shp)
    # Embed: index m along each axis maps to distance min(m, 2s-1-m).
    emb = kernel_row
    for ax, s in enumerate(shp):
        mirror = emb.narrow(ax, 1, s - 1)
        emb = torch.cat([emb, mirror.flip(ax)], dim=ax)
    ft_k = torch.fft.rfftn(emb)
    ft_x = torch.fft.rfftn(x, s=emb_shp)
    prod = torch.fft.irfftn(ft_k * ft_x, s=emb_shp)
    return prod[tuple(slice(0, s) for s in shp)]


def _parse_jitter(jitter, sampling_points):
    if jitter is True:
        dt = np.asarray(sampling_points).dtype
        return 1e-8 if dt == np.float64 else 1e-6
    if jitter is False or jitter is None:
        return None
    return float(jitter)


def _padded_grid(grid_shape, grid_bounds, padding):
    """The grid padded by ``padding`` on each axis, centred on the
    original: ``(shape, bounds)``."""
    if not padding:
        return grid_shape, grid_bounds
    pad = 1.0 + padding
    shape_wpad = tuple(int(np.ceil(s * pad)) for s in grid_shape)
    scl = np.array(shape_wpad) / np.array(grid_shape)
    halfp = (grid_bounds[:, 1] - grid_bounds[:, 0]) * (scl - 1.0) / 2.0
    return shape_wpad, np.stack([grid_bounds[:, 0] - halfp, grid_bounds[:, 1] + halfp], axis=1)


def _dense_interpolation(indices, weights, n_points, n_cells):
    """The interpolation as a dense ``(n_points, n_cells)`` numpy matrix."""
    w_dense = np.zeros((n_points, n_cells))
    for c in range(indices.shape[0]):
        np.add.at(w_dense, (np.arange(n_points), indices[c]), weights[c])
    return w_dense


def _explicit_covariance(indices, weights, n_points, shape, bounds, distances, kernel, jitter):
    """``W k(|p - p'|) W^T (+ jitter)`` from a position-space kernel on the
    grid of ``shape`` (scipy distance matrix)."""
    from scipy.spatial import distance_matrix

    p = [b[0] + d * np.arange(s) for b, d, s in zip(bounds, distances, shape)]
    p = np.stack(np.meshgrid(*p, indexing="ij"), axis=-1).reshape(-1, len(shape))
    k_ind = np.asarray(kernel(distance_matrix(p, p)))
    w_dense = _dense_interpolation(indices, weights, n_points, k_ind.shape[0])
    cov = w_dense @ k_ind @ w_dense.T
    if jitter is not None:
        cov = cov + jitter * np.eye(n_points)
    return cov


class HarmonicSKI:
    """KISS-GP covariance operator with a harmonic (stationary-kernel)
    representation: ``C = W K W^T + jitter`` applied matrix-free.

    ``K`` is circulant on a padded inducing grid; with the unnormalized
    Hartley transform ``H`` and a continuous Fourier power ``P(k)``, ``K x =
    H((P/V) ⊙ H x)`` where ``V`` is the padded grid volume.  ``W`` is the
    multilinear interpolation of :func:`interpolation_matrix`, run by K11.
    A harmonic kernel is a function of a float64 tensor of mode lengths.
    """

    def __init__(
        self,
        grid_shape: Tuple[int, ...],
        grid_bounds,
        sampling_points,
        harmonic_kernel: Optional[Callable] = None,
        padding: float = 0.5,
        subslice=None,
        jitter=True,
        device=None,
    ):
        device = config.default_device() if device is None else torch.device(device)
        self.jitter = _parse_jitter(jitter, sampling_points)
        grid_shape = tuple(int(s) for s in grid_shape)
        grid_bounds = np.asarray(grid_bounds, dtype=float)
        self.grid_unpadded_shape = grid_shape
        self.grid_unpadded_bounds = grid_bounds
        self._indices, self._weights = interpolation_matrix(grid_shape, grid_bounds,
                                                            sampling_points)
        self.table = interpolation_table(self._indices, self._weights,
                                         int(np.prod(grid_shape)), device)
        self.n_points = np.asarray(sampling_points).shape[1]

        shape_wpad, bounds_wpad = _padded_grid(grid_shape, grid_bounds, padding)
        if padding and subslice is None:
            subslice = tuple(slice(0, s) for s in grid_shape)
        self.grid_shape = tuple(shape_wpad)
        self.grid_bounds = np.asarray(bounds_wpad)
        distances = (self.grid_bounds[:, 1] - self.grid_bounds[:, 0]) / np.array(self.grid_shape)
        self.grid_distances = distances
        self.grid_total_volume = float(np.prod(np.array(self.grid_shape) * distances))
        if isinstance(subslice, int):
            subslice = (slice(0, subslice),) * len(self.grid_shape)
        elif isinstance(subslice, slice):
            subslice = (subslice,) * len(self.grid_shape)
        elif subslice is not None:
            subslice = tuple(slice(0, el) if isinstance(el, int) else el for el in subslice)
        self.grid_subslice = subslice

        pd, um, _ = fourier_mode_distributor(self.grid_shape, distances)
        self.power_distributor = torch.from_numpy(pd.astype(np.int64)).to(device)
        self.unique_mode_lengths = torch.from_numpy(um).to(device)
        self._harmonic_kernel = harmonic_kernel

    @property
    def harmonic_kernel(self) -> Callable:
        if self._harmonic_kernel is None:
            raise TypeError("provide `harmonic_kernel` at init or per call")
        return self._harmonic_kernel

    def power(self, harmonic_kernel: Optional[Callable] = None):
        """Continuous Fourier power on the unique padded-grid modes."""
        hk = self.harmonic_kernel if harmonic_kernel is None else harmonic_kernel
        return hk(self.unique_mode_lengths)

    def amplitude(self, harmonic_kernel: Optional[Callable] = None):
        return torch.sqrt(self.power(harmonic_kernel))

    def _distribute(self, values):
        pd = self.power_distributor
        return values.index_select(0, pd.reshape(-1)).reshape(pd.shape)

    def harmonic_transform(self, x):
        return hartley(x) / self.grid_total_volume

    def correlated_field(self, x, harmonic_kernel: Optional[Callable] = None):
        """Generative view: white harmonic latent → GP on the inducing grid
        (covariance = the circulant ``K``)."""
        amp = self.amplitude(harmonic_kernel) / np.sqrt(self.grid_total_volume)
        f = hartley(self._distribute(amp) * x)
        return f if self.grid_subslice is None else f[self.grid_subslice]

    def sandwich(self, x, harmonic_kernel: Optional[Callable] = None):
        """Apply the (sub-sliced) circulant grid covariance ``K``."""
        if self.grid_subslice is not None:
            x_wpad = x.new_zeros(self.grid_shape)
            x_wpad[self.grid_subslice] = x
        else:
            x_wpad = x
        p = self._distribute(self.power(harmonic_kernel))
        s = hartley(p * hartley(x_wpad)) / self.grid_total_volume
        return s if self.grid_subslice is None else s[self.grid_subslice]

    def __call__(self, x, harmonic_kernel: Optional[Callable] = None):
        """Apply the data-space covariance ``W K W^T (+ jitter)``."""
        jit_term = 0.0 if self.jitter is None else self.jitter * x
        g = adjoint_interpolation(self.table, x.reshape(-1)).reshape(self.grid_unpadded_shape)
        g = self.sandwich(g, harmonic_kernel)
        out = apply_interpolation(self.table, g.reshape(-1))
        return out.reshape(x.shape) + jit_term

    def evaluate(self, harmonic_kernel: Optional[Callable] = None):
        """Materialize the covariance by probing with unit vectors."""
        eye = torch.eye(self.n_points, dtype=self.table.dtype, device=self.table.idx.device)
        return torch.stack([self(e, harmonic_kernel=harmonic_kernel) for e in eye]).T

    def evaluate_(self, kernel: Callable):
        """Explicit check: ``W k(|p - p'|) W^T`` from a position-space
        kernel on the *unpadded* inducing grid (scipy distance matrix)."""
        d_unpad = ((self.grid_unpadded_bounds[:, 1] - self.grid_unpadded_bounds[:, 0])
                   / np.array(self.grid_unpadded_shape))
        return _explicit_covariance(self._indices, self._weights, self.n_points,
                                    self.grid_unpadded_shape, self.grid_unpadded_bounds,
                                    d_unpad, kernel, self.jitter)


class ToeplitzSKI:
    """KISS-GP covariance with an exact (block-)Toeplitz kernel matrix on
    the inducing grid: ``C = W K W^T + jitter`` with ``K[i,j] =
    kernel(|p_i - p_j|)`` applied via :func:`matmul_bttb`.  A kernel is a
    function of a float64 tensor of distances (for :meth:`evaluate_`, of a
    numpy array)."""

    def __init__(
        self,
        grid_shape: Tuple[int, ...],
        grid_bounds,
        sampling_points,
        kernel: Optional[Callable] = None,
        jitter=True,
        device=None,
    ):
        device = config.default_device() if device is None else torch.device(device)
        self.jitter = _parse_jitter(jitter, sampling_points)
        grid_shape = tuple(int(s) for s in grid_shape)
        grid_bounds = np.asarray(grid_bounds, dtype=float)
        self.grid_shape = grid_shape
        self.grid_bounds = grid_bounds
        distances = (grid_bounds[:, 1] - grid_bounds[:, 0]) / np.array(grid_shape)
        self.grid_distances = distances
        mg = np.mgrid[tuple(slice(0, s) for s in grid_shape)].astype(float)
        mg *= distances.reshape((-1,) + (1,) * len(grid_shape))
        self.grid_distances_to_zero = torch.from_numpy(np.linalg.norm(mg, axis=0)).to(device)
        self._indices, self._weights = interpolation_matrix(grid_shape, grid_bounds,
                                                            sampling_points)
        self.table = interpolation_table(self._indices, self._weights,
                                         int(np.prod(grid_shape)), device)
        self.n_points = np.asarray(sampling_points).shape[1]
        self._kernel = kernel

    @property
    def kernel(self) -> Callable:
        if self._kernel is None:
            raise TypeError("provide `kernel` at init or per call")
        return self._kernel

    def __call__(self, x, kernel: Optional[Callable] = None):
        kernel = self.kernel if kernel is None else kernel
        jit_term = 0.0 if self.jitter is None else self.jitter * x
        g = adjoint_interpolation(self.table, x.reshape(-1)).reshape(self.grid_shape)
        g = matmul_bttb(kernel(self.grid_distances_to_zero), g)
        out = apply_interpolation(self.table, g.reshape(-1))
        return out.reshape(x.shape) + jit_term

    def evaluate(self, kernel: Optional[Callable] = None):
        eye = torch.eye(self.n_points, dtype=self.table.dtype, device=self.table.idx.device)
        return torch.stack([self(e, kernel=kernel) for e in eye]).T

    def evaluate_(self, kernel: Optional[Callable] = None):
        kernel = self.kernel if kernel is None else kernel
        return _explicit_covariance(self._indices, self._weights, self.n_points,
                                    self.grid_shape, self.grid_bounds, self.grid_distances,
                                    kernel, self.jitter)


class StructuredKernelInterpolation(Model):
    """Harmonic-kernel SKI model: ``x -> W · HT(sqrt(P) · x)``.

    The latent ``x`` is white in the harmonic domain of the (padded)
    inducing grid; ``sqrt(P)`` is the amplitude spectrum of the stationary
    kernel evaluated on the grid's mode lengths (``amplitude``, a function
    of a float64 tensor, evaluated once and kept in the domain's dtype);
    ``W`` interpolates to the sampling points (its weights in the domain's
    dtype).  Takes latents ``(..., *padded shape)`` with any leading batch
    axes.
    """

    def __init__(
        self,
        grid_shape: Tuple[int, ...],
        grid_bounds,
        sampling_points,
        amplitude: Callable,
        padding: float = 0.5,
        dtype=None,
        device=None,
    ):
        device = config.default_device() if device is None else torch.device(device)
        grid_shape = tuple(int(s) for s in grid_shape)
        grid_bounds = np.asarray(grid_bounds, dtype=float)
        indices, weights = interpolation_matrix(grid_shape, grid_bounds, sampling_points)
        # Pad the modeled grid to suppress periodic wrap-around.
        shape_wpad, bounds_wpad = _padded_grid(grid_shape, grid_bounds, padding)
        n_points = np.asarray(sampling_points).shape[1]
        super().__init__(domain=ShapeWithDtype(shape_wpad, dtype),
                         target=ShapeWithDtype((n_points,), dtype))
        dtype = self.domain.dtype
        self.table = interpolation_table(indices, weights, int(np.prod(grid_shape)), device,
                                         dtype)
        self._grid_shape = grid_shape
        self._padded_shape = tuple(shape_wpad)
        distances = (bounds_wpad[:, 1] - bounds_wpad[:, 0]) / np.array(shape_wpad)
        self.register_buffer("mode_lengths", torch.from_numpy(
            fourier_mode_lengths(shape_wpad, tuple(distances))).to(device), persistent=False)
        self.register_buffer("amplitude_on_grid", amplitude(self.mode_lengths).to(dtype),
                             persistent=False)
        self._amplitude = amplitude
        self._subslice = tuple(slice(0, s) for s in grid_shape)

    def grid_field(self, x):
        """The correlated field on the (unpadded) inducing grid."""
        ndim = len(self._padded_shape)
        f = hartley(self.amplitude_on_grid * x, axes=tuple(range(-ndim, 0))) / np.sqrt(
            np.prod(self._padded_shape))
        return f[(Ellipsis, *self._subslice)]

    def forward(self, x):
        f = self.grid_field(x)
        lead = f.shape[: f.ndim - len(self._grid_shape)]
        return apply_interpolation(self.table, f.reshape(*lead, -1))
