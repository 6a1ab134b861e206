"""Non-uniform FFT (types 1 and 2) and a radio-interferometry response
(counterpart of :mod:`nifty_tpu.ops.nufft`).

The spreading kernel is the exp-of-semicircle (ES) kernel
``φ(t) = exp(β (sqrt(1 - t²) - 1))``; the image-domain deconvolution
factors are its Fourier transform by Gauss-Legendre quadrature.  Type 2
(uniform → non-uniform) deconvolves the image, zero-pads it to the
σ-oversampled grid, takes its FFT and interpolates a ``W^d`` window around
each point with ES weights; type 1 is its exact adjoint.  The window pair
is K7 (:mod:`nifty_tpu_torch.ops.nufft_window`): for static coordinates
the host builds a :class:`~nifty_tpu_torch.ops.nufft_window.WindowTable`
once, and a CUDA tensor runs the hand-written kernels.

Accuracy is set by ``W``: roughly ``10^{-W}`` at σ = 2 (about 1e-7 at
W = 8, 1e-13 at W = 16).  :class:`RadioResponse` handles the w-term by
w-stacking.  The JAX package's point-batched route and its sorted-window
switch were workarounds for faults of the TPU's runtime and have no
counterpart; ``window_consts=`` and ``sorted_windows=`` are accepted and
change no value.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config
from ..model import Model
from ..tree import ShapeWithDtype
from .bin_gather import sorted_scatter_aux
from .nufft_window import (
    WindowInterp,
    WindowSpread,
    WindowTable,
    deconv_factors,
    oversampled_shape,
)

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def nufft_window_aux(shape, coords, *, sigma: float = 2.0, width: int = 8):
    """The JAX package's window tables of static ``coords``, as int32 numpy
    arrays: ``cells`` (``(npts, W^d)`` flat cells on the oversampled grid),
    ``perm`` / ``sorted_ids`` (their stable argsort and its image) and
    ``i0`` (``(npts, d)`` window bases).  The port's kernels need only the
    positions and a CSR (:class:`~nifty_tpu_torch.ops.nufft_window.WindowTable`);
    these tables are kept for callers of the JAX package's interface."""
    shape = tuple(shape)
    d = len(shape)
    if not 1 <= d <= 3:
        raise NotImplementedError("nufft supports up to 3 dimensions")
    coords = np.asarray(coords, dtype=float)
    n_os = oversampled_shape(shape, sigma)
    offs = np.arange(width) - width // 2 + 1
    cells, i0s = None, []
    for ax in range(d):
        x = coords[:, ax] * (n_os[ax] / shape[ax])
        i0 = np.floor(x).astype(np.int64)
        i0s.append(i0)
        idx = (i0[:, None] + offs[None, :]) % n_os[ax]
        cells = idx if cells is None else (
            (cells[..., None] * n_os[ax]).reshape(coords.shape[0], -1, 1) + idx[:, None, :])
    flat = cells.reshape(coords.shape[0], -1).astype(np.int32)
    perm = sorted_scatter_aux(flat, int(np.prod(n_os)))["perm"]
    return dict(cells=flat, perm=perm, sorted_ids=flat.ravel()[perm].astype(np.int32),
                i0=np.stack(i0s, axis=-1).astype(np.int32))


def _compute_types(dtype):
    """The compute dtype of an input of ``dtype`` under the
    ``transform_compute_dtype`` policy, and the dtype of the result
    (None: that of the computation)."""
    if config.get("transform_compute_dtype") is not None and dtype in (
            torch.float64, torch.complex128):
        return (torch.complex64 if dtype.is_complex else torch.float32), torch.complex128
    return dtype, None


def _table_for(table, shape, coords, sigma, width, real_dtype, device):
    if table is not None:
        if table.dtype != real_dtype:
            raise TypeError(f"a {table.dtype} window table for a {real_dtype} computation")
        return table
    return WindowTable(shape, coords, sigma=sigma, width=width, dtype=real_dtype).to(device)


def _deconvolve(x, shape, table):
    d = len(shape)
    for ax in range(d):
        f = getattr(table, f"deconv{ax}")
        x = x * f.reshape([-1 if a == ax else 1 for a in range(d)])
    return x


def nufft2(image, coords=None, *, sigma: float = 2.0, width: int = 8, window_consts=None,
           table: WindowTable = None):
    """Type-2 NUFFT: complex visibilities at non-uniform frequencies.

    ``image``: real or complex ``(..., n_1, ..., n_d)``, pixel 0 at the
    center (fftshift convention); leading axes are batch axes.  ``coords``:
    ``(npoints, d)`` frequencies in cycles per image extent, in
    ``[-n/2, n/2)`` (numpy, or a tensor that requires no gradient), or
    ``table``, their :class:`WindowTable` built once.  Returns
    ``v_j = Σ_x image[x] exp(-2πi f_j · x / n)``, ``(..., npoints)``.
    ``window_consts`` (:func:`nufft_window_aux`) is accepted and changes no
    value."""
    del window_consts
    if table is not None:
        d = table.d
    else:
        d = coords.shape[-1] if torch.is_tensor(coords) else np.asarray(coords).shape[-1]
    shape = tuple(image.shape[image.ndim - d:])
    batch = tuple(image.shape[:image.ndim - d])
    compute, out_dtype = _compute_types(image.dtype)
    image = image.to(compute)
    real = image.real.dtype if image.is_complex() else image.dtype
    table = _table_for(table, shape, coords, sigma, width, real, image.device)
    if table.shape != shape:
        raise ValueError(f"a window table for images {table.shape}, not {shape}")
    corr = _deconvolve(image, shape, table)
    pad = []
    for n, no in zip(reversed(shape), reversed(table.os_shape)):
        pad += [(no - n) // 2, no - n - (no - n) // 2]
    dims = tuple(range(-d, 0))
    g = torch.fft.fftn(torch.fft.ifftshift(F.pad(corr, pad), dim=dims), dim=dims)
    g = g.reshape(-1, table.ncells).contiguous()
    vis = WindowInterp.apply(g, table).reshape(*batch, table.npts)
    return vis if out_dtype is None else vis.to(out_dtype)


def nufft1(shape, values, coords=None, *, sigma: float = 2.0, width: int = 8,
           table: WindowTable = None):
    """Type-1 NUFFT, the adjoint of :func:`nufft2`: non-uniform samples
    ``values`` ``(..., npoints)`` onto the centered grid of ``shape``,
    ``image[x] = Σ_j v_j exp(+2πi f_j · x / n)`` (complex)."""
    shape = tuple(int(n) for n in shape)
    d = len(shape)
    compute, out_dtype = _compute_types(values.dtype)
    if not compute.is_complex:
        compute = {torch.float32: torch.complex64, torch.float64: torch.complex128}[compute]
    values = values.to(compute)
    table = _table_for(table, shape, coords, sigma, width, _REAL[compute], values.device)
    batch = tuple(values.shape[:-1])
    g = WindowSpread.apply(values.reshape(-1, table.npts).contiguous(), table)
    dims = tuple(range(-d, 0))
    g = g.reshape(-1, *table.os_shape)
    # the adjoint of the forward DFT: the unnormalized inverse transform
    padded = torch.fft.fftshift(torch.fft.ifftn(g, dim=dims, norm="forward"), dim=dims)
    for ax, (n, no) in enumerate(zip(shape, table.os_shape)):
        padded = padded.narrow(ax + 1, (no - n) // 2, n)
    image = _deconvolve(padded, shape, table).reshape(*batch, *shape)
    return image if out_dtype is None else image.to(out_dtype)


class RadioResponse(Model):
    """Radio-interferometry measurement operator: sky image → visibilities.

    Optionally applies the w-term by w-stacking: the visibilities are
    grouped into ``n_w_planes`` bins of constant w, and each plane applies
    the phase screen ``exp(-2πi w (sqrt(1 - l² - m²) - 1))`` to the image
    before its 2-D NUFFT.  With ``w=None`` this is the coplanar gridder.

    The visibilities are sorted by w-plane and then by grid cell at
    construction (each plane a contiguous slice whose points are in cell
    order), and the output is unsorted at the end.  One
    :class:`~nifty_tpu_torch.ops.nufft_window.WindowTable` a plane is built
    on the host at construction for the domain's float type (another float
    type's at its first call).  The phase screens are evaluated once in
    float64 on the host: a float64 image is multiplied by them in
    complex128, a float32 one by their complex64 cast (a buffer made at its
    first use, as the window tables are), so a float32 computation stays in
    float32 throughout.  The model takes images ``(..., *shape)`` with any
    leading batch axes and returns ``(..., n_vis)``, complex128 for float64
    (complex64 for float32).  ``sorted_windows`` is accepted and changes no
    value.
    """

    def __init__(self, shape, uv, *, pixsize=None, w=None, n_w_planes: int = 8,
                 sigma: float = 2.0, width: int = 8, dtype=None, sorted_windows="auto",
                 device=None):
        del sorted_windows
        self._shape = tuple(int(n) for n in shape)
        uv = np.asarray(uv, dtype=float)
        if pixsize is not None:
            # uv in wavelengths -> cycles per image extent
            uv = uv * np.asarray(pixsize) * np.asarray(self._shape)
        cell = np.floor(uv * sigma).astype(np.int64)
        sort_keys = [cell[:, ax] for ax in range(cell.shape[1] - 1, -1, -1)]
        w_idx = None
        if w is not None:
            if pixsize is None:
                raise ValueError("w-correction requires `pixsize`")
            w = np.asarray(w, dtype=float)
            n_w_planes = max(1, min(n_w_planes, len(np.unique(w))))
            w_edges = np.linspace(w.min(), w.max() + 1e-12, n_w_planes + 1)
            w_idx = np.clip(np.digitize(w, w_edges) - 1, 0, n_w_planes - 1)
            sort_keys = sort_keys + [w_idx]
        sort = np.lexsort(tuple(sort_keys))
        uv = uv[sort]
        self._uv = uv
        self._sigma, self._width = sigma, width
        if w is None:
            self._w_slices, self._w_centers = ((0, uv.shape[0]),), None
        else:
            w_idx = w_idx[sort]
            planes = np.arange(n_w_planes)
            self._w_slices = tuple(
                (int(a), int(b)) for a, b in zip(np.searchsorted(w_idx, planes),
                                                 np.searchsorted(w_idx, planes + 1)))
            self._w_centers = 0.5 * (w_edges[:-1] + w_edges[1:])
        domain = ShapeWithDtype(self._shape, dtype)
        real = domain.dtype if not domain.dtype.is_complex else _REAL[domain.dtype]
        target = {torch.float64: torch.complex128, torch.float32: torch.complex64}[real]
        super().__init__(domain=domain, target=ShapeWithDtype((uv.shape[0],), target))
        device = config.default_device() if device is None else torch.device(device)
        self.register_buffer("unsort", torch.from_numpy(np.argsort(sort)).to(device),
                             persistent=False)
        if w is not None:
            ls = [np.arange(n) - n // 2 for n in self._shape]
            lm = np.meshgrid(*[l * p for l, p in zip(ls, np.atleast_1d(pixsize) * np.ones(2))],
                             indexing="ij")
            n_term = np.sqrt(np.maximum(1.0 - lm[0] ** 2 - lm[1] ** 2, 0.0)) - 1.0
            screens = np.stack([np.exp(-2j * np.pi * wc * n_term) for wc in self._w_centers])
            self.register_buffer("screens", torch.from_numpy(screens).to(device),
                                 persistent=False)
            self.register_buffer("screens_complex64", None, persistent=False)
        #: the planes that hold visibilities, in order
        self.planes = tuple(i for i, (a, b) in enumerate(self._w_slices) if b > a)
        self.tables = nn.ModuleDict()
        self.plane_tables(real)

    def plane_tables(self, dtype) -> nn.ModuleList:
        """The window tables of :attr:`planes` for computations in ``dtype``
        (float32 or float64), built at first use on the device of the
        model's buffers."""
        name = str(dtype).replace("torch.", "")
        if name not in self.tables:
            self.tables[name] = nn.ModuleList([
                WindowTable(self._shape, self._uv[slice(*self._w_slices[i])], sigma=self._sigma,
                            width=self._width, dtype=dtype).to(self.unsort.device)
                for i in self.planes])
        return self.tables[name]

    def plane_screens(self, dtype) -> torch.Tensor:
        """The phase screens ``(n_w_planes, *shape)`` for an image of
        ``dtype``: complex128 for float64 or complex128 images, their
        complex64 cast (made once) for float32 or complex64 ones."""
        if _REAL.get(dtype, dtype) == torch.float64:
            return self.screens
        if self.screens_complex64 is None:
            self.screens_complex64 = self.screens.to(torch.complex64)
        return self.screens_complex64

    def forward(self, image):
        compute, _ = _compute_types(image.dtype)
        tables = self.plane_tables(_REAL.get(compute, compute))
        if self._w_centers is None:
            vis = nufft2(image, table=tables[0])
        else:
            screens = self.plane_screens(image.dtype)
            vis = torch.cat([nufft2(image * screens[i], table=tab)
                             for i, tab in zip(self.planes, tables)], dim=-1)
        return vis.index_select(-1, self.unsort)
