"""Matplotlib multipanel plotting of fields, spectra and histories
(counterpart of :mod:`nifty_tpu.plot`).

Panels take tensors (copied to the host), numpy arrays and the port's
:class:`~nifty_tpu_torch.field.Field` over RG/GL/HP/Power domains.
Matplotlib is imported inside :meth:`Plot.output` alone, so the rest of
the port runs without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(x):
    """A numpy array of a tensor (from any device) or of an array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _mollweide_from_gl(arr2d, nlat, nlon, xsize=512):
    """Rasterize a (nlat, nlon) GL-grid map into a Mollweide image."""
    from .ops.sht import gauss_legendre_quadrature

    theta, _ = gauss_legendre_quadrature(nlat)
    ysize = xsize // 2
    res = np.full((ysize, xsize), np.nan)
    yy, xx = np.mgrid[0:ysize, 0:xsize]
    x = 2 * np.sqrt(2) * (xx + 0.5 - xsize / 2) / (xsize / 2)
    y = np.sqrt(2) * (yy + 0.5 - ysize / 2) / (ysize / 2)
    mask = x ** 2 / 8 + y ** 2 / 2 <= 1
    t = np.arcsin(np.clip(y[mask] / np.sqrt(2), -1, 1))
    lat = np.arcsin(np.clip((2 * t + np.sin(2 * t)) / np.pi, -1, 1))
    lon = np.pi + np.pi * x[mask] / (2 * np.sqrt(2) * np.maximum(np.cos(t), 1e-9))
    th = np.pi / 2 - lat
    it = np.clip(np.searchsorted(theta, th), 0, nlat - 1)
    ip = (lon / (2 * np.pi) * nlon).astype(int) % nlon
    res[mask] = _host(arr2d)[it, ip]
    return res


def _mollweide_from_hp(arr, nside, xsize=512, nest=False):
    from .ops import healpix as hpx

    ysize = xsize // 2
    res = np.full((ysize, xsize), np.nan)
    yy, xx = np.mgrid[0:ysize, 0:xsize]
    x = 2 * np.sqrt(2) * (xx + 0.5 - xsize / 2) / (xsize / 2)
    y = np.sqrt(2) * (yy + 0.5 - ysize / 2) / (ysize / 2)
    mask = x ** 2 / 8 + y ** 2 / 2 <= 1
    t = np.arcsin(np.clip(y[mask] / np.sqrt(2), -1, 1))
    lat = np.arcsin(np.clip((2 * t + np.sin(2 * t)) / np.pi, -1, 1))
    lon = np.pi + np.pi * x[mask] / (2 * np.sqrt(2) * np.maximum(np.cos(t), 1e-9))
    pix = hpx.ang2pix(nside, np.pi / 2 - lat, lon, nest=nest)
    res[mask] = _host(arr)[pix]
    return res


def rgb_from_frequencies(cube, *, sat_quantile: float = 0.99,
                         gamma: float = 2.2):
    """Render a multi-frequency image cube ``(n_freq, ny, nx)`` as an RGB
    array ``(ny, nx, 3)``.

    Capability parity with the reference's multi-frequency RGB plotting
    (``src/plot.py:63``): frequency channels are
    spread evenly across the visible band and weighted by Gaussian
    R/G/B response curves; intensities are normalized at ``sat_quantile``
    and gamma-compressed.
    """
    cube = np.asarray(_host(cube), dtype=np.float64)
    if cube.ndim != 3:
        raise ValueError("expected a (n_freq, ny, nx) cube")
    nf = cube.shape[0]
    # Channel centers from "red" (low freq) to "blue" (high freq) on [0,1].
    pos = np.linspace(0.0, 1.0, nf) if nf > 1 else np.array([0.5])
    centers = {"r": 0.08, "g": 0.5, "b": 0.92}
    width = 0.25 + 0.4 / nf
    rgb = np.zeros(cube.shape[1:] + (3,))
    for ch, (_, c) in enumerate(centers.items()):
        w = np.exp(-0.5 * ((pos - c) / width) ** 2)
        w /= w.sum()
        rgb[..., ch] = np.tensordot(w, cube, axes=(0, 0))
    rgb = np.clip(rgb, 0.0, None)
    scale = np.quantile(rgb, sat_quantile)
    if scale > 0:
        rgb = np.clip(rgb / scale, 0.0, 1.0)
    return rgb ** (1.0 / gamma)


class EnergyHistory:
    """Scalar series over iterations (energies); a plottable panel."""

    def __init__(self):
        self._its, self._vals = [], []

    def append(self, nit, value):
        self._its.append(int(nit))
        self._vals.append(float(value))

    @property
    def iterations(self):
        return list(self._its)

    @property
    def values(self):
        return list(self._vals)

    def __len__(self):
        return len(self._its)


class Plot:
    """Collect panels with :meth:`add`, render with :meth:`output`.

    Panel types: Fields over RG/GL/HP/Power domains, raw arrays,
    :class:`EnergyHistory` objects, multi-frequency RGB cubes
    (``add(cube, freqs_as_rgb=True)``), and sample-set uncertainty pairs
    (``add_uncertainty(samples_of_arrays)`` → mean and std panels)."""

    def __init__(self):
        self._panels = []

    def add(self, obj, **kwargs):
        self._panels.append((obj, kwargs))

    def add_uncertainty(self, stacked, *, title: str = "", **kwargs):
        """Add mean and standard-deviation panels of a stack of posterior
        samples (leading axis = samples)."""
        arr = _host(stacked)
        if arr.ndim < 2:
            raise ValueError("expected a (n_samples, ...) stack")
        self.add(arr.mean(0), title=f"{title} mean".strip(), **kwargs)
        self.add(arr.std(0), title=f"{title} std".strip(), **kwargs)

    def _plot_panel(self, ax, obj, kwargs):
        from .domains import GLSpace, HPSpace, PowerSpace, RGSpace
        from .field import Field

        title = kwargs.pop("title", None)
        label = kwargs.pop("label", None)

        if kwargs.pop("freqs_as_rgb", False):
            rgb_kw = {
                k: kwargs.pop(k) for k in ("sat_quantile", "gamma")
                if k in kwargs
            }
            arr = _host(obj.val if isinstance(obj, Field) else obj)
            ax.imshow(
                np.transpose(rgb_from_frequencies(arr, **rgb_kw), (1, 0, 2)),
                origin="lower", **kwargs,
            )
        elif isinstance(obj, EnergyHistory):
            ax.plot(obj.iterations, obj.values, marker="o", label=label,
                    **kwargs)
            ax.set_xlabel("iteration")
            ax.set_ylabel("energy")
        elif isinstance(obj, Field):
            dom = obj.domain[0] if len(obj.domain) == 1 else None
            arr = _host(obj.val)
            if isinstance(dom, PowerSpace):
                ax.loglog(dom.k_lengths[1:], arr[1:], label=label, **kwargs)
            elif isinstance(dom, GLSpace):
                img = _mollweide_from_gl(
                    arr.reshape(dom.nlat, dom.nlon), dom.nlat, dom.nlon
                )
                ax.imshow(img, origin="lower", **kwargs)
                ax.axis("off")
            elif isinstance(dom, HPSpace):
                img = _mollweide_from_hp(arr, dom.nside)
                ax.imshow(img, origin="lower", **kwargs)
                ax.axis("off")
            elif isinstance(dom, RGSpace) and arr.ndim == 2:
                ax.imshow(arr.T, origin="lower", **kwargs)
            else:
                ax.plot(arr, label=label, **kwargs)
        else:
            arr = _host(obj)
            if arr.ndim == 2:
                ax.imshow(arr.T, origin="lower", **kwargs)
            else:
                ax.plot(arr, label=label, **kwargs)
        if title:
            ax.set_title(title)
        if label:
            ax.legend()

    def output(self, *, name: Optional[str] = None, nx: Optional[int] = None,
               ny: Optional[int] = None, xsize: float = 9, ysize: float = 9,
               dpi: int = 100):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = len(self._panels)
        if nx is None and ny is None:
            nx = int(np.ceil(np.sqrt(n)))
            ny = int(np.ceil(n / nx))
        elif nx is None:
            nx = int(np.ceil(n / ny))
        elif ny is None:
            ny = int(np.ceil(n / nx))
        fig, axes = plt.subplots(ny, nx, figsize=(xsize, ysize), squeeze=False)
        for i, (obj, kwargs) in enumerate(self._panels):
            self._plot_panel(axes.flat[i], obj, kwargs)
        for j in range(n, nx * ny):
            axes.flat[j].axis("off")
        fig.tight_layout()
        if name is not None:
            fig.savefig(name, dpi=dpi)
        plt.close(fig)
        self._panels = []


__all__ = ["EnergyHistory", "Plot", "rgb_from_frequencies"]
