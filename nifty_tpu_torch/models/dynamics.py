"""Causal dynamics priors and light-cone kernels for PDE-like signals
(counterpart of :mod:`nifty_tpu.models.dynamics`).

A non-parametric prior over the Green's function of a linear homogeneous
dynamical system, optionally causal (step-function support in time),
minimum-phase (the cepstrum construction: causalized log-spectrum, then
exponentiation) and confined to a light cone with learned propagation
speeds.  Every transform is a Hartley transform over the trailing
``len(shape)`` axes, so leading batch axes of the latents carry through.
The light cone's derivative comes from autograd.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import config
from ..model import Model
from ..ops.harmonic import hartley
from ..tree import ShapeWithDtype, random_like


def _coords(shape, distances):
    """Centered signed coordinates per axis, broadcast to ``shape``."""
    out = []
    for i, (n, d) in enumerate(zip(shape, distances)):
        x = (np.arange(n) - n // 2) * d
        x = np.roll(x, -(n // 2))  # fft-style ordering: 0, d, ..., -d
        sl = [None] * len(shape)
        sl[i] = slice(None)
        out.append(x[tuple(sl)])
    return out


def light_cone_kernel(c, shape, distances, sigx: float):
    """Smooth light-cone indicator ``exp(-Δ²/2)`` with
    ``Δ = Re sqrt(-(t/σx dt)² + Σ c_i (x_i/σx dx_i)²)``.

    Axis 0 is time; ``c`` holds the squared inverse lightspeeds per
    spatial axis.
    """
    xs = [torch.as_tensor(x, dtype=torch.float64, device=c.device)
          for x in _coords(shape, distances)]
    a = -((xs[0] / (sigx * distances[0])) ** 2)
    a = a.to(torch.complex128 if c.dtype == torch.float64 else torch.complex64)
    for i in range(len(shape) - 1):
        a = a + c[i] * (xs[i + 1] / (sigx * distances[i + 1])) ** 2
    # Double-where guards the sqrt branch point at the cone boundary: the
    # derivative there is zeroed instead of NaN.
    on_boundary = a.abs() < 1e-30
    safe_a = torch.where(on_boundary, torch.ones_like(a), a)
    delta = torch.where(on_boundary, torch.zeros_like(a.real), torch.sqrt(safe_a).real)
    return torch.exp(-0.5 * delta ** 2)


def _step_in_time(shape):
    """1 + sign(t) mask (doubles the causal half, zeroes the acausal)."""
    n = shape[0]
    t = np.roll(np.arange(n) - n // 2, -(n // 2))
    mask = 1.0 + np.sign(t)
    return mask.reshape((n,) + (1,) * (len(shape) - 1))


def _padded_shape(shape, harmonic_padding):
    if harmonic_padding is None:
        return tuple(shape)
    if isinstance(harmonic_padding, int):
        harmonic_padding = [harmonic_padding] * len(shape)
    return tuple(s + p for s, p in zip(shape, harmonic_padding))


def _central_crop(x, shape):
    """The central ``shape`` of the trailing axes of ``x``, in fft order."""
    dims = tuple(range(-len(shape), 0))
    slices = tuple(
        slice((xs - s) // 2, (xs - s) // 2 + s)
        for xs, s in zip(x.shape[-len(shape):], shape)
    )
    return torch.fft.ifftshift(torch.fft.fftshift(x, dim=dims)[(Ellipsis,) + slices], dim=dims)


class _GreensFunction(Model):
    """The Green's function model of :func:`dynamic_operator`; its constant
    arrays are buffers, so ``.to()`` moves them."""

    def __init__(self, *, shape, distances, smoother, key, domain, minimum_phase, causal,
                 cone, lightcone_key, sigc, quant):
        super().__init__(domain=dict(domain), init=partial(random_like, primals=domain))
        self.shape, self.distances, self.key = shape, distances, key
        self.minimum_phase, self.causal, self.cone = minimum_phase, causal, cone
        self.lightcone_key, self.quant = lightcone_key, quant
        self.npix_pad = float(smoother.size)
        device = config.default_device()
        for name, arr in (("smoother", smoother), ("step", _step_in_time(shape)),
                          ("sigc", sigc), ("dratio", np.asarray(distances[1:]) / distances[0])):
            if arr is not None:
                self.register_buffer(name, torch.as_tensor(arr, dtype=torch.float64,
                                                           device=device), persistent=False)

    def _hartley(self, x):
        return hartley(x, axes=tuple(range(-len(self.shape), 0)))

    def log_transfer(self, p):
        """The smooth log-spectrum on the padded grid, cropped."""
        L = self._hartley(self.smoother * p[self.key]) / self.npix_pad
        return _central_crop(L, self.shape)

    def lightspeed(self, p):
        return torch.exp(-0.5 * self.sigc * p[self.lightcone_key]) * self.dratio

    def forward(self, p):
        n = float(np.prod(self.shape))
        L = self.log_transfer(p)
        if self.minimum_phase:
            # cepstrum method: causalize the log-spectrum, then exp
            g = self._hartley(L) / n * self.step
            G = torch.exp(self._hartley(g))
        else:
            G = torch.exp(L)
            if self.causal:
                g = self._hartley(G) / n * self.step
                G = self._hartley(g)
        if self.cone:
            c = torch.exp(self.sigc * p[self.lightcone_key])
            cone_k = light_cone_kernel(c, self.shape, self.distances, self.quant)
            g = self._hartley(G) / n * cone_k
            G = self._hartley(g)
        return G


def dynamic_operator(
    *,
    shape,
    distances,
    sm_s0: float,
    sm_x0,
    key: str,
    causal: bool = True,
    minimum_phase: bool = False,
    harmonic_padding: Union[None, int, Sequence[int]] = None,
    cone: bool = False,
    lightcone_key: Optional[str] = None,
    sigc=None,
    quant: Optional[float] = None,
):
    """Prior over the harmonic-space Green's function of a dynamic system.

    The log-transfer function is a smooth random field (white latent
    ``key`` smoothed by ``sm_s0 / (1 + Σ (x_i / sm_x0_i)²)`` on a
    zero-padded grid); ``causal`` multiplies the kernel by a time step
    function, ``minimum_phase`` uses the cepstrum construction, and
    ``cone``/``lightcone_key`` confines the kernel to a learned light
    cone.  Returns ``(model, aux_models)``.
    """
    shape = tuple(shape)
    distances = tuple(np.broadcast_to(distances, (len(shape),)).astype(float))
    sm_x0 = list(np.broadcast_to(sm_x0, (len(shape),)).astype(float))
    pshape = _padded_shape(shape, harmonic_padding)

    # Smoothing profile in the (padded) delay domain.
    xs = _coords(pshape, distances)
    prof = 1.0
    for i in range(len(pshape)):
        prof = prof + (np.asarray(xs[i]) / sm_x0[i] / distances[i]) ** 2
    smoother = np.broadcast_to(sm_s0 / prof, pshape).copy()

    domain = {key: ShapeWithDtype(pshape)}
    sigc_arr, lk = None, None
    if cone:
        if len(shape) < 2:
            raise ValueError("light cone requires at least one spatial axis")
        if sigc is None or quant is None:
            raise ValueError("`cone` requires `sigc` and `quant`")
        sigc_arr = np.broadcast_to(sigc, (len(shape) - 1,)).astype(float)
        lk = lightcone_key if lightcone_key is not None else key + "_cone"
        domain[lk] = ShapeWithDtype((len(shape) - 1,))

    model = _GreensFunction(
        shape=shape, distances=distances, smoother=smoother, key=key, domain=domain,
        minimum_phase=minimum_phase, causal=causal, cone=cone, lightcone_key=lk,
        sigc=sigc_arr, quant=quant)
    aux = {"smoothed_dynamics": Model(
        model.log_transfer, domain={key: domain[key]},
        init=partial(random_like, primals={key: domain[key]}),
    )}
    if cone:
        aux["lightspeed"] = model.lightspeed
    return model, aux


def dynamic_lightcone_operator(*, shape, distances, sm_s0, sm_x0, key,
                               lightcone_key, sigc, quant,
                               causal: bool = True,
                               minimum_phase: bool = False,
                               harmonic_padding=None):
    """Green's-function prior confined to a learned light cone."""
    return dynamic_operator(
        shape=shape, distances=distances, sm_s0=sm_s0, sm_x0=sm_x0, key=key,
        causal=causal, minimum_phase=minimum_phase,
        harmonic_padding=harmonic_padding, cone=True,
        lightcone_key=lightcone_key, sigc=sigc, quant=quant,
    )


__all__ = ["dynamic_lightcone_operator", "dynamic_operator", "light_cone_kernel"]
