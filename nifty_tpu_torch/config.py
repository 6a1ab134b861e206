"""Global configuration of the PyTorch port (counterpart of
:mod:`nifty_tpu.config`).

The keys and their allowed values are the JAX package's, with two of the
port's own: ``"device"``, and ``"enable_x64"``, the counterpart of
``jax.config.jax_enable_x64`` that switches the JAX package.  By default
(``True``) latent state, data, solver scalars and energy reductions are
float64 on every device (an H100 runs complex128 FFTs natively);
``update("enable_x64", False)`` makes :func:`default_float_dtype` float32
and the correlated field's path, its likelihoods, solvers, geoVI stages
and ``optimize_kl`` run in float32 end to end.  A model takes the dtype in
force when it is built (its buffers and its domain's
:class:`~nifty_tpu_torch.tree.ShapeWithDtype` leaves) and keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

_config = {
    # "non_canonical_hartley" computes Re(F) + Im(F) (the historic
    # default); "canonical_hartley" computes Re(F) - Im(F).
    "hartley_convention": "non_canonical_hartley",
    # Fixed-order reductions: tree dot products and norms use a
    # fold-halving association that depends only on array shapes, the
    # solvers run fixed trip counts, and the sample mean is a pairwise
    # tree.  The distributor's segment sum is deterministic either way.
    "deterministic_reductions": False,
    # "float32": the correlated field's harmonic transform runs in float32
    # while the state stays float64.  None keeps the ambient dtype.
    "transform_compute_dtype": None,
    # Where models, latents and data are placed when the caller names no
    # device: the card.  ``update("device", "cpu")`` asks for the CPU; with
    # the default and no card, :func:`default_device` raises.
    "device": "cuda",
    # False: the default real dtype is float32 (jax_enable_x64 off).
    "enable_x64": True,
}

_ALLOWED = {
    "hartley_convention": ("non_canonical_hartley", "canonical_hartley"),
    "deterministic_reductions": (True, False),
    "transform_compute_dtype": (None, "float32"),
    "enable_x64": (True, False),
}


def update(key: str, value):
    """Update a global configuration value (validated)."""
    if key not in _config:
        raise KeyError(f"unknown config key {key!r}")
    allowed = _ALLOWED.get(key)
    if allowed is not None and value not in allowed:
        raise ValueError(f"invalid value {value!r} for {key!r}; one of {allowed}")
    if key == "device":
        value = str(torch.device(value))  # validates the name
    _config[key] = value


def get(key: str):
    return _config[key]


def default_device() -> torch.device:
    """The device that "no device given" resolves to (the ``device`` key).

    Raises when that is a CUDA device and there is none: nothing falls back
    to the CPU on its own.
    """
    device = torch.device(_config["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the configured device is {str(device)!r} but no CUDA device is available; "
            'config.update("device", "cpu") asks for the CPU'
        )
    return device


def default_float_dtype() -> torch.dtype:
    """Real dtype of latent state, data and solver vectors: float64 iff
    ``enable_x64``, else float32."""
    return torch.float64 if _config["enable_x64"] else torch.float32


_NARROW = {torch.float64: torch.float32, torch.complex128: torch.complex64}
_NUMPY = {torch.float64: np.float64, torch.float32: np.float32}


def canonical_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` as JAX holds it: with ``enable_x64`` off float64 and
    complex128 become float32 and complex64."""
    return dtype if _config["enable_x64"] else _NARROW.get(dtype, dtype)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to :func:`canonical_dtype` of its dtype (itself where that
    is its own)."""
    dtype = canonical_dtype(x.dtype)
    return x if dtype == x.dtype else x.to(dtype)


def host_floats(values) -> torch.Tensor:
    """A host table as a CPU tensor of :func:`default_float_dtype`: computed
    in float64 and cast once, as the JAX package's float64 numpy constants
    become float32 where x64 is off."""
    host = np.asarray(values, dtype=np.float64)
    return torch.from_numpy(host.astype(_NUMPY[default_float_dtype()], copy=False))


def default_complex_dtype() -> torch.dtype:
    """complex128 where the default real dtype is float64, else complex64."""
    return torch.complex128 if default_float_dtype() == torch.float64 else torch.complex64
