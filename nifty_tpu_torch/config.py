"""Global configuration of the PyTorch port (counterpart of
:mod:`nifty_tpu.config`).

The keys and their allowed values are the JAX package's.  The precision
policy differs: the port keeps its latent state, solver scalars and energy
reductions in float64 on every device (an H100 runs complex128 FFTs
natively), so :func:`default_float_dtype` is float64.  Pure float32 is
known to stall Newton-CG and stays on the roadmap.
"""

from __future__ import annotations

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
}

_ALLOWED = {
    "hartley_convention": ("non_canonical_hartley", "canonical_hartley"),
    "deterministic_reductions": (True, False),
    "transform_compute_dtype": (None, "float32"),
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
    """Real dtype of latent state, data and solver vectors."""
    return torch.float64


def default_complex_dtype() -> torch.dtype:
    """complex128 where the default real dtype is float64, else complex64."""
    return torch.complex128 if default_float_dtype() == torch.float64 else torch.complex64
