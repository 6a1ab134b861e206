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
    _config[key] = value


def get(key: str):
    return _config[key]


def default_float_dtype() -> torch.dtype:
    """Real dtype of latent state, data and solver vectors."""
    return torch.float64
