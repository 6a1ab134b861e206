"""Conjugate gradient on trees of tensors (counterpart of
:mod:`nifty_tpu.solvers.cg`).

The JAX solver is one ``lax.while_loop``; here it is a Python loop with
the same state and the same stopping rules: ``absdelta`` on the quadratic
energy with ``miniter``/``maxiter``, the ``resnorm`` fallback
``max(tol*|j|, atol)``, energy-increase and non-positive-curvature
detection, a residual recomputed every ``N_RESET`` steps, an optional
preconditioner, and the fixed-trip mode of ``deterministic_reductions``.
Solver scalars are Python floats (IEEE double, the port's state dtype).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import config
from ..logger import logger
from ..tree import norm as tree_norm
from ..tree import result_type, size, tree_axpy, tree_map, tree_sub, vdot, zeros_like

N_RESET = 20


class CGResults(NamedTuple):
    x: Any
    nit: int
    nfev: int
    info: int
    success: bool


def static_cg(mat, j, x0=None, *args, **kwargs):
    """Solve ``mat(x) = j``; returns ``(x, info)`` with ``info == 0`` on
    success, ``> 0`` when the iteration limit was hit, ``< 0`` on breakdown."""
    res = _static_cg(mat, j, x0, *args, **kwargs)
    return res.x, res.info


cg = static_cg


def _real(x) -> float:
    return float(x.real) if torch.is_tensor(x) else float(x)


def _half_residual_energy(r, j, pos) -> float:
    return _real(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos))


def _static_cg(
    mat: Callable,
    j,
    x0=None,
    *,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    tol: float = 1e-5,
    atol: float = 0.0,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    preconditioner: Optional[Callable] = None,
    name: Optional[str] = None,
    print_every: int = 1,
    _raise_nonposdef: bool = False,
    **_ignored,
) -> CGResults:
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(j)
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)

    def rnorm(tree):
        return _real(tree_norm(tree, ord=norm_ord))

    if absdelta is None and resnorm is None:
        resnorm = max(tol * rnorm(j), atol)

    finfo = torch.finfo(result_type(j))
    eps = 6.0 * finfo.eps
    tiny = 6.0 * finfo.tiny
    # Fixed-trip mode: the loop runs exactly `maxiter` trips; convergence
    # is recorded for `info` but changes nothing (see the JAX package).
    fixed_trips = bool(config.get("deterministic_reductions"))
    m_inv = preconditioner if preconditioner is not None else (lambda x: x)

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(torch.neg, j)
        energy = 0.0
        nfev0 = 0
    else:
        pos = x0
        r = tree_sub(mat(pos), j)
        energy = _half_residual_energy(r, j, pos)
        nfev0 = 1
    z = m_inv(r)
    gamma = _real(vdot(r, z))
    d = z

    info = 0 if gamma == 0.0 else -2
    nit, conv, halt = 0, False, 0
    while info < -1:
        i = nit + 1
        prev_gamma, prev_energy, prev_pos = gamma, energy, pos
        halted_before = fixed_trips and halt != 0

        q = mat(d)
        curv = _real(vdot(d, q))
        # Non-positive curvature: keep the pre-step position (first
        # iteration: a gradient step scaled by gamma/|curv|) and finish.
        nonpos_curv = curv <= 0.0
        alpha = prev_gamma / (1.0 if nonpos_curv else curv)
        new_pos = tree_axpy(-alpha, d, pos)
        if i % N_RESET == 0:
            new_r = tree_sub(mat(new_pos), j)
        else:
            new_r = tree_axpy(-alpha, q, r)
        new_z = m_inv(new_r)
        new_gamma = _real(vdot(new_r, new_z))

        new_conv = 0.0 <= new_gamma <= tiny
        if resnorm is not None:
            new_conv |= (rnorm(new_r) < resnorm) and i >= miniter
        new_energy = _half_residual_energy(new_r, j, new_pos)
        energy_diff = prev_energy - new_energy
        if absdelta is not None:
            new_conv |= (energy_diff < absdelta) and i >= miniter
        new_conv |= conv

        if fixed_trips:
            if energy_diff < -eps * abs(new_energy) and not new_conv and halt == 0:
                halt = -1
            if math.isnan(new_energy) and halt == 0:
                halt = -1
            if i >= maxiter:
                info = halt if halt != 0 else (0 if new_conv else i)
        else:
            if energy_diff < -eps * abs(new_energy):
                info = -1
            if new_conv and info != -1:
                info = 0
            if i >= maxiter and info != -1:
                info = i
            if math.isnan(new_energy):
                info = -1

        if nonpos_curv:
            if i == 1 and curv < 0.0:
                safe_abs_curv = 1.0 if curv == 0.0 else abs(curv)
                new_pos = tree_map(lambda x: (prev_gamma / safe_abs_curv) * x, j)
            else:
                new_pos = prev_pos
            if fixed_trips:
                if halt == 0:
                    halt = -1 if _raise_nonposdef else 1
            else:
                info = -1 if _raise_nonposdef else 0

        beta = max(0.0, new_gamma / prev_gamma) if prev_gamma > tiny else 0.0
        new_d = tree_axpy(beta, d, new_z)

        if name is not None and i % print_every == 0:
            logger.info(f"{name}: CG it {i} energy {new_energy} diff {energy_diff}")

        nit, conv = i, new_conv
        # a state halted before this trip idles through the fixed trips
        if not halted_before:
            pos, r, d, z = new_pos, new_r, new_d, new_z
            gamma, energy = new_gamma, new_energy

    if _raise_nonposdef and info < 0:
        raise FloatingPointError(
            "conjugate gradient broke down (non-positive-definite metric "
            f"or NaN energy; info={info})"
        )
    nfev = nfev0 + nit + nit // N_RESET
    return CGResults(x=pos, info=info, nit=nit, nfev=nfev, success=info == 0)
