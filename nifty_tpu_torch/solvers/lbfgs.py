"""Limited-memory BFGS (counterpart of :mod:`nifty_tpu.solvers.lbfgs`).

The JAX solver keeps a circular history of the last ``m`` pairs
``(s, y)`` over the raveled latent and runs the two-loop recursion; here
the history is a pair of tensors of shape (rows, m, n), the newest pair
last, and the loop is the lockstep loop of
:func:`~nifty_tpu_torch.solvers.descent._first_order_batched` (Armijo
backtracking, the JAX solver's status codes).  A pair is kept only where
``s·y > 1e-12`` and the line search succeeded.
"""

from __future__ import annotations

from typing import Optional

import torch

from .descent import _rows, _run_batched, row_dot, single_form
from .newton_cg import OptimizeResults


def _lbfgs_direction(g, s_hist, y_hist, rho_hist, valid):
    """The two-loop recursion ``H g`` for rows: ``g`` (B, n), histories
    (B, m, n) and (B, m), the newest pair last; invalid pairs count 0."""
    m = s_hist.shape[1]
    q, alphas = g, [None] * m
    for i in range(m - 1, -1, -1):
        alpha = torch.where(valid[:, i], rho_hist[:, i] * row_dot(s_hist[:, i], q),
                            torch.zeros_like(rho_hist[:, i]))
        q = q - _rows(alpha, q) * y_hist[:, i]
        alphas[i] = alpha
    ys = row_dot(s_hist[:, -1], y_hist[:, -1])
    yy = row_dot(y_hist[:, -1], y_hist[:, -1])
    good = valid[:, -1] & (yy > 0)
    gamma = torch.where(good, ys / torch.where(good, yy, torch.ones_like(yy)),
                        torch.ones_like(yy))
    r = _rows(gamma, q) * q
    for i in range(m):
        beta = torch.where(valid[:, i], rho_hist[:, i] * row_dot(y_hist[:, i], r),
                           torch.zeros_like(rho_hist[:, i]))
        r = r + _rows(alphas[i] - beta, r) * s_hist[:, i]
    return r


def shift_history(hist, new, keep):
    """The history (B, m, ...) with its oldest entry dropped and ``new``
    (zero where not ``keep``) appended as the newest."""
    new = torch.where(_rows(keep, new), new, torch.zeros_like(new))
    return torch.cat([hist[:, 1:], new[:, None]], dim=1)


def pair_update(x, x_new, g, g_new, failed):
    """The new pair ``(s, y)``, ``s·y``, whether it is kept and its ρ."""
    s_vec, y_vec = x_new - x, g_new - g
    sy = row_dot(s_vec, y_vec)
    keep = (sy > 1e-12) & ~failed
    rho = torch.where(keep, 1.0 / torch.where(keep, sy, torch.ones_like(sy)),
                      torch.zeros_like(sy))
    return s_vec, y_vec, keep, rho


def _lbfgs_batched(fun=None, x0=None, *, maxiter: int = 200, m: int = 10,
                   absdelta: Optional[float] = None, gtol: float = 1e-6, fun_and_grad=None,
                   name=None, **_ignored) -> OptimizeResults:
    """Lockstep L-BFGS; ``fun_and_grad`` maps batched trees to ``((B,)
    energies, batched gradients)``."""
    def aux0(flat):
        b, n = flat.shape
        return (flat.new_zeros((b, m, n)), flat.new_zeros((b, m, n)), flat.new_zeros((b, m)),
                torch.zeros((b, m), dtype=torch.bool, device=flat.device))

    def direction(g, d, aux):
        return -_lbfgs_direction(g, *aux)

    def update(x, x_new, g, g_new, d, failed, aux):
        s_h, y_h, rho_h, valid_h = aux
        s_vec, y_vec, keep, rho = pair_update(x, x_new, g, g_new, failed)
        return d, (shift_history(s_h, s_vec, keep), shift_history(y_h, y_vec, keep),
                   shift_history(rho_h, rho, keep), shift_history(valid_h, keep, keep))

    return _run_batched(fun_and_grad, x0, direction=direction, update=update, aux0=aux0,
                        maxiter=maxiter, gtol=gtol, absdelta=absdelta, name=name,
                        label="LBFGS")


def _lbfgs(fun=None, x0=None, **kwargs) -> OptimizeResults:
    return single_form(_lbfgs_batched, fun, x0, **kwargs)


_lbfgs.batched = _lbfgs_batched


def lbfgs(fun=None, x0=None, *args, **kwargs):
    return _lbfgs(fun, x0, *args, **kwargs).x
