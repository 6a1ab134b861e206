"""Vector-free L-BFGS (counterpart of :mod:`nifty_tpu.solvers.vlbfgs`).

The two-loop recursion is re-expressed on the basis ``B = [s_0 .. s_{m-1},
y_0 .. y_{m-1}, g]`` (oldest to newest): every inner product it needs is
an entry of the (2m + 1) × (2m + 1) Gram matrix ``G = B Bᵀ``, one batched
matrix product an iteration, after which the recursion runs on a (2m + 1)
coefficient vector and the direction is one product ``δᵀ B``.  The loop is
:func:`~nifty_tpu_torch.solvers.descent._first_order_batched`, with the
basis a tensor of shape (rows, 2m + 1, n).
"""

from __future__ import annotations

from typing import Optional

import torch

from .descent import _run_batched, row_dot, single_form
from .lbfgs import pair_update, shift_history
from .newton_cg import OptimizeResults


def _vl_direction(G, rho, valid, m):
    """The recursion on Gram coefficients for rows: ``G`` (B, 2m+1, 2m+1),
    ``rho`` and ``valid`` (B, m).  Returns δ (B, 2m+1), the direction
    ``Σ_j δ_j B_j`` with the descent sign included."""
    nrows, nb = G.shape[0], 2 * m + 1
    delta = G.new_zeros((nrows, nb))
    delta[:, 2 * m] = -1.0
    alphas = [None] * m
    for i in range(m - 1, -1, -1):
        alpha = torch.where(valid[:, i], rho[:, i] * row_dot(G[:, i], delta),
                            torch.zeros_like(rho[:, i]))
        delta[:, m + i] -= alpha
        alphas[i] = alpha
    ys, yy = G[:, m - 1, 2 * m - 1], G[:, 2 * m - 1, 2 * m - 1]
    good = valid[:, m - 1] & (yy > 0)
    gamma = torch.where(good, ys / torch.where(good, yy, torch.ones_like(yy)),
                        torch.ones_like(yy))
    delta = gamma[:, None] * delta
    for i in range(m):
        beta = torch.where(valid[:, i], rho[:, i] * row_dot(G[:, m + i], delta),
                           torch.zeros_like(rho[:, i]))
        delta[:, i] += alphas[i] - beta
    return delta


def _vlbfgs_batched(fun=None, x0=None, *, maxiter: int = 200, m: int = 10,
                    absdelta: Optional[float] = None, gtol: float = 1e-6, fun_and_grad=None,
                    name=None, **_ignored) -> OptimizeResults:
    """Lockstep VL-BFGS; ``fun_and_grad`` maps batched trees to ``((B,)
    energies, batched gradients)``."""
    def aux0(flat):
        b, n = flat.shape
        return (flat.new_zeros((b, 2 * m, n)), flat.new_zeros((b, m)),
                torch.zeros((b, m), dtype=torch.bool, device=flat.device))

    def direction(g, d, aux):
        sy_basis, rho, valid = aux
        basis = torch.cat([sy_basis, g[:, None]], dim=1)
        gram = torch.bmm(basis, basis.transpose(1, 2))
        delta = _vl_direction(gram, rho, valid, m)
        return torch.bmm(delta[:, None], basis)[:, 0]

    def update(x, x_new, g, g_new, d, failed, aux):
        sy_basis, rho_h, valid_h = aux
        s_vec, y_vec, keep, rho = pair_update(x, x_new, g, g_new, failed)
        s_blk = shift_history(sy_basis[:, :m], s_vec, keep)
        y_blk = shift_history(sy_basis[:, m:], y_vec, keep)
        return d, (torch.cat([s_blk, y_blk], dim=1), shift_history(rho_h, rho, keep),
                   shift_history(valid_h, keep, keep))

    return _run_batched(fun_and_grad, x0, direction=direction, update=update, aux0=aux0,
                        maxiter=maxiter, gtol=gtol, absdelta=absdelta, name=name,
                        label="VL-BFGS")


def _vlbfgs(fun=None, x0=None, **kwargs) -> OptimizeResults:
    return single_form(_vlbfgs_batched, fun, x0, **kwargs)


_vlbfgs.batched = _vlbfgs_batched


def vlbfgs(fun=None, x0=None, *args, **kwargs):
    return _vlbfgs(fun, x0, *args, **kwargs).x
