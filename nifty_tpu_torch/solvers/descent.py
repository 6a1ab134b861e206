"""First-order descent minimizers: steepest descent and nonlinear CG
(counterpart of :mod:`nifty_tpu.solvers.descent`).

Each minimization runs over the raveled latent with an Armijo
backtracking line search (``c1 = 1e-4``, at most 20 halvings from t = 1),
a restart along ``-g`` wherever the direction is not one of descent, and
the JAX solvers' status codes: 0 converged (``|g| < gtol``, or an energy
decrease below ``absdelta``), -1 a failed line search, ``nit`` the
iteration limit.

:func:`_first_order_batched` is the one loop of this module, of L-BFGS and
of VL-BFGS: a batch of independent problems stacked on a leading axis, in
lockstep (what the JAX solvers become under ``vmap``).  The rows' scalars
are (B,) tensors, a finished row is frozen by a row-wise ``where``, and the
line search evaluates all rows and keeps each row's own trial while it
halves.  The single forms (``_steepest_descent``, ``_nonlinear_cg``, ...)
solve one problem as a batch of one row.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..logger import logger
from ..tree import add_row, first_row, tree_leaves, unravel
from .newton_cg import OptimizeResults, _prepare_vag_hessp

#: the Armijo constant and the most halvings of the line search
C1, MAX_HALVINGS = 1e-4, 20


def flatten_rows(tree):
    """A batched tree as a (B, n) matrix: each row its leaves raveled and
    concatenated in flatten order."""
    leaves = tree_leaves(tree)
    return torch.cat([x.reshape(x.shape[0], -1) for x in leaves], dim=1)


def _require_no_field_mesh():
    from ..tree import _MESH

    mesh = _MESH[0]
    if mesh is not None and mesh.size(mesh.field_axis) > 1:
        raise NotImplementedError(
            "the first-order minimizers ravel the latent and cannot reduce a field-sharded "
            "leaf over its ranks; on a field mesh use Newton-CG")


def rows_problem(fun_and_grad, x0):
    """The raveled problem of a batched ``fun_and_grad`` at the batched
    start ``x0``: ``(fg, X0, unflatten)`` with ``fg(X) -> ((B,) energies,
    (B, n) gradients)``.  A raveled row mixes the leaves, so it has no
    place on a field-sharded mesh."""
    _require_no_field_mesh()
    like = first_row(x0)

    def unflatten(flat):
        return unravel(like, flat)

    def fg(flat):
        value, grad = fun_and_grad(unflatten(flat))
        return torch.as_tensor(value).reshape(flat.shape[0]), flatten_rows(grad)

    return fg, flatten_rows(x0), unflatten


def single_form(batched, fun, x0, *, fun_and_grad=None, jac=None, hessp=None, hessp_at=None,
                custom_gradnorm=None, **kwargs):
    """``batched`` on one problem as a batch of one row: ``fun``,
    ``fun_and_grad``, ``hessp``, ``hessp_at`` and ``custom_gradnorm`` take
    and return unbatched trees.  ``fun``, ``status``, ``nit``, ``nfev``,
    ``njev``, ``nhev`` and ``trust_radius`` of the result are Python
    numbers, ``x`` and ``jac`` unbatched trees."""
    fun_and_grad, _ = _prepare_vag_hessp(fun, jac, lambda p, t: t, fun_and_grad)

    def vag_row(x):
        value, grad = fun_and_grad(first_row(x))
        return torch.as_tensor(value).reshape(1), add_row(grad)

    if hessp is not None:
        kwargs["hessp"] = lambda x, t: add_row(hessp(first_row(x), first_row(t)))
    if hessp_at is not None:
        def hessp_at_row(x):
            matvec = hessp_at(first_row(x))
            return lambda t: add_row(matvec(first_row(t)))

        kwargs["hessp_at"] = hessp_at_row
    if custom_gradnorm is not None:
        kwargs["custom_gradnorm"] = lambda t: torch.as_tensor(
            custom_gradnorm(first_row(t))).reshape(1)
    res = batched(None, add_row(x0), fun_and_grad=vag_row, **kwargs)
    scalars = {k: (None if v is None else int(v[0])) for k, v in
               (("status", res.status), ("nit", res.nit), ("nfev", res.nfev),
                ("njev", res.njev), ("nhev", res.nhev))}
    status = scalars.pop("status")
    return res._replace(
        x=first_row(res.x), jac=first_row(res.jac), fun=float(res.fun[0]), status=status,
        success=status >= 0, **scalars,
        trust_radius=None if res.trust_radius is None else float(res.trust_radius[0]))


def row_dot(a, b):
    """Each row's dot product of two (B, n) matrices."""
    return (a * b).sum(-1)


def _rows(c, x):
    return c.reshape((-1,) + (1,) * (x.ndim - 1))


def _inf_for_nan(f):
    return torch.where(torch.isnan(f), torch.full_like(f, math.inf), f)


def backtracking(fg, x, d, f, g, active):
    """Armijo backtracking from t = 1 for the ``active`` rows: ``(t, f_new,
    g_new, nfev, failed)``, each row's own, ``nfev`` the evaluations the
    row's search took.  A row halves while ``f_new > f + c1 t g·d`` and it
    has halved fewer than 20 times."""
    gd = row_dot(g, d)
    f_new, g_new = fg(x + d)
    f_new = _inf_for_nan(f_new)
    t = torch.ones_like(f)
    it = torch.zeros(f.shape, dtype=torch.int64, device=f.device)
    while True:
        need = active & (f_new > f + C1 * t * gd) & (it < MAX_HALVINGS)
        if not bool(need.any()):  # the line-search trip's one read-back
            break
        t_try = torch.where(need, t / 2.0, t)
        f_try, g_try = fg(x + _rows(t_try, x) * d)
        f_new = torch.where(need, _inf_for_nan(f_try), f_new)
        g_new = torch.where(_rows(need, g_new), g_try, g_new)
        t, it = t_try, it + need.long()
    return t, f_new, g_new, it + 1, f_new > f


def _first_order_batched(fg, x0, *, direction: Callable, update: Callable, aux0,
                         maxiter: int, gtol: float, absdelta: Optional[float], name,
                         label: str):
    """The lockstep loop of the first-order methods on raveled rows.

    ``direction(g, d, aux)`` returns the rows' search directions (the sign
    included) before the safeguard; ``update(x, x_new, g, g_new, d, failed,
    aux)`` returns ``(d_next, aux_next)``.  Returns ``(x, f, g, status,
    nit, nfev)``, each row's own."""
    f0, g = fg(x0)
    f = _inf_for_nan(f0)
    x, d, aux = x0, -g, aux0
    nrows, dev = f.shape[0], f.device
    status = torch.where(torch.linalg.vector_norm(g, dim=-1) < gtol,
                         torch.zeros(nrows, dtype=torch.int64, device=dev),
                         torch.full((nrows,), -2, dtype=torch.int64, device=dev))
    nit = torch.zeros(nrows, dtype=torch.int64, device=dev)
    nfev = torch.ones(nrows, dtype=torch.int64, device=dev)
    while True:
        active = status == -2
        if not bool(active.any()):  # the iteration's one read-back
            break
        it_new = nit + 1
        d = direction(g, d, aux)
        d = torch.where(_rows(row_dot(d, g) < 0, d), d, -g)
        t, f_ls, g_ls, nfev_ls, failed = backtracking(fg, x, d, f, g, active)
        x_new = torch.where(_rows(failed, x), x, x + _rows(t, x) * d)
        f_new = torch.where(failed, f, f_ls)
        g_new = torch.where(_rows(failed, g), g, g_ls)
        d_new, aux_new = update(x, x_new, g, g_new, d, failed, aux)

        new_status = torch.where(failed, torch.full_like(status, -1), status)
        gnorm = torch.linalg.vector_norm(g_new, dim=-1)
        new_status = torch.where(gnorm < gtol, torch.zeros_like(status), new_status)
        if absdelta is not None:
            conv = (f - f_new >= 0) & (f - f_new < absdelta) & ~failed
            new_status = torch.where(conv, torch.zeros_like(status), new_status)
        new_status = torch.where((it_new >= maxiter) & (new_status == -2), it_new, new_status)
        if name is not None:
            logger.info(f"{name}: {label} it {it_new.tolist()} f {f_new.tolist()} "
                        f"|g| {gnorm.tolist()}")

        keep = ~active
        x = torch.where(_rows(keep, x), x, x_new)
        f = torch.where(keep, f, f_new)
        g = torch.where(_rows(keep, g), g, g_new)
        d = torch.where(_rows(keep, d), d, d_new)
        aux = tuple(torch.where(_rows(keep, a), a, b) for a, b in zip(aux, aux_new))
        nit = torch.where(keep, nit, it_new)
        nfev = torch.where(keep, nfev, nfev + nfev_ls)
        status = torch.where(keep, status, new_status)
    return x, f, g, status, nit, nfev


def _run_batched(fun_and_grad, x0, *, direction, update, aux0, maxiter, gtol, absdelta, name,
                 label):
    fg, flat0, unflatten = rows_problem(fun_and_grad, x0)
    x, f, g, status, nit, nfev = _first_order_batched(
        fg, flat0, direction=direction, update=update, aux0=aux0(flat0), maxiter=maxiter,
        gtol=gtol, absdelta=absdelta, name=name, label=label)
    return OptimizeResults(x=unflatten(x), success=status >= 0, status=status, fun=f,
                           jac=unflatten(g), nit=nit, nfev=nfev, njev=nfev)


def _keep_direction(g, d, aux):
    return d


def _steepest_descent_batched(fun=None, x0=None, *, maxiter: int = 200, gtol: float = 1e-6,
                              absdelta: Optional[float] = None, fun_and_grad=None, name=None,
                              **_ignored) -> OptimizeResults:
    """Lockstep steepest descent; ``fun_and_grad`` maps batched trees to
    ``((B,) energies, batched gradients)``."""
    def update(x, x_new, g, g_new, d, failed, aux):
        return -g_new, aux

    return _run_batched(fun_and_grad, x0, direction=_keep_direction, update=update,
                        aux0=lambda flat: (), maxiter=maxiter, gtol=gtol, absdelta=absdelta,
                        name=name, label="SD")


def _nonlinear_cg_batched(fun=None, x0=None, *, maxiter: int = 200, gtol: float = 1e-6,
                          absdelta: Optional[float] = None, fun_and_grad=None, name=None,
                          beta_heuristics: str = "polak-ribiere", **_ignored) -> OptimizeResults:
    """Lockstep nonlinear CG (Polak-Ribière+ or Hestenes-Stiefel+: β < 0
    clipped to 0, an automatic restart)."""
    bh = beta_heuristics.lower().replace("_", "-")
    if bh not in ("polak-ribiere", "hestenes-stiefel"):
        raise ValueError(f"invalid beta heuristics {beta_heuristics!r}")

    def update(x, x_new, g, g_new, d, failed, aux):
        dg = g_new - g
        if bh == "polak-ribiere":
            denom = row_dot(g, g)
            beta = row_dot(g_new, dg) / torch.where(denom > 0, denom, torch.ones_like(denom))
        else:
            denom = row_dot(d, dg)
            beta = row_dot(g_new, dg) / torch.where(denom.abs() > 0, denom,
                                                      torch.ones_like(denom))
        beta = torch.clamp_min(beta, 0.0)
        return -g_new + _rows(beta, d) * d, aux

    return _run_batched(fun_and_grad, x0, direction=_keep_direction, update=update,
                        aux0=lambda flat: (), maxiter=maxiter, gtol=gtol, absdelta=absdelta,
                        name=name, label="NLCG")


def _steepest_descent(fun=None, x0=None, **kwargs) -> OptimizeResults:
    return single_form(_steepest_descent_batched, fun, x0, **kwargs)


def _nonlinear_cg(fun=None, x0=None, **kwargs) -> OptimizeResults:
    """Nonlinear conjugate gradient, Polak-Ribière+ or Hestenes-Stiefel+."""
    return single_form(_nonlinear_cg_batched, fun, x0, **kwargs)


_steepest_descent.batched = _steepest_descent_batched
_nonlinear_cg.batched = _nonlinear_cg_batched


def steepest_descent(fun=None, x0=None, *args, **kwargs):
    return _steepest_descent(fun, x0, *args, **kwargs).x


def nonlinear_cg(fun=None, x0=None, *args, **kwargs):
    return _nonlinear_cg(fun, x0, *args, **kwargs).x
