"""Trust-region Newton with a CG-Steihaug subproblem solver (counterpart
of :mod:`nifty_tpu.solvers.trust_ncg`; Nocedal & Wright, chapter 4).

The subproblem stops at the boundary of the trust region along the current
direction on non-positive curvature or when a step would leave the region,
and in the interior once the residual is below ``resnorm``.  The outer
loop accepts a step where the actual over the predicted decrease exceeds
``eta``, shrinks the radius by 4 below 0.25 and doubles it (up to
``max_trust_radius``) above 0.75 at the boundary.  Status 0: ``|g| <
gtol``, an accepted decrease below ``absdelta`` or a radius below 1e-12;
``nit`` the iteration limit.

Both loops are lockstep loops over rows, as
:func:`~nifty_tpu_torch.solvers.newton_cg._newton_cg_batched` is: a batch
of problems stacked on a leading axis, each row with its own radius,
subproblem iterate and counters, a finished row frozen by a row-wise
``where``.  A subproblem step evaluates the quadratic model where the
row's case needs it: one Hessian product for the new direction and one
for the model point (two where a row meets non-positive curvature).
``nhev`` counts as the JAX solver counts (three a subproblem step).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..logger import logger
from ..tree import (
    axpy_rows,
    norm_rows,
    size,
    tree_map,
    vdot_rows,
    where_rows,
    zeros_like,
)
from .descent import single_form
from .newton_cg import OptimizeResults, _prepare_vag_hessp


class _QuadSubResult(NamedTuple):
    step: Any
    hits_boundary: Any
    pred_f: Any
    nit: Any
    nhev: Any
    success: Any


def _boundary_intersections(z, d, trust_radius):
    """Each row's ``t`` with ``||z + t d|| == trust_radius``, as a sorted
    pair of (B,) tensors."""
    a = vdot_rows(d, d).real
    b = 2 * vdot_rows(z, d).real
    c = vdot_rows(z, z).real - trust_radius ** 2
    sqrt_disc = torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))
    aux = b + torch.copysign(sqrt_disc, b)
    ta = -aux / (2 * a)
    tb = -2 * c / aux
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def cg_steihaug_subproblem_batched(cur_val, g, hessp_at_xk: Callable, *, trust_radius,
                                   resnorm: Optional[float] = None,
                                   absdelta: Optional[float] = None, norm_ord=None,
                                   miniter: Optional[int] = None,
                                   maxiter: Optional[int] = None, active=None) -> _QuadSubResult:
    """The quadratic model's minimizer within the trust region for a batch of
    rows: ``cur_val`` and ``trust_radius`` (B,), ``g`` a batched tree,
    ``hessp_at_xk`` a batched matvec; rows not ``active`` take no step."""
    nrows = cur_val.shape[0]
    dev = cur_val.device
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * (size(g) // nrows)
    miniter = min(6, maxiter_fallback) if miniter is None else miniter
    maxiter = max(min(200, maxiter_fallback), miniter) if maxiter is None else maxiter
    mag_g = norm_rows(g, ord=norm_ord)
    if resnorm is None:
        resnorm = torch.clamp_max(torch.sqrt(mag_g), 0.5) * mag_g
    cur_val = cur_val.to(torch.float64)
    trust_radius = torch.as_tensor(trust_radius, dtype=cur_val.dtype, device=dev)

    def model(p, hp):
        return cur_val + vdot_rows(g, p).real + 0.5 * vdot_rows(p, hp).real

    z = zeros_like(g)
    r = g
    d = tree_map(torch.neg, g)
    step, pred_f = z, cur_val
    hits = torch.zeros(nrows, dtype=torch.bool, device=dev)
    done = mag_g < resnorm
    if active is not None:
        done = done | ~active
    nit = torch.zeros(nrows, dtype=torch.int64, device=dev)
    nhev = torch.zeros(nrows, dtype=torch.int64, device=dev)
    gamma = vdot_rows(r, r).real
    false = torch.zeros_like(hits)
    while True:
        act = ~done & (nit < maxiter)
        if not bool(act.any()):  # the subproblem step's one read-back
            break
        hd = hessp_at_xk(d)
        curv = vdot_rows(d, hd).real
        nonpos = curv <= 0
        alpha = gamma / torch.where(nonpos, torch.ones_like(curv), curv)
        z_new = axpy_rows(alpha, d, z)
        exits = norm_rows(z_new, ord=2) >= trust_radius
        ta, tb = _boundary_intersections(z, d, trust_radius)
        pa, pb = axpy_rows(ta, d, z), axpy_rows(tb, d, z)
        r_new = axpy_rows(alpha, hd, r)
        # each row's model point: pa (and pb) on non-positive curvature, pb
        # where the step leaves the region, else the interior iterate
        q = where_rows(nonpos, pa, where_rows(exits, pb, z_new))
        model_q = model(q, hessp_at_xk(q))
        if bool((act & nonpos).any()):
            model_pb = model(pb, hessp_at_xk(pb))
        else:
            model_pb = model_q
        better_a = model_q < model_pb
        p = where_rows(nonpos, where_rows(better_a, pa, pb), q)
        pf = torch.where(nonpos, torch.where(better_a, model_q, model_pb), model_q)
        new_hits = nonpos | exits
        converged = norm_rows(r_new, ord=norm_ord) < resnorm
        new_done = torch.where(new_hits, ~false, converged)
        gamma_new = vdot_rows(r_new, r_new).real
        beta = gamma_new / gamma
        d_new = axpy_rows(beta, d, tree_map(torch.neg, r_new))
        z_out = where_rows(new_hits, z, p)
        z_out = where_rows(~new_hits & ~new_done, z_new, z_out)

        keep = ~act
        z, r, d = (where_rows(keep, a, b) for a, b in ((z, z_out), (r, r_new), (d, d_new)))
        step = where_rows(keep, step, p)
        pred_f = torch.where(keep, pred_f, pf)
        hits = torch.where(keep, hits, new_hits)
        done = torch.where(keep, done, new_done)
        nit = torch.where(keep, nit, nit + 1)
        nhev = torch.where(keep, nhev, nhev + 3)
        gamma = torch.where(keep, gamma, gamma_new)
    step = where_rows(done, step, z)
    step = where_rows(nit == 0, zeros_like(g), step)
    pred = torch.where(nit == 0, cur_val, pred_f)
    return _QuadSubResult(step=step, hits_boundary=hits, pred_f=pred, nit=nit, nhev=nhev,
                          success=~false)


def cg_steihaug_subproblem(cur_val, g, hessp_at_xk: Callable, *, trust_radius,
                           **kwargs) -> _QuadSubResult:
    """The subproblem of one problem: :func:`cg_steihaug_subproblem_batched`
    on a batch of one row."""
    from ..tree import add_row, first_row

    res = cg_steihaug_subproblem_batched(
        torch.as_tensor(cur_val, dtype=torch.float64).reshape(1), add_row(g),
        lambda t: add_row(hessp_at_xk(first_row(t))),
        trust_radius=torch.as_tensor(trust_radius, dtype=torch.float64).reshape(1), **kwargs)
    return _QuadSubResult(step=first_row(res.step), hits_boundary=bool(res.hits_boundary[0]),
                          pred_f=float(res.pred_f[0]), nit=int(res.nit[0]),
                          nhev=int(res.nhev[0]), success=True)


cg_steihaug_subproblem.batched = cg_steihaug_subproblem_batched


def _trust_ncg_batched(fun=None, x0=None, *, maxiter: Optional[int] = None,
                       energy_reduction_factor=0.1, old_fval=math.nan, absdelta=None,
                       gtol: float = 1e-4, max_trust_radius: float = 1000.0,
                       initial_trust_radius: float = 1.0, eta: float = 0.15,
                       subproblem=cg_steihaug_subproblem_batched, jac=None, hessp=None,
                       hessp_at=None, fun_and_grad=None,
                       subproblem_kwargs: Optional[dict] = None, name=None,
                       **_ignored) -> OptimizeResults:
    """Lockstep trust-region Newton-CG: ``fun_and_grad(x)`` returns ``((B,)
    energies, batched gradient)``, ``hessp(x, t)`` and ``hessp_at(x)(t)``
    map batched trees row by row."""
    maxiter = 200 if maxiter is None else maxiter
    if fun_and_grad is None or (hessp is None and hessp_at is None):
        raise ValueError("the batched trust-region Newton-CG needs `fun_and_grad` and "
                         "`hessp` or `hessp_at`")
    subproblem = getattr(subproblem, "batched", subproblem)
    subproblem_kwargs = dict(subproblem_kwargs or {})
    x, (f, g) = x0, fun_and_grad(x0)
    f = torch.as_tensor(f)
    nrows, dev = f.shape[0], f.device
    tr = torch.full((nrows,), float(initial_trust_radius), dtype=f.dtype, device=dev)
    zero = torch.zeros(nrows, dtype=torch.int64, device=dev)
    status = torch.where(norm_rows(g, ord=2) < gtol, zero, zero - 2)
    nit, nfev, nhev = zero, zero + 1, zero
    while True:
        act = status == -2
        if not bool(act.any()):  # the iteration's one read-back
            break
        it_new = nit + 1
        hessp_lin = hessp_at(x) if hessp_at is not None else partial(hessp, x)
        result = subproblem(f, g, hessp_lin, trust_radius=tr, active=act,
                            **subproblem_kwargs)
        x_prop = tree_map(torch.add, x, result.step)
        f_prop, g_prop = fun_and_grad(x_prop)
        f_prop = torch.as_tensor(f_prop)
        f_prop = torch.where(torch.isnan(f_prop), torch.full_like(f_prop, math.inf), f_prop)
        actual = f - f_prop
        predicted = f - result.pred_f
        rho = actual / torch.where(predicted == 0, torch.full_like(predicted, 1e-30),
                                   predicted)
        tr_new = torch.where(rho < 0.25, tr * 0.25, tr)
        grow = (rho > 0.75) & result.hits_boundary
        tr_new = torch.where(grow, torch.clamp_max(2 * tr, max_trust_radius), tr_new)
        accept = rho > eta
        x_new = where_rows(accept, x_prop, x)
        f_new = torch.where(accept, f_prop, f)
        g_new = where_rows(accept, g_prop, g)

        new_status = status
        if absdelta is not None:
            conv = accept & (actual >= 0) & (actual < absdelta)
            new_status = torch.where(conv, zero, new_status)
        new_status = torch.where(norm_rows(g_new, ord=2) < gtol, zero, new_status)
        new_status = torch.where(tr_new < 1e-12, zero, new_status)
        new_status = torch.where((it_new >= maxiter) & (new_status == -2), it_new, new_status)
        if name is not None:
            logger.info(f"{name}: TR it {it_new.tolist()} fun {f_new.tolist()} radius "
                        f"{tr_new.tolist()} rho {rho.tolist()}")

        keep = ~act
        x, g = where_rows(keep, x, x_new), where_rows(keep, g, g_new)
        f, tr = torch.where(keep, f, f_new), torch.where(keep, tr, tr_new)
        nit = torch.where(keep, nit, it_new)
        nfev = torch.where(keep, nfev, nfev + 1)
        nhev = torch.where(keep, nhev, nhev + result.nhev)
        status = torch.where(keep, status, new_status)
    return OptimizeResults(x=x, success=status >= 0, status=status, fun=f, jac=g, nit=nit,
                           nfev=nfev, njev=nfev, nhev=nhev, trust_radius=tr)


def _trust_ncg(fun=None, x0=None, *, jac=None, hessp=None, fun_and_grad=None,
               **kwargs) -> OptimizeResults:
    """One problem: :func:`_trust_ncg_batched` on a batch of one row."""
    fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)
    return single_form(_trust_ncg_batched, None, x0, fun_and_grad=fun_and_grad, hessp=hessp,
                       **kwargs)


_trust_ncg.batched = _trust_ncg_batched


def trust_ncg(fun=None, x0=None, *args, **kwargs):
    return _trust_ncg(fun, x0, *args, **kwargs).x
