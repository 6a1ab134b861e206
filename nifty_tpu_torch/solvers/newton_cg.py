"""Newton-CG on trees of tensors (counterpart of
:mod:`nifty_tpu.solvers.newton_cg`).

A Python loop with the JAX solver's semantics: the inner CG's ``absdelta``
is scaled from the Newton energy decrease (``energy_reduction_factor``),
its ``resnorm`` is ``min(0.5, sqrt(|g|)) * |g|``, the line search halves up
to 9 times with a gradient-rescue reset at attempt 6, NaN energies count
as +inf, a nonmonotone margin ``ls_margin * |energy|`` decides near-ties,
and convergence is ``absdelta`` on the energy plus ``xtol * size(x)`` on
the descent norm (optionally a custom gradient norm, as geoVI's sample
norm).  ``hessp_at(x)``, when given, returns the Hessian matvec at ``x``
with its primal work hoisted; it is called once per Newton step.

:func:`_newton_cg_batched` is the one loop: it minimizes a batch of
independent problems stacked on a leading axis in lockstep (what the JAX
solver becomes under ``vmap``).  Per-sample energies, line searches,
convergence tests and inner CG tolerances are (B,) tensors on the device,
finished samples are frozen by a row-wise ``where``, and the loops (Newton,
line search, inner CG) each read one number back per trip.
:func:`_newton_cg` minimizes one problem as a batch of one row.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import config
from ..likelihood import hessian_vector_product, linearize, value_and_grad
from ..logger import logger
from ..tree import (
    add_row,
    axpy_rows,
    first_row,
    norm_rows,
    result_type,
    scale_rows,
    size,
    tree_leaves,
    vdot_rows,
    where_rows,
)
from .cg import _static_cg_batched

_EPS_SHARE = 100.0  # absdelta fallback divisor for the inner CG


class OptimizeResults(NamedTuple):
    """Optimization result container (scipy-style)."""

    x: Any
    success: Any
    status: Any
    fun: Any
    jac: Any
    hess: Optional[Any] = None
    hess_inv: Optional[Any] = None
    nfev: Any = None
    njev: Any = None
    nhev: Any = None
    nit: Any = None
    trust_radius: Any = None
    jac_magnitude: Any = None
    good_approximation: Any = None


def _prepare_vag_hessp(fun, jac, hessp, fun_and_grad):
    if fun_and_grad is None:
        if fun is not None and jac is not None:
            def fun_and_grad(x):
                return fun(x), jac(x)
        elif fun is not None:
            fun_and_grad = partial(value_and_grad, fun)
        else:
            raise ValueError("no function specified")
    if hessp is None:
        if jac is not None:
            def hessp(primals, tangents):
                return linearize(jac, primals)[1](tangents)
        elif fun is not None:
            hessp = partial(hessian_vector_product, fun)
        else:
            raise ValueError("Newton-CG needs `hessp`, `jac` or `fun`")

    return fun_and_grad, hessp


def newton_cg(fun=None, x0=None, *args, **kwargs):
    """Minimize via Newton-CG; returns only the solution tree."""
    return _newton_cg(fun, x0, *args, **kwargs).x


def _newton_cg(
    fun=None,
    x0=None,
    *,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    hessp_at: Optional[Callable] = None,
    cg: Optional[Callable] = None,
    custom_gradnorm: Optional[Callable] = None,
    **kwargs,
) -> OptimizeResults:
    """One problem: row 0 of :func:`_newton_cg_batched` on a batch of one,
    so both forms share every rule.  ``fun``, ``jac``, ``fun_and_grad``,
    ``hessp``, ``hessp_at`` and ``custom_gradnorm`` take and return
    unbatched trees; ``cg``, when given, is a batched CG
    (:func:`~nifty_tpu_torch.solvers.cg._static_cg_batched`'s signature).
    ``fun`` of the result is a Python float, ``status``, ``nit``, ``nfev``
    and ``nhev`` are Python ints."""
    fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    def vag_row(x):
        value, grad = fun_and_grad(first_row(x))
        return torch.as_tensor(value).reshape(1), add_row(grad)

    def hessp_row(x, t):
        return add_row(hessp(first_row(x), first_row(t)))

    def hessp_at_row(x):
        matvec = hessp_at(first_row(x))
        return lambda t: add_row(matvec(first_row(t)))

    def gradnorm_row(t):
        return torch.as_tensor(custom_gradnorm(first_row(t))).reshape(1)

    if cg is not None:
        kwargs["cg"] = cg
    res = _newton_cg_batched(
        None, add_row(x0),
        fun_and_grad=vag_row,
        hessp=hessp_row,
        hessp_at=None if hessp_at is None else hessp_at_row,
        custom_gradnorm=None if custom_gradnorm is None else gradnorm_row,
        **kwargs,
    )
    status = int(res.status)
    return OptimizeResults(
        x=first_row(res.x), success=status >= 0, status=status, fun=float(res.fun),
        jac=first_row(res.jac), nit=int(res.nit), nfev=int(res.nfev), njev=int(res.njev),
        nhev=int(res.nhev),
    )


def _values(energy):
    return torch.where(torch.isnan(energy), torch.full_like(energy, math.inf), energy)


def _newton_cg_batched(
    fun=None,
    x0=None,
    *,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=None,
    absdelta: Optional[float] = None,
    norm_ord: Optional[int] = None,
    xtol: float = 1e-5,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    hessp_at: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = _static_cg_batched,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
    linearize_hessp: bool = True,
    ls_margin: Optional[float] = None,
    **_ignored,
) -> OptimizeResults:
    """Lockstep Newton-CG over a batch: every leaf of ``x0`` is (B, ...).

    ``fun_and_grad(x)`` returns ``((B,) energies, batched gradient)``,
    ``hessp(x, t)`` and ``hessp_at(x)(t)`` map batched trees row by row, and
    ``custom_gradnorm`` returns a (B,) tensor.  The rules apply per
    sample; ``fun``, ``status``, ``nit``,
    ``nfev`` and ``nhev`` of the result are (B,) tensors.
    """
    if fun_and_grad is None or (hessp is None and hessp_at is None):
        raise ValueError("the batched Newton-CG needs `fun_and_grad` and `hessp` or `hessp_at`")
    if hessp is None:
        def hessp(primals, tangents):
            return hessp_at(primals)(tangents)
    leaves = tree_leaves(x0)
    nrows, device = leaves[0].shape[0], leaves[0].device
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * (size(x0) // nrows)

    cg_kwargs = dict(cg_kwargs or {})
    cg_name = cg_kwargs.pop("name", name + "CG" if name is not None else None)
    gradnorm = (
        partial(norm_rows, ord=norm_ord) if custom_gradnorm is None
        else custom_gradnorm
    )

    made = {}

    def const(value, dtype=torch.int64):
        # one tensor per value for the whole solve (none is written in place)
        if (value, dtype) not in made:
            made[value, dtype] = torch.full((nrows,), value, dtype=dtype, device=device)
        return made[value, dtype]

    energy0, g0 = fun_and_grad(x0)
    energy = _values(energy0)
    if ls_margin is None:
        eps = torch.finfo(result_type(x0)).eps
        ls_margin = (1e6 if eps < 1e-12 else 1e4) * eps
    if old_fval is None:
        old_e = torch.full_like(energy, math.inf)
    else:
        old_e = torch.as_tensor(old_fval, dtype=energy.dtype, device=device).expand(nrows)
    if maxiter == 0:
        return OptimizeResults(
            x=x0, success=const(True, torch.bool), status=const(0), fun=energy,
            jac=g0, nit=const(0), nfev=const(1), njev=const(1), nhev=const(0),
        )
    if absdelta is not None:
        cg_fallback = torch.full_like(energy, absdelta / _EPS_SHARE)
    else:
        cg_fallback = torch.full_like(energy, -math.inf)

    fixed_trips = bool(config.get("deterministic_reductions"))

    pos, g = x0, g0
    status, nit, nfev, nhev, halt = const(-2), const(0), const(1), const(0), const(0)
    conv = const(False, torch.bool)
    trip = 0
    while True:
        done = status > -2
        n_done = int(done.sum())  # the Newton trip's one read-back
        if n_done == nrows:
            break
        trip = i = trip + 1
        halted_before = halt != 0

        if energy_reduction_factor > 0:
            cg_absdelta = torch.where(
                torch.isfinite(old_e), energy_reduction_factor * (old_e - energy), cg_fallback)
        else:
            cg_absdelta = cg_fallback
        mag_g = norm_rows(g, ord=cg_kwargs.get("norm_ord", 1))
        cg_resnorm = torch.clamp_max(torch.sqrt(mag_g), 0.5) * mag_g
        if linearize_hessp and hessp_at is not None:
            hessp_lin = hessp_at(pos)
        else:
            hessp_lin = partial(hessp, pos)
        cg_res = cg(
            hessp_lin, g,
            absdelta=cg_absdelta,
            resnorm=cg_resnorm,
            norm_ord=1,
            name=cg_name,
            _raise_nonposdef=False,
            active=~done,
            **cg_kwargs,
        )
        nat_g = cg_res.x
        new_status = torch.where(cg_res.info < 0, const(-1), status)

        # energy-monotonic backtracking with a gradient-rescue reset, in
        # lockstep: a sample that accepted its step keeps it while the
        # others go on halving
        accept_tol = ls_margin * energy.abs()
        it, scale, dd = const(0), torch.ones_like(energy), nat_g
        new_pos = axpy_rows(-scale, dd, pos)
        new_energy, new_g = fun_and_grad(new_pos)
        new_energy = _values(new_energy)
        ls_trip = 0
        while ls_trip < 9:
            need = (new_energy > energy + accept_tol) & ~done
            if not int(need.sum()):  # the line-search trip's one read-back
                break
            ls_trip += 1
            try_scale = scale / 2.0
            try_dd = dd
            if ls_trip == 6:
                gam = vdot_rows(g, g).real
                curv = vdot_rows(g, hessp(pos, g)).real
                try_dd = scale_rows(gam / curv, g)
                try_scale = torch.ones_like(scale)
            try_pos = axpy_rows(-try_scale, try_dd, pos)
            try_energy, try_g = fun_and_grad(try_pos)
            try_energy = _values(try_energy)
            it = torch.where(need, const(ls_trip), it)
            scale = torch.where(need, try_scale, scale)
            new_energy = torch.where(need, try_energy, new_energy)
            if ls_trip == 6:
                dd = where_rows(need, try_dd, dd)
            new_pos = where_rows(need, try_pos, new_pos)
            new_g = where_rows(need, try_g, new_g)
        ls_failed = new_energy > energy + accept_tol
        new_halt = halt
        if fixed_trips:
            new_halt = torch.where(ls_failed & ~conv & (halt == 0), const(-1), halt)
        else:
            new_status = torch.where(ls_failed & (new_status == -2), const(-1), new_status)
        new_pos = where_rows(ls_failed, pos, new_pos)
        new_g = where_rows(ls_failed, g, new_g)
        new_energy = torch.where(ls_failed, energy, new_energy)

        energy_diff = energy - new_energy
        descent_norm = scale * gradnorm(dd)
        if name is not None:
            logger.info(
                f"{name}: NCG it {i} energy {new_energy.tolist()} diff "
                f"{energy_diff.tolist()} |desc| {descent_norm.tolist()}"
            )

        new_conv = const(False, torch.bool)
        if i > miniter:
            if absdelta is not None:
                new_conv = (energy_diff >= -accept_tol) & (energy_diff < absdelta) & (it < 2)
            new_conv = new_conv | (descent_norm <= xtol)
        new_conv = new_conv | conv
        if fixed_trips:
            if i >= maxiter:
                new_status = torch.where(
                    new_halt != 0, new_halt, torch.where(new_conv, const(0), const(i)))
        else:
            new_status = torch.where(new_conv & (new_status == -2), const(0), new_status)
            if i >= maxiter:
                new_status = torch.where(new_status == -2, const(i), new_status)

        keep = done
        keep_vectors = done | halted_before if fixed_trips else done
        if n_done or fixed_trips:
            new_pos = where_rows(keep_vectors, pos, new_pos)
            new_g = where_rows(keep_vectors, g, new_g)
            new_energy = torch.where(keep_vectors, energy, new_energy)
            new_old_e = torch.where(keep_vectors, old_e, energy)
            new_conv = torch.where(keep, conv, new_conv)
            new_status = torch.where(keep, status, new_status)
            new_halt = torch.where(keep, halt, new_halt)
        else:
            new_old_e = energy
        nit = torch.where(keep, nit, const(i))
        nfev = torch.where(keep, nfev, nfev + it + 1)
        nhev = torch.where(keep, nhev, nhev + cg_res.nfev)
        pos, g, old_e, energy = new_pos, new_g, new_old_e, new_energy
        conv, status, halt = new_conv, new_status, new_halt

    return OptimizeResults(
        x=pos, success=status >= 0, status=status, fun=energy, jac=g,
        nit=nit, nfev=nfev, njev=nfev, nhev=nhev,
    )


def _method(method: str):
    """The single form of the minimizer named ``method`` and the options it
    takes apart from ``minimize``'s."""
    method = method.lower()
    if method in ("newton-cg", "newtoncg", "ncg"):
        return _newton_cg, {}
    if method in ("trust-ncg", "trustncg"):
        from .trust_ncg import _trust_ncg

        return _trust_ncg, {}
    if method in ("l-bfgs", "lbfgs", "l-bfgs-b"):
        from .lbfgs import _lbfgs

        return _lbfgs, {}
    if method in ("vl-bfgs", "vlbfgs"):
        from .vlbfgs import _vlbfgs

        return _vlbfgs, {}
    if method in ("nonlinear-cg", "nonlinearcg", "nlcg"):
        from .descent import _nonlinear_cg

        return _nonlinear_cg, {}
    if method in ("steepest-descent", "steepestdescent", "sd"):
        from .descent import _steepest_descent

        return _steepest_descent, {}
    if method.startswith("scipy:"):
        from .scipy_bridge import minimize_scipy

        return minimize_scipy, {"method": method.split(":", 1)[1]}
    raise ValueError(f"unknown method {method!r}")


def _dispatch(fun, x0, method, args, tol, options, kwargs, batched: bool):
    if args:
        fun = partial(fun, *args)
    options = dict(options or {})
    options.update(kwargs)
    solver, extra = _method(method)
    if extra:  # the scipy bridge: `tol` is scipy's own
        options.pop("xtol", None)
        options.update(extra, tol=tol)
    elif tol is not None:
        options.setdefault("xtol", tol)
    if batched:
        solver = solver.batched
    return solver(fun, x0, **options)


def minimize(fun: Optional[Callable], x0, method: str = "newton-cg", *, args=(),
             tol=None, options: Optional[dict] = None, **kwargs) -> OptimizeResults:
    """Dispatch to a minimizer by name: ``"newton-cg"``, ``"trust-ncg"``,
    ``"l-bfgs"``, ``"vl-bfgs"``, ``"nonlinear-cg"``, ``"steepest-descent"``
    (and their aliases) or ``"scipy:<method>"`` (the host-side scipy
    bridge, e.g. ``"scipy:L-BFGS-B"``)."""
    return _dispatch(fun, x0, method, args, tol, options, kwargs, batched=False)


def minimize_batched(fun: Optional[Callable], x0, method: str = "newton-cg", *, args=(),
                     tol=None, options: Optional[dict] = None, **kwargs) -> OptimizeResults:
    """:func:`minimize` of a batch of problems in lockstep (the scipy bridge
    loops over the rows): the named minimizer's batched form."""
    return _dispatch(fun, x0, method, args, tol, options, kwargs, batched=True)


def batched_form(minimize_fn: Callable) -> Callable:
    """The lockstep form of a minimizer passed as ``minimize=``: its
    ``batched`` attribute (``_newton_cg``, ``_trust_ncg``, ``_lbfgs``, ...,
    :func:`minimize`), also through a ``functools.partial``; a minimizer
    without one is taken to be batched already."""
    if isinstance(minimize_fn, partial):
        inner = batched_form(minimize_fn.func)
        return partial(inner, *minimize_fn.args, **minimize_fn.keywords)
    return getattr(minimize_fn, "batched", minimize_fn)


_newton_cg.batched = _newton_cg_batched
minimize.batched = minimize_batched
