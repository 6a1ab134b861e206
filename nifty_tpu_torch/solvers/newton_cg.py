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
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import config
from ..likelihood import hessian_vector_product, linearize, value_and_grad
from ..logger import logger
from ..tree import norm as tree_norm
from ..tree import result_type, size, tree_axpy, tree_map, vdot
from .cg import _static_cg

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


def _value(energy) -> float:
    v = float(energy)
    return math.inf if math.isnan(v) else v


def newton_cg(fun=None, x0=None, *args, **kwargs):
    """Minimize via Newton-CG; returns only the solution tree."""
    return _newton_cg(fun, x0, *args, **kwargs).x


def _newton_cg(
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
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    hessp_at: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = _static_cg,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
    linearize_hessp: bool = True,
    ls_margin: Optional[float] = None,
    **_ignored,
) -> OptimizeResults:
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)

    fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)
    cg_kwargs = dict(cg_kwargs or {})
    cg_name = cg_kwargs.pop("name", name + "CG" if name is not None else None)
    gradnorm = (
        partial(tree_norm, ord=norm_ord) if custom_gradnorm is None
        else custom_gradnorm
    )

    energy0, g0 = fun_and_grad(x0)
    energy = _value(energy0)
    if ls_margin is None:
        eps = torch.finfo(result_type(x0)).eps
        ls_margin = (1e6 if eps < 1e-12 else 1e4) * eps
    old_e = math.inf if old_fval is None else float(old_fval)
    if maxiter == 0:
        return OptimizeResults(
            x=x0, success=True, status=0, fun=energy, jac=g0, nit=0, nfev=1,
            njev=1, nhev=0,
        )

    # Fixed-trip mode (see `solvers/cg.py`): `maxiter` trips always run and
    # convergence is only recorded; a line-search failure before recorded
    # convergence freezes the state (`halt`).
    fixed_trips = bool(config.get("deterministic_reductions"))

    pos, g = x0, g0
    status, nit, nfev, nhev, conv, halt = -2, 0, 1, 0, False, 0
    while status < -1:
        i = nit + 1
        halted_before = fixed_trips and halt != 0

        if math.isfinite(old_e) and energy_reduction_factor > 0:
            cg_absdelta = energy_reduction_factor * (old_e - energy)
        else:
            cg_absdelta = absdelta / _EPS_SHARE if absdelta is not None else -math.inf
        mag_g = float(tree_norm(g, ord=cg_kwargs.get("norm_ord", 1)))
        cg_resnorm = min(0.5, math.sqrt(mag_g)) * mag_g
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
            **cg_kwargs,
        )
        nat_g = cg_res.x
        if cg_res.info < 0:
            status = -1  # hard CG failure -> stop

        # energy-monotonic backtracking with a gradient-rescue reset
        accept_tol = ls_margin * abs(energy)
        it, scale, dd = 0, 1.0, nat_g
        new_pos = tree_axpy(-scale, dd, pos)
        new_energy, new_g = fun_and_grad(new_pos)
        new_energy = _value(new_energy)
        while new_energy > energy + accept_tol and it < 9:
            it += 1
            scale = scale / 2.0
            if it == 6:
                gam = float(vdot(g, g).real)
                curv = float(vdot(g, hessp(pos, g)).real)
                dd = tree_map(lambda x: (gam / curv) * x, g)
                scale = 1.0
            new_pos = tree_axpy(-scale, dd, pos)
            new_energy, new_g = fun_and_grad(new_pos)
            new_energy = _value(new_energy)
        ls_failed = new_energy > energy + accept_tol
        if fixed_trips:
            if ls_failed and not conv and halt == 0:
                halt = -1
        elif ls_failed and status == -2:
            status = -1  # keep the previous point and stop
        if ls_failed:
            new_pos, new_g, new_energy = pos, g, energy

        energy_diff = energy - new_energy
        descent_norm = scale * float(gradnorm(dd))
        if name is not None:
            logger.info(
                f"{name}: NCG it {i} energy {new_energy} diff {energy_diff} "
                f"|desc| {descent_norm}"
            )

        min_cond = it < 2 and i > miniter
        new_conv = False
        if absdelta is not None:
            new_conv |= (-accept_tol <= energy_diff < absdelta) and min_cond
        new_conv |= descent_norm <= xtol and i > miniter
        new_conv |= conv
        if fixed_trips:
            if i >= maxiter:
                status = halt if halt != 0 else (0 if new_conv else i)
        else:
            if new_conv and status == -2:
                status = 0
            if i >= maxiter and status == -2:
                status = i

        nit, conv = i, new_conv
        nfev += it + 1
        nhev += cg_res.nfev
        if not halted_before:
            pos, energy, g, old_e = new_pos, new_energy, new_g, energy

    return OptimizeResults(
        x=pos, success=status >= 0, status=status, fun=energy, jac=g,
        nit=nit, nfev=nfev, njev=nfev, nhev=nhev,
    )


def minimize(fun: Optional[Callable], x0, method: str = "newton-cg", *, args=(),
             tol=None, options: Optional[dict] = None, **kwargs) -> OptimizeResults:
    """Dispatch to a minimizer by name; only Newton-CG is ported."""
    if args:
        fun = partial(fun, *args)
    options = dict(options or {})
    options.update(kwargs)
    if tol is not None:
        options.setdefault("xtol", tol)
    if method.lower() in ("newton-cg", "newtoncg", "ncg"):
        return _newton_cg(fun, x0, **options)
    raise ValueError(f"unknown or not yet ported method {method!r}")
