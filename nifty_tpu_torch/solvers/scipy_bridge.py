"""SciPy minimizer bridge (counterpart of
:mod:`nifty_tpu.solvers.scipy_bridge`): ``scipy.optimize.minimize`` (L-BFGS-B
by default) over a tree of tensors.

The bridge is host-driven: each evaluation moves the raveled float64
vector to the tree's device and the energy and gradient back.  It is the
one solver without a lockstep form: :func:`minimize_scipy_batched` loops
over the rows on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..likelihood import value_and_grad
from ..tree import ravel, stack, tree_device, tree_leaves, tree_map, unravel
from .descent import _require_no_field_mesh
from .newton_cg import OptimizeResults


def minimize_scipy(fun: Optional[Callable], x0, *, method: str = "L-BFGS-B",
                   fun_and_grad: Optional[Callable] = None, bounds=None,
                   tol: Optional[float] = None, maxiter: Optional[int] = None,
                   options: Optional[dict] = None, **_ignored) -> OptimizeResults:
    """Minimize ``fun`` over a tree with ``scipy.optimize.minimize``.

    ``bounds``: scipy bounds over the raveled vector, or a pair ``(lo, hi)``
    broadcast over every leaf; ``method``: any gradient-based scipy method.
    ``status``, ``nit``, ``nfev`` and ``njev`` are scipy's."""
    import scipy.optimize as sopt

    if fun_and_grad is None:
        if fun is None:
            raise ValueError("need `fun` or `fun_and_grad`")

        def fun_and_grad(x):
            return value_and_grad(fun, x)

    _require_no_field_mesh()
    device = tree_device(x0)
    dtype = tree_leaves(x0)[0].dtype
    flat0 = ravel(x0).detach().cpu().numpy().astype(np.float64)

    def host_vg(z):
        v, g = fun_and_grad(unravel(x0, torch.as_tensor(z, dtype=dtype, device=device)))
        return float(v), ravel(g).detach().cpu().numpy().astype(np.float64)

    if bounds is not None and not isinstance(bounds, sopt.Bounds) and len(bounds) == 2:
        lo, hi = bounds
        bounds = sopt.Bounds(np.full(flat0.shape, lo, dtype=np.float64),
                             np.full(flat0.shape, hi, dtype=np.float64))
    options = dict(options or {})
    if maxiter is not None:
        options.setdefault("maxiter", int(maxiter))
    res = sopt.minimize(host_vg, flat0, jac=True, method=method, bounds=bounds, tol=tol,
                        options=options)

    def to_tree(z):
        return unravel(x0, torch.as_tensor(np.asarray(z), dtype=dtype, device=device))

    return OptimizeResults(
        x=to_tree(res.x), success=bool(res.success), status=int(res.status),
        fun=float(res.fun), jac=to_tree(res.jac) if getattr(res, "jac", None) is not None
        else None,
        nfev=int(getattr(res, "nfev", 0)), njev=int(getattr(res, "njev", 0)),
        nit=int(getattr(res, "nit", 0)))


def minimize_scipy_batched(fun=None, x0=None, *, fun_and_grad=None, **kwargs) -> OptimizeResults:
    """:func:`minimize_scipy` for each row of a batched ``x0`` in turn, with
    a batched ``fun_and_grad`` (``((B,) energies, batched gradients)``)
    evaluated one row at a time; the results stacked, the scalars as (B,)
    tensors."""
    if fun_and_grad is None:
        raise ValueError("the batched scipy bridge needs a batched `fun_and_grad`")
    nrows = tree_leaves(x0)[0].shape[0]
    results = []
    for b in range(nrows):
        def row_vg(x, b=b):
            rows = tree_map(lambda full, xr: torch.cat([full[:b], xr[None], full[b + 1:]]),
                            x0, x)
            value, grad = fun_and_grad(rows)
            return value[b], tree_map(lambda t: t[b], grad)

        results.append(minimize_scipy(None, tree_map(lambda t: t[b], x0), fun_and_grad=row_vg,
                                      **kwargs))
    device = tree_device(x0)

    def scalars(name, dtype=torch.int64):
        return torch.tensor([getattr(r, name) for r in results], dtype=dtype, device=device)

    status = scalars("status")
    return OptimizeResults(
        x=stack([r.x for r in results]), success=scalars("success", torch.bool), status=status,
        fun=scalars("fun", torch.float64), jac=stack([r.jac for r in results]),
        nfev=scalars("nfev"), njev=scalars("njev"), nit=scalars("nit"))


minimize_scipy.batched = minimize_scipy_batched
