"""Parity of the port's CG and Newton-CG with ``nifty_tpu``'s traced
solvers: same iteration counts, status codes and iterates.

Problems are well conditioned so that a different summation order (a few
ulps per reduction) cannot flip a stopping rule or grow into the
iterates; 1e-10 relative then holds.  Both packages' solvers run in the
default mode and in the fixed-trip ``deterministic_reductions`` mode.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.config as jconfig  # noqa: E402
import nifty_tpu_torch.config as tconfig  # noqa: E402
from nifty_tpu.solvers.cg import _static_cg as j_cg  # noqa: E402
from nifty_tpu.solvers.newton_cg import _newton_cg as j_ncg  # noqa: E402
from nifty_tpu_torch.solvers import minimize, static_cg  # noqa: E402
from nifty_tpu_torch.solvers.cg import _static_cg as t_cg  # noqa: E402
from nifty_tpu_torch.solvers.newton_cg import _newton_cg as t_ncg  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10
N = 40


@pytest.fixture(params=[False, True], ids=["default", "deterministic"])
def det_mode(request):
    old_j = jconfig.get("deterministic_reductions")
    old_t = tconfig.get("deterministic_reductions")
    jconfig.update("deterministic_reductions", request.param)
    tconfig.update("deterministic_reductions", request.param)
    yield request.param
    jconfig.update("deterministic_reductions", old_j)
    tconfig.update("deterministic_reductions", old_t)


def _spd(seed, n=N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T / n + np.eye(n), rng.standard_normal(n)


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.max(np.abs(want)))


CG_CASES = {
    "resnorm_default": dict(),
    "absdelta": dict(absdelta=1e-9, miniter=3),
    "maxiter_hit": dict(maxiter=4),
    "x0": dict(x0=True, tol=1e-8),
    "preconditioned": dict(preconditioner=True, tol=1e-9),
}


@pytest.mark.parametrize("case", list(CG_CASES))
def test_static_cg_matches_jax(det_mode, case):
    a, b = _spd(1)
    kw = dict(CG_CASES[case])
    x0 = np.random.default_rng(2).standard_normal(N) if kw.pop("x0", False) else None
    diag = np.diag(a).copy()
    pre = kw.pop("preconditioner", False)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    rj = j_cg(lambda x: aj @ x, bj, None if x0 is None else jnp.asarray(x0),
              preconditioner=(lambda r: r / jnp.asarray(diag)) if pre else None, **kw)
    rt = t_cg(lambda x: at @ x, bt, None if x0 is None else torch.from_numpy(x0),
              preconditioner=(lambda r: r / torch.from_numpy(diag)) if pre else None, **kw)
    assert (rt.nit, rt.info, rt.nfev) == (int(rj.nit), int(rj.info), int(rj.nfev))
    _close(rt.x, rj.x)


def test_static_cg_on_trees_and_nonpositive_curvature():
    a, b = _spd(3, 6)
    tree_b = {"u": torch.from_numpy(b[:2]), "v": torch.from_numpy(b[2:])}

    def mat(t):
        x = torch.cat([t["u"], t["v"]])
        y = torch.from_numpy(a) @ x
        return {"u": y[:2], "v": y[2:]}

    x, info = static_cg(mat, tree_b, tol=1e-12)
    assert info == 0
    _close(torch.cat([x["u"], x["v"]]), np.linalg.solve(a, b))
    # indefinite operator: graceful exit on the first step, as in JAX
    neg = -np.eye(3)
    rj = j_cg(lambda v: jnp.asarray(neg) @ v, jnp.ones(3))
    rt = t_cg(lambda v: torch.from_numpy(neg) @ v, torch.ones(3, dtype=torch.float64))
    assert (rt.nit, rt.info) == (int(rj.nit), int(rj.info))
    _close(rt.x, rj.x)
    with pytest.raises(FloatingPointError):
        t_cg(lambda v: torch.from_numpy(neg) @ v, torch.ones(3, dtype=torch.float64),
             _raise_nonposdef=True)


def _nonlinear_problem(seed):
    """f(x) = sum log cosh(A x - b) + 0.5 |x|^2: smooth, convex, nonquadratic."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N)) / np.sqrt(N)
    b = 2.0 * rng.standard_normal(N)

    def fj(x):
        r = jnp.asarray(a) @ x - jnp.asarray(b)
        return jnp.sum(jnp.log(jnp.cosh(r))) + 0.5 * x @ x

    def ft(x):
        r = torch.from_numpy(a) @ x - torch.from_numpy(b)
        return torch.sum(torch.log(torch.cosh(r))) + 0.5 * x @ x

    def hvp_t(x, t):
        r = torch.from_numpy(a) @ x - torch.from_numpy(b)
        w = 1.0 / torch.cosh(r) ** 2
        return torch.from_numpy(a).T @ (w * (torch.from_numpy(a) @ t)) + t

    return fj, ft, hvp_t, 3.0 * rng.standard_normal(N)


NCG_CASES = {
    "xtol": dict(xtol=1e-8, maxiter=20),
    "absdelta": dict(absdelta=1e-10, maxiter=20, cg_kwargs=dict(maxiter=8)),
    "short": dict(maxiter=3, cg_kwargs=dict(maxiter=5)),
}


@pytest.mark.parametrize("case", list(NCG_CASES))
def test_newton_cg_nonlinear_matches_jax(det_mode, case):
    fj, ft, hvp_t, x0 = _nonlinear_problem(4)
    kw = NCG_CASES[case]
    rj = j_ncg(fj, jnp.asarray(x0), **kw)
    rt = t_ncg(ft, torch.from_numpy(x0), hessp=hvp_t, **kw)
    assert (rt.nit, rt.status, rt.nfev, rt.nhev) == (
        int(rj.nit), int(rj.status), int(rj.nfev), int(rj.nhev)
    )
    _close(rt.x, rj.x)
    np.testing.assert_allclose(rt.fun, float(rj.fun), rtol=1e-12)
    # the autograd Hessian (no `hessp`) takes the same path
    rt2 = t_ncg(ft, torch.from_numpy(x0), **kw)
    assert rt2.nit == rt.nit
    _close(rt2.x, rj.x)


def test_newton_cg_quadratic_and_minimize_dispatch(det_mode):
    a, b = _spd(5)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def fg(x):
        return 0.5 * x @ (at @ x) - bt @ x, at @ x - bt

    x0 = np.zeros(N)
    rt = t_ncg(None, torch.from_numpy(x0), fun_and_grad=fg, hessp=lambda x, t: at @ t,
               hessp_at=lambda x: (lambda t: at @ t), xtol=1e-10, maxiter=10)
    rj = j_ncg(None, jnp.asarray(x0),
               fun_and_grad=jax.value_and_grad(
                   lambda x: 0.5 * x @ (jnp.asarray(a) @ x) - jnp.asarray(b) @ x),
               hessp=lambda x, t: jnp.asarray(a) @ t, xtol=1e-10, maxiter=10)
    assert (rt.nit, rt.status) == (int(rj.nit), int(rj.status))
    _close(rt.x, rj.x)
    rm = minimize(None, torch.from_numpy(x0), method="newton-cg", fun_and_grad=fg,
                  hessp=lambda x, t: at @ t, xtol=1e-10, maxiter=10)
    _close(rm.x, rj.x)
    with pytest.raises(ValueError):
        minimize(None, torch.from_numpy(x0), method="lbfgs", fun_and_grad=fg)
