"""Parity of the port's trust-region Newton-CG, L-BFGS, VL-BFGS, nonlinear
CG, steepest descent and scipy bridge with ``nifty_tpu``'s solvers on the
JAX tests' problems (``tests/test_solvers.py``,
``tests/test_num_and_responses.py``).

The test functions' values and gradients are bitwise equal in both
packages, so the solvers' paths agree to rounding: ``x`` within 1e-10 of
the largest entry, ``nit``, ``nfev``, ``nhev`` and ``status`` equal.  One
path is chaotic: nonlinear CG on the 4-D Rosenbrock function first moves
an ulp apart at its third step (XLA fuses ``x + t d`` into one rounding
where PyTorch rounds twice) and the two runs then take 128 and 171 steps
to the same minimum; that case is held to the JAX test's own tolerance.
The lockstep forms are held to row-by-row solves (1e-12, equal counters)
and to ``jax.vmap`` of the JAX solver; ``optimize_kl`` with the KL stage
minimized by trust-region Newton-CG on a 16^2 field agrees with the JAX
package's at 1e-8 (short budgets, as in ``test_torch_optimize_kl.py``).
"""

import importlib
import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.solvers.trust_ncg import _trust_ncg as j_trust_ncg  # noqa: E402
from nifty_tpu_torch.likelihood import hessian_vector_product  # noqa: E402
from nifty_tpu_torch.solvers.descent import _nonlinear_cg, _steepest_descent  # noqa: E402
from nifty_tpu_torch.solvers.lbfgs import _lbfgs, _lbfgs_batched  # noqa: E402
from nifty_tpu_torch.solvers.newton_cg import _newton_cg, _newton_cg_batched  # noqa: E402
from nifty_tpu_torch.solvers.scipy_bridge import minimize_scipy  # noqa: E402
from nifty_tpu_torch.solvers.trust_ncg import (  # noqa: E402
    _trust_ncg,
    _trust_ncg_batched,
    cg_steihaug_subproblem,
)
from nifty_tpu_torch.solvers.vlbfgs import _vlbfgs  # noqa: E402
from nifty_tpu_torch.solvers.newton_cg import batched_form, minimize_batched  # noqa: E402
from test_torch_optimize_kl import JaxKey  # noqa: E402

torch.set_num_threads(1)
# the module: the package exports a function of the same name
jsolvers = importlib.import_module("nifty_tpu.solvers")
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def rosen_t(x):
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1 - x[..., :-1]) ** 2,
                     dim=-1)


_rng = np.random.default_rng(11)
_a = _rng.standard_normal((8, 8))
A, B = _a @ _a.T + 8 * np.eye(8), _rng.standard_normal(8)
XSTAR = np.linalg.solve(A, B)


def quad_j(x):
    return 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(B) @ x


def quad_t(x):
    return 0.5 * ((x @ torch.from_numpy(A)) * x).sum(-1) - x @ torch.from_numpy(B)


def quartic_j(x):
    return jnp.sum((x - jnp.arange(3, dtype=x.dtype)) ** 4 + x ** 2)


def quartic_t(x):
    return torch.sum((x - torch.arange(3, dtype=x.dtype)) ** 4 + x ** 2, dim=-1)


PROBLEMS = {"rosen": (rosen_j, rosen_t), "quad": (quad_j, quad_t),
            "quartic": (quartic_j, quartic_t)}
# (method, problem, start, options): the JAX tests' calls
CASES = {
    "trust_ncg_rosen_0": ("trust-ncg", "rosen", np.zeros(6), dict(maxiter=500, gtol=1e-8)),
    "trust_ncg_rosen_2": ("trust-ncg", "rosen", 2 * np.ones(6), dict(maxiter=500, gtol=1e-8)),
    "trust_ncg_rosen_m03": ("trust-ncg", "rosen", -0.3 * np.ones(6),
                            dict(maxiter=500, gtol=1e-8)),
    "lbfgs_rosen": ("l-bfgs", "rosen", np.zeros(6), dict(maxiter=500, gtol=1e-9)),
    "lbfgs_rosen_m6": ("l-bfgs", "rosen", np.full(6, -0.3), dict(maxiter=60, gtol=0.0, m=6)),
    "vlbfgs_rosen_m6": ("vl-bfgs", "rosen", np.full(6, -0.3), dict(maxiter=60, gtol=0.0, m=6)),
    "nlcg_quad": ("nonlinear-cg", "quad", np.zeros(8), dict(maxiter=500, gtol=1e-7)),
    "sd_quad": ("steepest-descent", "quad", np.zeros(8), dict(maxiter=500, gtol=1e-7)),
    "vlbfgs_quad": ("vl-bfgs", "quad", np.zeros(8), dict(maxiter=500, gtol=1e-7)),
    "vlbfgs_rosen": ("vl-bfgs", "rosen", np.full(4, -0.5), dict(maxiter=5000, gtol=1e-6)),
    "nlcg_hs_quartic": ("nonlinear-cg", "quartic", np.ones(3),
                        dict(maxiter=200, gtol=1e-6, beta_heuristics="hestenes-stiefel")),
    "nlcg_quartic_absdelta": ("nonlinear-cg", "quartic", -np.ones(3),
                              dict(maxiter=200, gtol=1e-12, absdelta=1e-9)),
    "sd_quad_maxiter": ("steepest-descent", "quad", np.zeros(8), dict(maxiter=7, gtol=1e-7)),
    "trust_ncg_quad_absdelta": ("trust-ncg", "quad", np.zeros(8),
                                dict(maxiter=50, gtol=1e-12, absdelta=1e-10)),
}


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.max(np.abs(want)))


def _counters(res):
    return tuple(None if v is None else int(v) for v in
                 (res.status, res.nit, res.nfev, res.nhev))


@pytest.mark.parametrize("case", list(CASES))
def test_minimizer_matches_jax(case):
    method, prob, x0, opt = CASES[case]
    fj, ft = PROBLEMS[prob]
    rj = jft.minimize(fj, jnp.asarray(x0), method=method, options=opt)
    rt = jt.minimize(ft, torch.from_numpy(x0), method=method, options=opt)
    assert _counters(rt) == _counters(rj)
    _close(rt.x, rj.x)
    np.testing.assert_allclose(rt.fun, float(rj.fun), rtol=RTOL, atol=1e-15)


def test_nonlinear_cg_rosenbrock_reaches_the_minimum_as_jax_does():
    opt = dict(maxiter=5000, gtol=1e-6)
    rj = jft.minimize(rosen_j, jnp.full(4, -0.5), method="nonlinear-cg", options=opt)
    rt = jt.minimize(rosen_t, torch.full((4,), -0.5, dtype=torch.float64),
                     method="nonlinear-cg", options=opt)
    assert int(rj.status) == rt.status == 0
    np.testing.assert_allclose(np.asarray(rj.x), np.ones(4), rtol=1e-4)
    np.testing.assert_allclose(rt.x.numpy(), np.ones(4), rtol=1e-4)


@pytest.mark.parametrize("solver", ["trust_ncg", "lbfgs", "vlbfgs", "nonlinear_cg",
                                    "steepest_descent"])
def test_tree_domain_matches_jax(solver):
    def f_j(p):
        return rosen_j(p["x"]) + jnp.sum((p["y"] - 3.0) ** 2)

    def f_t(p):
        return rosen_t(p["x"]) + torch.sum((p["y"] - 3.0) ** 2)

    opt = dict(maxiter=40, gtol=1e-9)
    x0 = {"x": np.zeros(4), "y": np.zeros(3)}
    rj = getattr(jsolvers, f"_{solver}")(f_j, {k: jnp.asarray(v) for k, v in x0.items()},
                                         **opt)
    single = {"trust_ncg": _trust_ncg, "lbfgs": _lbfgs, "vlbfgs": _vlbfgs,
              "nonlinear_cg": _nonlinear_cg, "steepest_descent": _steepest_descent}[solver]
    rt = single(f_t, jt.from_numpy(x0), **opt)
    assert _counters(rt) == _counters(rj)
    for k in x0:
        _close(rt.x[k], rj.x[k])


def _batched_problem(ft):
    """A batch of independent problems: each row's energy and gradient, and
    the rows' Hessian products."""
    def fun_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = ft(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    def hessp(x, t):
        return hessian_vector_product(lambda y: ft(y).sum(), x, t)

    return dict(fun_and_grad=fun_and_grad, hessp=hessp)


LOCKSTEP = {
    "trust_ncg": ("trust-ncg", "rosen", [np.zeros(6), 2.0 * np.ones(6), -0.3 * np.ones(6)],
                  dict(maxiter=500, gtol=1e-8)),
    "lbfgs": ("l-bfgs", "rosen", [np.zeros(6), 2.0 * np.ones(6)], dict(maxiter=500, gtol=1e-9)),
    "vlbfgs": ("vl-bfgs", "rosen", [np.full(6, -0.3), np.zeros(6)],
               dict(maxiter=60, gtol=1e-7, m=6)),
    "nonlinear_cg": ("nonlinear-cg", "quartic", [np.zeros(3), np.ones(3), -np.ones(3)],
                     dict(maxiter=200, gtol=1e-6)),
    "steepest_descent": ("steepest-descent", "quad", [np.zeros(8), np.ones(8)],
                         dict(maxiter=12, gtol=1e-7)),
    "scipy": ("scipy:L-BFGS-B", "quad", [np.zeros(8), np.ones(8)], dict(maxiter=100)),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_rows_equal_row_by_row_solves_and_jax_vmap(case):
    method, prob, starts, opt = LOCKSTEP[case]
    fj, ft = PROBLEMS[prob]
    xs = torch.from_numpy(np.stack(starts))
    res_b = minimize_batched(None, xs, method=method, **_batched_problem(ft), **opt)
    for b, x0 in enumerate(starts):
        res = jt.minimize(ft, torch.from_numpy(x0), method=method, options=opt)
        assert (int(res_b.status[b]), int(res_b.nit[b]), int(res_b.nfev[b])) == \
            (res.status, res.nit, res.nfev), b
        np.testing.assert_allclose(res_b.x[b].numpy(), res.x.numpy(), rtol=0,
                                   atol=1e-12 * np.max(np.abs(res.x.numpy())))
    if method.startswith("scipy:"):
        return
    out = jax.vmap(lambda x: jft.minimize(fj, x, method=method, options=opt))(
        jnp.asarray(np.stack(starts)))
    np.testing.assert_array_equal(res_b.status.numpy(), np.asarray(out.status))
    np.testing.assert_array_equal(res_b.nit.numpy(), np.asarray(out.nit))
    _close(res_b.x, out.x)


NAMES = ["newton-cg", "newtoncg", "ncg", "trust-ncg", "trustncg", "l-bfgs", "lbfgs",
         "l-bfgs-b", "vl-bfgs", "vlbfgs", "nonlinear-cg", "nonlinearcg", "nlcg",
         "steepest-descent", "steepestdescent", "sd", "scipy:L-BFGS-B", "scipy:BFGS"]


@pytest.mark.parametrize("name", NAMES)
def test_every_minimize_name_dispatches_as_jax(name):
    if name.startswith("scipy"):
        opt, kw = dict(maxiter=300), dict(tol=1e-10)
    elif name in ("newton-cg", "newtoncg", "ncg"):
        opt, kw = dict(maxiter=300, absdelta=1e-14), {}
    else:
        opt, kw = dict(maxiter=300, gtol=1e-7), {}
    rj = jft.minimize(quad_j, jnp.zeros(8), method=name, options=opt, **kw)
    rt = jt.minimize(quad_t, torch.zeros(8, dtype=torch.float64), method=name, options=opt,
                     **kw)
    assert (int(rt.status), int(rt.nit)) == (int(rj.status), int(rj.nit))
    _close(rt.x, rj.x)
    np.testing.assert_allclose(rt.x.numpy(), XSTAR, rtol=0, atol=1e-4)


def test_minimize_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown method"):
        jt.minimize(quad_t, torch.zeros(8, dtype=torch.float64), method="simplex")


def test_batched_form_of_single_forms_and_partials():
    from functools import partial

    assert batched_form(_trust_ncg) is _trust_ncg_batched
    assert batched_form(_lbfgs) is _lbfgs_batched
    assert batched_form(_newton_cg) is _newton_cg_batched
    p = batched_form(partial(jt.minimize, method="trust-ncg"))
    assert p.func is minimize_batched and p.keywords == {"method": "trust-ncg"}
    assert batched_form(_newton_cg_batched) is _newton_cg_batched


def test_cg_steihaug_subproblem_matches_jax():
    from nifty_tpu.solvers.trust_ncg import cg_steihaug_subproblem as j_sub

    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((10, 10)))
    g = rng.standard_normal(10)
    for eig, radius in (((0.5, 4.0), 10.0), ((0.5, 4.0), 0.1), ((-1.0, 3.0), 5.0)):
        h = (q * np.linspace(*eig, 10)) @ q.T
        rj = j_sub(2.0, jnp.asarray(g), lambda t: jnp.asarray(h) @ t, trust_radius=radius)
        rt = cg_steihaug_subproblem(
            2.0, torch.from_numpy(g), lambda t: torch.from_numpy(h) @ t, trust_radius=radius)
        assert (rt.nit, rt.nhev, rt.hits_boundary) == (int(rj.nit), int(rj.nhev),
                                                      bool(rj.hits_boundary))
        _close(rt.step, rj.step)
        np.testing.assert_allclose(rt.pred_f, float(rj.pred_f), rtol=RTOL)


def test_scipy_bridge_over_a_tree_with_bounds_matches_jax():
    from nifty_tpu.solvers import minimize_scipy as j_scipy

    def quad_tree_j(x):
        return jnp.sum((x["a"] - 1.5) ** 2) + jnp.sum(3.0 * (x["b"] + 0.5) ** 2)

    def quad_tree_t(x):
        return torch.sum((x["a"] - 1.5) ** 2) + torch.sum(3.0 * (x["b"] + 0.5) ** 2)

    x0 = {"a": np.zeros(4), "b": np.zeros((3, 2))}
    for bounds in (None, (-0.4, 0.4)):
        rj = j_scipy(quad_tree_j, {k: jnp.asarray(v) for k, v in x0.items()}, bounds=bounds)
        rt = minimize_scipy(quad_tree_t, jt.from_numpy(x0), bounds=bounds)
        assert (rt.status, rt.nit, rt.nfev) == (int(rj.status), int(rj.nit), int(rj.nfev))
        for k in x0:
            _close(rt.x[k], rj.x[k])
    assert float(rt.x["a"].max()) <= 0.4


# -- optimize_kl with the KL stage minimized by trust-region Newton-CG --------


def _field(mod):
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((16, 16), distances=1.0 / 16, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
                         asperity=(5e-1, 5e-2))
    return cfm.finalize()


@pytest.fixture(scope="module")
def field16():
    cf_j, cf_t = _field(jft), _field(jt)
    rng = np.random.default_rng(8)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    truth = np.asarray(cf_j({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + 0.1 * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / 0.01).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / 0.01).amend(cf_t)
    pos = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    return lh_j, lh_t, pos


SHORT16 = dict(n_samples=1, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
               sample_mode="nonlinear_resample")
TRUST_SHORT = dict(maxiter=3, subproblem_kwargs=dict(maxiter=5))


def _close_pos(got, want, rtol):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=rtol * np.max(np.abs(w)))


def test_optimize_kl_with_trust_ncg_matches_jax(field16):
    """One ``optimize_kl`` iteration with trust-region Newton-CG for the
    nonlinear sample update and for the KL, the residual stages in lockstep
    (``residual_map="vmap"``: the port runs the solver's lockstep form, the
    JAX package ``vmap``s it).  One iteration: a second one amplifies
    rounding chaotically (the JAX package's own KL energy moves 1.5e-6
    relative when the start moves 1e-11)."""
    lh_j, lh_t, pos = field16
    kw = dict(n_total_iterations=1, residual_map="vmap", kl_map="smap", **SHORT16)

    def stages(minimize):
        return dict(nonlinearly_update_kwargs=dict(minimize=minimize, minimize_kwargs=TRUST_SHORT),
                    kl_kwargs=dict(minimize=minimize, minimize_kwargs=TRUST_SHORT))

    smp_j, st_j = jft.optimize_kl(
        lh_j, {k: jnp.asarray(v) for k, v in pos.items()}, key=jax.random.PRNGKey(5),
        **stages(j_trust_ncg), **kw)
    smp_t, st_t = jt.optimize_kl(
        lh_t, jt.from_numpy(pos), key=JaxKey(jax.random.PRNGKey(5)), **stages(_trust_ncg), **kw)
    for name in ("nit", "status"):
        np.testing.assert_array_equal(np.asarray(getattr(st_t.sample_state, name)),
                                      np.asarray(getattr(st_j.sample_state, name)))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_allclose(st_t.minimization_state.fun, float(st_j.minimization_state.fun),
                               rtol=1e-8)
    _close_pos(smp_t.pos, smp_j.pos, 1e-8)
    _close_pos(smp_t._samples, smp_j._samples, 1e-8)
