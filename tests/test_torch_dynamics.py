"""The port's dynamics priors (``models/dynamics.py``) against
``nifty_tpu.models.dynamics`` on the same latents, float64 on the CPU.

Forward, jvp and vjp of ``dynamic_operator`` (32 x 16, ``harmonic_padding=8``,
causal and minimum-phase) and of ``dynamic_lightcone_operator``, the
gradient for the cone's key included, agree to 1e-10 relative (norm of the
difference over the reference's); the causal kernel vanishes for t < 0
(the reference's check, ``tests/test_optimize_kl.py``), and the cone's
gradient stays finite on the cone's boundary.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.models.dynamics as jd  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.models.dynamics as td  # noqa: E402
from nifty_tpu.ops.harmonic import hartley as jhartley  # noqa: E402
from nifty_tpu_torch import tree as tt  # noqa: E402
from nifty_tpu_torch.ops.harmonic import hartley as thartley  # noqa: E402

torch.set_num_threads(1)

SHAPE, DIST = (32, 16), (0.1, 0.2)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


CASES = {
    "causal": dict(causal=True),
    "minimum_phase": dict(minimum_phase=True),
    "acausal": dict(causal=False),
    "cone": dict(cone=True, lightcone_key="c", sigc=1.0, quant=2.0),
}


def _models(case):
    kw = dict(shape=SHAPE, distances=DIST, sm_s0=1.0, sm_x0=0.5, key="dyn",
              harmonic_padding=8, **CASES[case])
    return jd.dynamic_operator(**kw), td.dynamic_operator(**kw)


def _latents(model, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in model.domain.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_jvp_vjp(case):
    (mj, aux_j), (mt, aux_t) = _models(case)
    assert {k: v.shape for k, v in mt.domain.items()} == {k: v.shape for k, v in mj.domain.items()}
    x, t = _latents(mj, 1), _latents(mj, 2)
    ct = np.random.default_rng(3).standard_normal(SHAPE)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    y_j, jvp_j = jax.jvp(mj, (jx,), ({k: jnp.asarray(v) for k, v in t.items()},))
    _, vjp_fn = jax.vjp(mj, jx)
    (vjp_j,) = vjp_fn(jnp.asarray(ct))

    keys = sorted(x)
    y_t, jvp_t = torch.func.jvp(
        lambda *ls: mt(dict(zip(keys, ls))),
        tuple(torch.from_numpy(x[k]) for k in keys), tuple(torch.from_numpy(t[k]) for k in keys))
    xs = [torch.from_numpy(x[k]).requires_grad_(True) for k in keys]
    vjp_t = torch.autograd.grad(mt(dict(zip(keys, xs))), xs, torch.from_numpy(ct))
    assert y_t.shape == SHAPE and bool(torch.isfinite(y_t).all())
    assert _rel(y_t, y_j) < 1e-10
    assert _rel(jvp_t, jvp_j) < 1e-10
    for k, g in zip(keys, vjp_t):
        assert _rel(g, vjp_j[k]) < 1e-10, k
    sm_j = aux_j["smoothed_dynamics"]({"dyn": jx["dyn"]})
    sm_t = aux_t["smoothed_dynamics"]({"dyn": torch.from_numpy(x["dyn"])})
    assert _rel(sm_t, sm_j) < 1e-10


def test_lightcone_operator_gradient_for_the_cone_key():
    """``dynamic_lightcone_operator``: the gradient of sum(G^2) for both
    keys, finite, against the reference's."""
    kw = dict(shape=SHAPE, distances=DIST, sm_s0=1.0, sm_x0=0.5, key="d", lightcone_key="c",
              sigc=1.0, quant=2.0)
    mj, aux_j = jd.dynamic_lightcone_operator(**kw)
    mt, aux_t = td.dynamic_lightcone_operator(**kw)
    assert "lightspeed" in aux_t
    x = _latents(mj, 4)
    g_j = jax.grad(lambda q: jnp.sum(mj(q) ** 2))({k: jnp.asarray(v) for k, v in x.items()})
    xt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()}
    keys = sorted(xt)
    g_t = dict(zip(keys, torch.autograd.grad((mt(xt) ** 2).sum(), [xt[k] for k in keys])))
    for k in x:
        assert bool(torch.isfinite(g_t[k]).all())
        assert _rel(g_t[k], g_j[k]) < 1e-10, k
    ls_j = aux_j["lightspeed"]({k: jnp.asarray(v) for k, v in x.items()})
    ls_t = aux_t["lightspeed"](jt.from_numpy(x))
    assert _rel(ls_t, ls_j) < 1e-12


def test_causality():
    """The reference's check: the time-domain kernel vanishes for t < 0."""
    _, (mt, _) = _models("causal")
    G = mt(mt.init(jt.HostKey(0)))
    assert G.shape == SHAPE and bool(torch.isfinite(G).all())
    g = (thartley(G) / G.numel()).numpy()
    assert np.abs(g[17:]).max() < 1e-12 * np.abs(g).max() + 1e-14


def test_light_cone_kernel_on_the_boundary():
    """Where the cone passes through grid points, the double ``where``
    keeps the gradient finite (and equal to the reference's)."""
    shape, dist = (8, 8), (1.0, 1.0)
    c = 1.0  # Δ = 0 on the diagonals t = ±x
    g_j = jax.grad(lambda c: jnp.sum(jd.light_cone_kernel(c, shape, dist, 1.0)))(jnp.asarray([c]))
    ct = torch.tensor([c], dtype=torch.float64, requires_grad=True)
    k_t = td.light_cone_kernel(ct, shape, dist, 1.0)
    (g_t,) = torch.autograd.grad(k_t.sum(), ct)
    assert bool(torch.isfinite(g_t).all())
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)
    np.testing.assert_allclose(k_t.detach().numpy(),
                               np.asarray(jd.light_cone_kernel(jnp.asarray([c]), shape, dist, 1.0)),
                               rtol=1e-14)


def test_batched_latents():
    """Leading batch axes carry through: each row is the unbatched model."""
    _, (mt, _) = _models("minimum_phase")
    xs = [jt.from_numpy(_latents(mt, s)) for s in (5, 6)]
    rows = mt(tt.stack(xs))
    for i, x in enumerate(xs):
        torch.testing.assert_close(rows[i], mt(x), rtol=1e-13, atol=1e-13)


def test_argument_checks():
    with pytest.raises(ValueError, match="spatial axis"):
        td.dynamic_operator(shape=(8,), distances=1.0, sm_s0=1.0, sm_x0=1.0, key="k",
                            cone=True, sigc=1.0, quant=1.0)
    with pytest.raises(ValueError, match="sigc"):
        td.dynamic_operator(shape=(8, 4), distances=1.0, sm_s0=1.0, sm_x0=1.0, key="k", cone=True)


def test_hartley_matches_reference():
    x = np.random.default_rng(0).standard_normal(SHAPE)
    assert _rel(thartley(torch.from_numpy(x)), jhartley(jnp.asarray(x))) < 1e-14
