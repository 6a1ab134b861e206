"""Parity of the port's geoVI stages and one full ``OptimizeVI.update``
with ``nifty_tpu`` at 32^2, the noise replayed.

The port takes its noise from a provider that derives keys with
``jax.random.split`` and draws with ``nifty_tpu.tree.random_like``, so both
packages see identical white noise at identical places (the key splits of
``optimize_kl.py:587-616``, ``evi.py:92-97`` and ``_mirror_tags``).

Solver budgets are short (CG 5 steps): CG on this ill-conditioned metric
amplifies rounding differences by orders of magnitude per iteration
(measured: 1e-13 after 3 steps, 1e-5 after 8), so long solves of two
correct implementations drift apart.  With the short budgets the stages
agree to 1e-8 and the full update's KL energy and position to 1e-6
relative.
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

# the packages export a function of the module's name
jok = importlib.import_module("nifty_tpu.optimize_kl")
tok = importlib.import_module("nifty_tpu_torch.optimize_kl")

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

NOISE_STD = 0.1
DIMS = (32, 32)
SHORT = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)


def _jax_struct(tree):
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float64)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG: split with
    ``jax.random.split``, draw with ``nifty_tpu.tree.random_like``."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        out = jft.random_like(self.key, _jax_struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


def build(mod):
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        DIMS, distances=1.0 / DIMS[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2),
    )
    return cfm.finalize()


@pytest.fixture(scope="module")
def problem():
    cf_j, cf_t = build(jft), build(jt)
    rng = np.random.default_rng(3)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    truth = np.asarray(cf_j({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    pos = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    return lh_j, lh_t, pos


def _close_tree(got, want, rtol):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.max(np.abs(w)), 1e-300))


@pytest.mark.parametrize("from_inverse", [False, True])
def test_draw_linear_residual_with_replayed_noise(problem, from_inverse):
    lh_j, lh_t, pos = problem
    key = jax.random.PRNGKey(11)
    res_j, info_j = jft.draw_linear_residual(
        lh_j, {k: jnp.asarray(v) for k, v in pos.items()}, key,
        from_inverse=from_inverse, cg_kwargs=dict(maxiter=5))
    res_t, info_t = jt.draw_linear_residual(
        lh_t, jt.from_numpy(pos), JaxKey(key),
        from_inverse=from_inverse, cg_kwargs=dict(maxiter=5))
    assert int(info_t) == int(info_j)
    _close_tree(res_t, res_j, 1e-8 if from_inverse else 1e-12)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_nonlinearly_update_residual_with_replayed_noise(problem, sign):
    lh_j, lh_t, pos = problem
    key = jax.random.PRNGKey(12)
    rng = np.random.default_rng(int(sign > 0))
    res = {k: 0.1 * rng.standard_normal(v.shape) for k, v in pos.items()}
    mk = dict(xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))
    new_j, st_j = jft.nonlinearly_update_residual(
        lh_j, {k: jnp.asarray(v) for k, v in pos.items()},
        {k: jnp.asarray(v) for k, v in res.items()}, key, sign, minimize_kwargs=mk)
    new_t, st_t = jt.nonlinearly_update_residual(
        lh_t, jt.from_numpy(pos), jt.from_numpy(res), JaxKey(key), sign, minimize_kwargs=mk)
    assert (st_t.nit, st_t.status) == (int(st_j.nit), int(st_j.status))
    np.testing.assert_allclose(st_t.fun, float(st_j.fun), rtol=1e-8)
    _close_tree(new_t, new_j, 1e-8)


def test_full_update_with_replayed_noise(problem):
    lh_j, lh_t, pos = problem
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="vmap")
    smp_j = jft.Samples(pos={k: jnp.asarray(v) for k, v in pos.items()}, samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(7), **SHORT))

    opt_t = jt.OptimizeVI(lh_t, 10, residual_map="vmap")
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(7)), **SHORT))

    assert st_t.nit == st_j.nit == 1
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_array_equal(
        np.asarray(st_t.sample_state.nit), np.asarray(st_j.sample_state.nit))
    np.testing.assert_allclose(
        st_t.minimization_state.fun, float(st_j.minimization_state.fun), rtol=1e-6)
    _close_tree(smp_t.pos, smp_j.pos, 1e-6)
    _close_tree(smp_t._samples, smp_j._samples, 1e-6)
    assert len(smp_t) == len(smp_j) == 4


def test_sampling_plan_and_layout_helpers_match_jax():
    for mode in jok._SAMPLING_PLANS:
        for n, stored in ((0, 0), (2, 2), (2, 0)):
            pj, pt = jok.plan_sampling(mode, n, stored), tok.plan_sampling(mode, n, stored)
            assert (pj is None and pt is None) or (
                (pt.draw, pt.curve, pt.fresh_keys) == (pj.draw, pj.curve, pj.fresh_keys))
    with pytest.raises(ValueError):
        tok.plan_sampling("bogus", 2, 2)
    a = np.arange(6.0).reshape(3, 2)
    got = tok.interleave({"x": torch.from_numpy(a)}, {"x": torch.from_numpy(-a)})["x"]
    want = jok.interleave({"x": jnp.asarray(a)}, {"x": jnp.asarray(-a)})["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys, signs = tok._mirror_tags(["k0", "k1"])
    assert keys == ["k0", "k0", "k1", "k1"] and signs == [1.0, -1.0, 1.0, -1.0]


def test_samples_container_and_weights_round_trip():
    pos = {"a": torch.zeros(3), "b": torch.ones(2)}
    res = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, 2)}
    s = jt.Samples(pos=pos, samples=res, keys=[1])
    assert len(s) == 2 and torch.equal(s[1]["a"], torch.tensor([3.0, 4.0, 5.0]))
    moved = s.at({"a": torch.ones(3), "b": torch.zeros(2)})
    assert torch.equal(moved.samples["a"][0], torch.tensor([1.0, 2.0, 3.0]))
    back = jt.to_numpy(jt.from_numpy({"v": jft.Vector({"x": np.ones(2)})}))
    assert isinstance(back["v"], jt.Vector) and np.array_equal(back["v"]["x"], np.ones(2))


def test_optimize_kl_loop_runs_with_generator_keys(problem):
    _, lh_t, pos = problem
    seen = []
    gen = torch.Generator().manual_seed(0)
    samples, state = tok.optimize_kl(
        lh_t, jt.from_numpy(pos), key=gen, n_total_iterations=2,
        callback=lambda s, st: seen.append(st.nit), **SHORT)
    assert seen == [1, 2] and state.nit == 2 and np.isfinite(state.minimization_state.fun)


@pytest.mark.parametrize("det", [False, True], ids=["default", "deterministic"])
def test_stacked_kl_matches_sample_loop(problem, det):
    """kl_map="vmap" stacks the samples on a leading axis; "smap" loops.
    Same energy, gradient and metric up to summation order."""
    _, lh_t, pos = problem
    old = jt.config.get("deterministic_reductions")
    jt.config.update("deterministic_reductions", det)
    try:
        rng = np.random.default_rng(21)
        res = jt.tree.stack([
            jt.from_numpy({k: 0.3 * rng.standard_normal(v.shape) for k, v in pos.items()})
            for _ in range(4)
        ])
        smp = jt.Samples(pos=jt.from_numpy(pos), samples=res, keys=[0, 1])
        tan = jt.from_numpy({k: rng.standard_normal(v.shape) for k, v in pos.items()})
        p = jt.from_numpy(pos)
        (v_s, g_s), (v_l, g_l) = (
            tok._mean_energy_and_grad(lh_t, p, smp, map=m) for m in ("vmap", "smap"))
        np.testing.assert_allclose(float(v_s), float(v_l), rtol=1e-13)
        _close_tree(g_s, {k: v.numpy() for k, v in g_l.items()}, 1e-12)
        want = {k: v.numpy() for k, v in tok._mean_metric_at(lh_t, p, smp, map="smap")(tan).items()}
        _close_tree(tok._mean_metric_at(lh_t, p, smp, map="vmap")(tan), want, 1e-12)
        _close_tree(tok._mean_metric(lh_t, p, tan, smp, map="vmap"), want, 1e-12)
        _close_tree(tok._mean_metric(lh_t, p, tan, smp, map="smap"), want, 1e-12)
    finally:
        jt.config.update("deterministic_reductions", old)
    assert jt.OptimizeVI(lh_t, 1).kl_map == "vmap"  # 32^2 is below the loop size
