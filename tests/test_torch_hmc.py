"""The port's HMC and NUTS (``hmc.py``, ``hmc_oo.py``) against ``nifty_tpu``.

The building blocks are held to the JAX package's at 1e-12 on the same
inputs: leapfrog steps on a tree position, the energies, the U-turn
criterion, the checkpoint ranges and the merge of two trees given the same
uniform.  Whole chains cannot be compared draw for draw (the random streams
differ), so they are held by what they sample: Gaussian moments within
Monte-Carlo error (as ``tests/test_hmc.py`` holds the JAX package's),
bitwise repeats for a fixed generator seed, and
``demos/13_hmc_multimodality.py``'s mixture, where a large inverse mass
matrix mixes both modes and a small one stays in one.
"""

from functools import partial

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.hmc as jhmc  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.hmc as thmc  # noqa: E402
import nifty_tpu_torch.hmc_oo as thmc_oo  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _pe(xp):
    """A non-Gaussian potential on a dict position: quartic and coupled."""
    def pe(x):
        a, b = x["a"], x["b"]
        return (0.5 * xp.sum(a ** 2 / xp.asarray([1.0, 4.0, 0.25]))
                + 0.1 * xp.sum(a ** 4) + 0.5 * xp.sum((b - a[:2]) ** 2))

    return pe


def _tree(seed, xp=np):
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal(3), "b": rng.standard_normal(2)}
    if xp is jnp:
        return {k: jnp.asarray(v) for k, v in t.items()}
    return {k: torch.from_numpy(v) for k, v in t.items()} if xp is torch else t


def _close_tree(got, want, rtol=RTOL):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(1.0, np.max(np.abs(w))))


def _torch_grad(pe):
    def grad(q):
        leaves = {k: v.detach().requires_grad_(True) for k, v in q.items()}
        g = torch.autograd.grad(pe(leaves), [leaves[k] for k in sorted(leaves)])
        return dict(zip(sorted(leaves), g))

    return grad


def test_leapfrog_steps_and_energies_match():
    inv_j = {"a": jnp.asarray([1.0, 2.0, 0.5]), "b": jnp.asarray([0.7, 1.3])}
    inv_t = {k: torch.from_numpy(np.array(v)) for k, v in inv_j.items()}
    qp_j = jhmc.QP(position=_tree(0, jnp), momentum=_tree(1, jnp))
    qp_t = thmc.QP(position=_tree(0, torch), momentum=_tree(1, torch))
    pe_j, pe_t = _pe(jnp), _pe(torch)
    ke_j = partial(jhmc._kinetic_energy, inv_j)
    ke_t = partial(thmc._kinetic_energy, inv_t)
    for i in range(12):
        eps = 0.1 if i % 3 else -0.07
        qp_j = jhmc.leapfrog_step(jax.grad(pe_j), jhmc._kinetic_energy_gradient, eps, inv_j,
                                  qp_j)
        qp_t = thmc.leapfrog_step(_torch_grad(pe_t), thmc._kinetic_energy_gradient, eps, inv_t,
                                  qp_t)
        _close_tree(qp_t.position, qp_j.position)
        _close_tree(qp_t.momentum, qp_j.momentum)
        np.testing.assert_allclose(float(ke_t(qp_t.momentum)), float(ke_j(qp_j.momentum)),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(thmc.total_energy_of_qp(qp_t, pe_t, ke_t)),
                                   float(jhmc.total_energy_of_qp(qp_j, pe_j, ke_j)), rtol=RTOL)
    flipped = thmc.flip_momentum(qp_t)
    _close_tree(flipped.momentum, {k: -v for k, v in qp_j.momentum.items()})


def test_is_euclidean_uturn_matches():
    rng = np.random.default_rng(2)
    seen = set()
    for _ in range(60):
        pos_l, pos_r, mom_l, mom_r = (rng.standard_normal(4) for _ in range(4))
        j = bool(jhmc.is_euclidean_uturn(jhmc.QP(jnp.asarray(pos_l), jnp.asarray(mom_l)),
                                         jhmc.QP(jnp.asarray(pos_r), jnp.asarray(mom_r))))
        t = bool(thmc.is_euclidean_uturn(thmc.QP(torch.from_numpy(pos_l), torch.from_numpy(mom_l)),
                                         thmc.QP(torch.from_numpy(pos_r),
                                                 torch.from_numpy(mom_r))))
        assert t == j
        seen.add(j)
    assert seen == {True, False}


def test_ckpt_idx_range_matches():
    for n in range(130):
        want = tuple(int(v) for v in jhmc._ckpt_idx_range(jnp.asarray(n)))
        assert thmc._ckpt_idx_range(n) == want


def _trees(mod, xp, seed, lw_cur, lw_new, turning_new, diverging_new):
    """A current tree and a new subtree of the same numbers in either package."""
    def qp(s):
        return mod.QP(position=_tree(s, xp), momentum=_tree(s + 1, xp))

    cur = mod.Tree(left=qp(seed), right=qp(seed + 2), logweight=xp.asarray(lw_cur)
                   if xp is jnp else lw_cur, proposal_candidate=qp(seed + 4),
                   turning=False, diverging=False, depth=3, cumulative_acceptance=2.5)
    new = mod.Tree(left=qp(seed + 6), right=qp(seed + 8), logweight=xp.asarray(lw_new)
                   if xp is jnp else lw_new, proposal_candidate=qp(seed + 10),
                   turning=turning_new, diverging=diverging_new, depth=3,
                   cumulative_acceptance=1.25)
    return cur, new


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("go_right", [True, False])
@pytest.mark.parametrize("lw_new,bad", [(-0.3, None), (0.8, None), (-3.0, None),
                                        (0.5, "turning"), (0.5, "diverging")])
def test_merge_trees_given_the_same_uniform(bias, go_right, lw_new, bad):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(key))
        args = (-0.1, lw_new, bad == "turning", bad == "diverging")
        cj, nj = _trees(jhmc, jnp, 10 * seed, *args)
        ct, nt = _trees(thmc, torch, 10 * seed, *args)
        mj = jhmc._merge_trees(key, cj, nj, jnp.asarray(go_right), bias)
        mt = thmc._merge_trees(u, ct, nt, go_right, bias)
        for field in ("left", "right", "proposal_candidate"):
            for part in ("position", "momentum"):
                _close_tree(getattr(getattr(mt, field), part), getattr(getattr(mj, field), part),
                            0.0)
        np.testing.assert_allclose(mt.logweight, float(mj.logweight), rtol=RTOL)
        assert (mt.turning, mt.diverging, mt.depth) == (bool(mj.turning), bool(mj.diverging),
                                                        int(mj.depth))
        np.testing.assert_allclose(mt.cumulative_acceptance, float(mj.cumulative_acceptance),
                                   rtol=RTOL)


def test_uniform_from_a_generator_or_a_number():
    gen = torch.Generator().manual_seed(3)
    u = thmc._uniform(gen)
    assert 0.0 <= u < 1.0 and u == float(torch.rand((), generator=torch.Generator()
                                                    .manual_seed(3), dtype=torch.float64))
    assert thmc._uniform(0.25) == 0.25


def _gauss_potential(cov):
    return lambda x: 0.5 * torch.sum(x ** 2 / cov)


@pytest.mark.parametrize("sampler,kwargs,inv_mass", [
    # HMC with the covariance as inverse mass: trajectory ~pi/2 in whitened units
    (thmc_oo.HMCChain, dict(num_steps=5, step_size=0.3), "cov"),
    # NUTS adapts its trajectory length; unit mass suffices.
    (thmc_oo.NUTSChain, dict(step_size=0.3, max_tree_depth=8), 1.0),
], ids=["hmc", "nuts"])
def test_chain_recovers_gaussian_moments(sampler, kwargs, inv_mass):
    cov = torch.tensor([1.0, 4.0, 0.25, 2.0], dtype=torch.float64)
    chain_o = sampler(potential_energy=_gauss_potential(cov),
                      inverse_mass_matrix=cov if inv_mass == "cov" else inv_mass,
                      position_proto=torch.zeros(4, dtype=torch.float64), **kwargs)
    chain, _ = chain_o.generate_n_samples(0, torch.ones(4, dtype=torch.float64), 2000)
    smpls = chain.samples.numpy()[300:]
    np.testing.assert_allclose(smpls.mean(0), np.zeros(4), atol=0.25)
    np.testing.assert_allclose(smpls.var(0), cov.numpy(), rtol=0.25)
    assert not chain.divergences.any()
    acc = chain.acceptance.double().numpy()
    assert np.all(acc >= 0.0) and np.all(acc <= 1.0) and acc.mean() > 0.5


def test_chain_on_a_tree_position_repeats_for_a_seed():
    pe = lambda p: 0.5 * (torch.sum(p["a"] ** 2) + torch.sum(p["b"] ** 2 / 4.0))
    proto = {"a": torch.zeros(3, dtype=torch.float64), "b": torch.zeros(2, dtype=torch.float64)}
    chain_o = jt.NUTSChain(potential_energy=pe, inverse_mass_matrix=1.0, position_proto=proto,
                           step_size=0.4, max_tree_depth=6)
    c1, (gen, last) = chain_o.generate_n_samples(5, proto, 400)
    c2, _ = chain_o.generate_n_samples(torch.Generator().manual_seed(5), proto, 400)
    c3, _ = chain_o.generate_n_samples(6, proto, 20)
    assert c1.samples["a"].shape == (400, 3) and isinstance(gen, torch.Generator)
    torch.testing.assert_close(last["b"], c1.samples["b"][-1], rtol=0, atol=0)
    for k in ("a", "b"):
        assert torch.equal(c1.samples[k], c2.samples[k])
        assert not torch.equal(c1.samples[k][:20], c3.samples[k])
    assert torch.equal(c1.depths, c2.depths) and torch.equal(c1.acceptance, c2.acceptance)
    np.testing.assert_allclose(c1.samples["b"].numpy()[100:].var(0), [4.0, 4.0], rtol=0.35)


def test_mass_matrix_must_match_the_position():
    proto = {"a": torch.zeros(3, dtype=torch.float64)}
    pe = lambda p: torch.sum(p["a"] ** 2)
    with pytest.raises(TypeError):
        jt.HMCChain(pe, {"b": torch.ones(3, dtype=torch.float64)}, proto)
    with pytest.raises(ValueError):
        jt.HMCChain(pe, {"a": torch.ones(2, dtype=torch.float64)}, proto)
    chain = jt.HMCChain(pe, {"a": torch.full((3,), 2.0, dtype=torch.float64)}, proto)
    torch.testing.assert_close(chain.mass_matrix_sqrt["a"],
                               torch.full((3,), 2.0 ** -0.5, dtype=torch.float64))


def _mixture(x):
    """``demos/13_hmc_multimodality.py``'s target: two unit Gaussians 10 apart."""
    return -torch.logaddexp(-0.5 * x ** 2, -0.5 * (x - 10.0) ** 2)


@pytest.mark.parametrize("inv_mass,mixes", [(5.0, False), (50.0, True)],
                         ids=["sticky", "mixing"])
def test_demo13_mass_matrix_controls_mode_mixing(inv_mass, mixes):
    sampler = jt.NUTSChain(potential_energy=_mixture, inverse_mass_matrix=inv_mass,
                           position_proto=torch.tensor(0.0, dtype=torch.float64),
                           step_size=0.3, max_tree_depth=15, max_energy_difference=1000.0)
    chain, _ = sampler.generate_n_samples(43, torch.tensor(3.0, dtype=torch.float64), 1000)
    frac_right = float((chain.samples > 5.0).double().mean())
    if mixes:
        assert 0.25 < frac_right < 0.75
    else:
        assert frac_right < 0.02 or frac_right > 0.98
