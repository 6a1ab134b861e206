"""Parity of the port's ``density_estimator`` and ``calculate_position``
(``nifty_tpu_torch.sugar``), the tree helpers and ``wrap_left`` with
``nifty_tpu``'s on the same numpy inputs in float64.  The density model
agrees to 1e-10 of its largest entry (a Matern field: transforms, an FFT,
an exponential), with and without a leading batch axis; the preimage that
``calculate_position`` finds (Newton-CG from the same start) to 1e-6.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import tree as jtree  # noqa: E402
from nifty_tpu.sugar import density_estimator  # noqa: E402
from nifty_tpu_torch import tree as ttree  # noqa: E402
from test_torch_driver import JaxKey  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _close(got, want, rtol):
    for g, w in zip(ttree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.max(np.abs(w)), 1e-300))


def _latents(domain, seed, batch=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(batch + tuple(v.shape)) for k, v in domain.items()}


@pytest.mark.parametrize("shape,distances,pad", [(128, 1.0 / 128, 1.0), ((12, 10), 0.1, 0.5)],
                         ids=["demo_1d", "2d"])
def test_density_estimator_matches_jax(shape, distances, pad):
    model_j, cfm_j = density_estimator(shape, distances, pad=pad)
    model_t, cfm_t = jt.density_estimator(shape, distances, pad=pad)
    assert sorted(model_t.domain) == sorted(model_j.domain)
    for k, v in model_j.domain.items():
        assert model_t.domain[k].shape == tuple(v.shape)
    assert isinstance(cfm_t, jt.CorrelatedFieldMaker)
    lat = _latents(model_j.domain, 1)
    jit_j = jax.jit(model_j)
    want = jit_j({k: jnp.asarray(v) for k, v in lat.items()})
    got = model_t(jt.from_numpy(lat))
    assert tuple(got.shape) == ((shape,) if isinstance(shape, int) else shape)
    _close(got, want, 1e-10)
    # rows of the lockstep stages pass through: the crop acts on the trailing axes
    lat2 = _latents(model_j.domain, 2, batch=(2,))
    _close(model_t(jt.from_numpy(lat2)),
           jax.vmap(jit_j)({k: jnp.asarray(v) for k, v in lat2.items()}), 1e-10)


def test_density_estimator_options():
    fl = {"scale": (0.3, 0.1), "cutoff": (2.0, 1.0), "loglogslope": (-4.0, 1.0)}
    model_j, _ = density_estimator(32, 1.0 / 32, cf_fluctuations=fl,
                                   cf_azm_uniform=(0.1, 2.0), prefix="d_")
    model_t, _ = jt.density_estimator(32, 1.0 / 32, cf_fluctuations=fl,
                                      cf_azm_uniform=(0.1, 2.0), prefix="d_")
    assert sorted(model_t.domain) == sorted(model_j.domain)
    assert all(k.startswith("d_density") for k in model_t.domain)
    lat = _latents(model_j.domain, 3)
    _close(model_t(jt.from_numpy(lat)), model_j({k: jnp.asarray(v) for k, v in lat.items()}),
           1e-10)


def _preimage_model(mod):
    tanh = jnp.tanh if mod is jft else torch.tanh
    return mod.Model(lambda x: {"y": tanh(x["a"]) + 0.5 * x["b"][..., :4] ** 2},
                     domain={"a": mod.ShapeWithDtype((4,)), "b": mod.ShapeWithDtype((6,))})


def test_calculate_position_matches_jax():
    out = {"y": np.array([0.3, -0.2, 0.9, 0.1])}
    key = jax.random.PRNGKey(5)
    pos_j = jft.calculate_position(_preimage_model(jft), {"y": jnp.asarray(out["y"])}, key=key)
    model_t = _preimage_model(jt)
    pos_t = jt.calculate_position(model_t, jt.from_numpy(out), key=JaxKey(key))
    _close(pos_t, pos_j, 1e-6)
    _close(model_t(pos_t), out, 0.05)


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = {"x": rng.standard_normal(5) + 1j * rng.standard_normal(5),
         "y": rng.standard_normal((2, 3))}
    b = {"x": rng.standard_normal(5), "y": rng.standard_normal((2, 3))}
    aj, bj = jax.tree_util.tree_map(jnp.asarray, a), jax.tree_util.tree_map(jnp.asarray, b)
    at, bt = jt.from_numpy(a), jt.from_numpy(b)
    _close(ttree.tsum(at), jtree.tsum(aj), 1e-14)
    _close(ttree.dot(at, bt), jtree.dot(aj, bj), 1e-14)
    _close(ttree.conj(at), jtree.conj(aj), 0)
    _close(ttree.tree_scale(at, 2.5), jtree.tree_scale(aj, 2.5), 0)
    _close(ttree.ones_like(bt), jtree.ones_like(bj), 0)
    stacked = [bt, ttree.tree_scale(bt, 3.0), at]
    _close(ttree.mean(stacked[:2]), jtree.mean([bj, jtree.tree_scale(bj, 3.0)]), 1e-15)
    _close(ttree.mean(ttree.stack(stacked[:2])), jtree.mean(jtree.stack([bj, jtree.tree_scale(
        bj, 3.0)])), 1e-15)
    u_t = ttree.unite({"p": torch.ones(2), "q": torch.ones(3)}, {"q": torch.ones(3), "r": 1.0})
    u_j = jtree.unite({"p": jnp.ones(2), "q": jnp.ones(3)}, {"q": jnp.ones(3), "r": 1.0})
    assert sorted(u_t) == sorted(u_j) == ["p", "q", "r"]
    assert torch.equal(u_t["q"], torch.full((3,), 2.0))
    assert isinstance(ttree.unite(jt.Vector({"p": 1.0}), {"q": 2.0}), jt.Vector)
    assert ttree.has_arithmetics(jt.Vector(bt)) and jtree.has_arithmetics(jft.Vector(bj))
    assert not ttree.has_arithmetics(bt) and not jtree.has_arithmetics(bj)
    assert ttree.has_arithmetics(torch.ones(2))
    v = jt.Vector(bt) @ jt.Vector(ttree.tree_map(lambda x: x.new_ones(x.shape[::-1]), bt))
    assert v["y"].shape == (2, 2)
    assert torch.equal((jt.Vector(bt) % 1.0)["x"], bt["x"] % 1.0)
    assert torch.equal((jt.Vector(bt) // 1.0)["y"], bt["y"] // 1.0)


def test_wrap_left_matches_jax():
    fj = jft.wrap_left(lambda x, s=1.0: s * x, "out")
    ft = jt.wrap_left(lambda x, s=1.0: s * x, "out")
    assert ft(torch.ones(2), s=3.0)["out"].tolist() == [3.0, 3.0]
    assert list(fj(jnp.ones(2), s=3.0)) == ["out"]
    both = jt.wrap(jt.wrap_left(torch.exp, "e"), "x")
    assert torch.equal(both({"x": torch.zeros(3)})["e"], torch.ones(3))
