"""The port's parametric VI (``variational.py``) against
``nifty_tpu.variational`` on the same likelihood, parameters and noise,
float64 on the CPU.

The port takes its ε from a noise provider that splits keys with
``jax.random.split`` and draws as the reference does (``random_like`` for
the mean-field family, ``jax.random.normal`` of the flattened dimension for
the full-covariance one), so both see the same samples.  Both families'
``loss`` at fixed parameters agrees with the reference's to 1e-12 relative,
its gradient to 1e-10, and five Adam steps with ``optax.adam(1e-2)`` to
1e-10 (parameters and losses; optax is only used here).
"""

import importlib

import jax
import numpy as np
import optax
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu_torch import tree as tt  # noqa: E402

jv = importlib.import_module("nifty_tpu.variational")
tv = importlib.import_module("nifty_tpu_torch.variational")

torch.set_num_threads(1)

DATA = np.array([1.0, -0.5, 0.3, 0.7, -0.2])


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


def _tree_rel(got, want):
    return max(_rel(np.asarray(got[k]), np.asarray(want[k])) for k in want)


def _struct(tree):
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float64)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG: ``random_like`` for a
    tree, or with ``flat=True`` ``jax.random.normal`` of a single leaf (the
    full-covariance family's ε)."""

    def __init__(self, key, flat=False):
        self.key, self.flat = key, flat

    def split(self, num):
        return [JaxKey(k, self.flat) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        if self.flat:
            out = jax.random.normal(self.key, tuple(primals.shape))
        else:
            out = jtree.random_like(self.key, _struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device or "cpu")


def _likelihoods():
    """A nonlinear forward model of a dict latent ({"a": (3,), "b": ()})
    onto 5 data, Gaussian noise 0.3; the port's model maps leading batch
    axes through."""

    def fwd_j(x):
        return jnp.concatenate([x["a"] + x["b"] ** 2, jnp.sin(x["a"][:2])])

    def fwd_t(x):
        return torch.cat([x["a"] + x["b"][..., None] ** 2, torch.sin(x["a"][..., :2])], dim=-1)

    dom_j = {"a": jft.ShapeWithDtype((3,)), "b": jft.ShapeWithDtype(())}
    dom_t = {"a": jt.ShapeWithDtype((3,)), "b": jt.ShapeWithDtype(())}
    lh_j = jft.Gaussian(jnp.asarray(DATA), noise_std_inv=lambda x: x / 0.3).amend(
        jft.Model(fwd_j, domain=dom_j))
    lh_t = jt.Gaussian(torch.from_numpy(DATA), noise_std_inv=lambda x: x / 0.3).amend(
        jt.Model(fwd_t, domain=dom_t))
    return lh_j, lh_t


def _mf_params(rng):
    return {"mean": {"a": rng.standard_normal(3), "b": np.asarray(rng.standard_normal())},
            "log_std": {"a": np.log(0.1 + rng.uniform(size=3)),
                        "b": np.asarray(np.log(0.3))}}


def _fc_params(rng):
    return {"mean": rng.standard_normal(4), "log_diag": np.log(0.1 + rng.uniform(size=4)),
            "lower": 0.2 * rng.standard_normal(6)}


FAMILIES = {
    "mean_field": (lambda m: m.MeanFieldVI, _mf_params, False),
    "full_covariance": (lambda m: m.FullCovarianceVI, _fc_params, True),
}


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradient(family, mirror):
    cls, make, flat = FAMILIES[family]
    lh_j, lh_t = _likelihoods()
    vi_j = cls(jv)(lh_j, n_samples=3, mirror_samples=mirror, optimizer=optax.adam(1e-2))
    vi_t = cls(tv)(lh_t, n_samples=3, mirror_samples=mirror)
    p = make(np.random.default_rng(1))
    key = jax.random.PRNGKey(5)
    l_j, g_j = jax.value_and_grad(vi_j.loss)(jax.tree_util.tree_map(jnp.asarray, p), key)
    p_t = jt.from_numpy(p)
    leaves = [x.requires_grad_(True) for x in tt.tree_leaves(p_t)]
    l_t = vi_t.loss(p_t, JaxKey(key, flat))
    g_t = tt.tree_unflatten(p_t, torch.autograd.grad(l_t, leaves))
    assert abs(l_t.item() - float(l_j)) <= 1e-12 * abs(float(l_j))
    for k in g_j:
        got = np.concatenate([np.ravel(x) for x in tt.tree_leaves(tt.to_numpy(g_t[k]))])
        want = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(g_j[k])])
        assert _rel(got, want) < 1e-10


def test_loss_is_the_hamiltonian_at_mean_plus_minus_sigma_eps():
    """The mean-field loss by hand: the mean of H(m + σε) and H(m − σε)
    over the reference's ε, minus the summed log σ."""
    lh_j, lh_t = _likelihoods()
    vi_t = tv.MeanFieldVI(lh_t, n_samples=2)
    p = _mf_params(np.random.default_rng(2))
    key = jax.random.PRNGKey(6)
    ham = importlib.import_module("nifty_tpu.optimize_kl")._StandardHamiltonian(lh_j)
    want = 0.0
    for k in jax.random.split(key, 2):
        eps = jtree.random_like(k, _struct(p["mean"]))
        sig = {n: np.exp(p["log_std"][n]) for n in p["mean"]}
        for sign in (1.0, -1.0):
            x = {n: jnp.asarray(p["mean"][n] + sign * sig[n] * np.asarray(eps[n])) for n in sig}
            want += 0.25 * float(ham(x))
    want -= sum(float(np.sum(v)) for v in p["log_std"].values())
    got = float(vi_t.loss(jt.from_numpy(p), JaxKey(key)))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_five_adam_steps(family):
    cls, make, flat = FAMILIES[family]
    lh_j, lh_t = _likelihoods()
    vi_j = cls(jv)(lh_j, n_samples=4, optimizer=optax.adam(1e-2))
    vi_t = cls(tv)(lh_t, n_samples=4)
    p = make(np.random.default_rng(3))
    key = jax.random.PRNGKey(9)
    pj, losses_j = vi_j.run(key, n_steps=5, params=jax.tree_util.tree_map(jnp.asarray, p))
    pt, losses_t = vi_t.run(JaxKey(key, flat), n_steps=5, params=jt.from_numpy(p))
    assert _rel(losses_t, losses_j) < 1e-10
    flat_j = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(pj)])
    flat_t = np.concatenate([np.ravel(x) for x in tt.tree_leaves(tt.to_numpy(pt))])
    assert _rel(flat_t, flat_j) < 1e-10


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_and_sample(family):
    """``init_params`` and ``sample`` from the reference's noise."""
    cls, _, flat = FAMILIES[family]
    lh_j, lh_t = _likelihoods()
    vi_j = cls(jv)(lh_j, optimizer=optax.adam(1e-2))
    vi_t = cls(tv)(lh_t)
    k_init, k_smpl = jax.random.split(jax.random.PRNGKey(4))
    pj, pt = vi_j.init_params(k_init), vi_t.init_params(JaxKey(k_init))
    for k in pj:
        fj = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(pj[k])])
        ft = np.concatenate([np.ravel(x) for x in tt.tree_leaves(tt.to_numpy(pt[k]))])
        np.testing.assert_allclose(ft, fj, rtol=1e-15, atol=0)
    sj = vi_j.sample(pj, k_smpl)
    st = vi_t.sample(pt, JaxKey(k_smpl, flat))
    assert _tree_rel(tt.to_numpy(st), sj) < 1e-13
    assert st["a"].shape == (3,) and st["b"].shape == ()


def test_full_covariance_cholesky():
    lh_j, lh_t = _likelihoods()
    p = _fc_params(np.random.default_rng(7))
    L_j = jv.FullCovarianceVI(lh_j, optimizer=optax.adam(1e-2))._cholesky(
        jax.tree_util.tree_map(jnp.asarray, p))
    L_t = tv.FullCovarianceVI(lh_t)._cholesky(jt.from_numpy(p))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-14, atol=0)


def test_an_optimizer_is_a_callable_of_the_parameters():
    """``optimizer=`` takes a parameter list; SGD's first step moves every
    parameter by -lr times its gradient."""
    _, lh_t = _likelihoods()
    seen = []

    def sgd(params):
        seen.append(len(params))
        return torch.optim.SGD(params, lr=1e-3)

    vi = tv.MeanFieldVI(lh_t, n_samples=2, optimizer=sgd)
    p0 = jt.from_numpy(_mf_params(np.random.default_rng(8)))
    p1, losses = vi.run(jt.HostKey(3), n_steps=1, params=p0)
    assert seen == [4] and losses.shape == (1,)
    k_step = jt.split(jt.HostKey(3), 2)[1]
    leaves = [x.clone().requires_grad_(True) for x in tt.tree_leaves(p0)]
    grads = torch.autograd.grad(vi.loss(tt.tree_unflatten(p0, leaves), k_step), leaves)
    for x0, x1, g in zip(tt.tree_leaves(p0), tt.tree_leaves(p1), grads):
        torch.testing.assert_close(x1, x0 - 1e-3 * g, rtol=1e-14, atol=1e-15)


def test_demo8_banana_runs():
    """``demos/8_parametric_vi.py``'s model, 300 steps of each family on the
    CPU: both losses fall and the full-covariance samples correlate x0 and
    x1 more than the mean-field ones."""

    def fwd(x):
        return (x["x0"] + x["x1"] ** 2)[..., None]

    lh = jt.Gaussian(torch.tensor([1.0], dtype=torch.float64),
                     noise_std_inv=lambda x: x / 0.2).amend(
        jt.Model(fwd, domain={"x0": jt.ShapeWithDtype(()), "x1": jt.ShapeWithDtype(())}))
    corr = {}
    for name, cls in (("mf", tv.MeanFieldVI), ("fc", tv.FullCovarianceVI)):
        vi = cls(lh, n_samples=8)
        params, losses = vi.run(jt.HostKey(0 if name == "mf" else 1), n_steps=300)
        assert float(losses[-20:].mean()) < float(losses[:20].mean())
        s = [vi.sample(params, k) for k in jt.split(jt.HostKey(2), 256)]
        x0 = np.array([float(v["x0"]) for v in s])
        x1 = np.array([float(v["x1"]) for v in s])
        corr[name] = abs(np.corrcoef(x0, x1)[0, 1])
    assert corr["mf"] < 0.35 and corr["fc"] > corr["mf"]
