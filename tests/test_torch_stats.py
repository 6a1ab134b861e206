"""Parity of the port's distribution transforms and prior models with
``nifty_tpu.stats`` / ``nifty_tpu.prior`` on the same numpy inputs in
float64: every transform, inverse and prior model at 1e-12 of the largest
entry, on arguments inside and outside the interpolation tables (which end
at +-8.2; outside them both take the end values), and their gradients.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import stats as jstats  # noqa: E402
from nifty_tpu_torch import stats as tstats  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


# standard normal arguments from deep in both tails, past the tables' ends
XI = np.concatenate([np.linspace(-12.0, 12.0, 97), np.random.default_rng(0).standard_normal(40)])
POSITIVE = np.concatenate([np.geomspace(1e-9, 1e9, 61),
                           np.random.default_rng(1).uniform(0.1, 5.0, 20)])

# name -> (the JAX package's transform, the port's, arguments)
TRANSFORMS = {
    "normal_prior": (jstats.normal_prior(1.5, 0.3), tstats.normal_prior(1.5, 0.3), XI),
    "normal_invprior": (jstats.normal_invprior(1.5, 0.3), tstats.normal_invprior(1.5, 0.3), XI),
    "lognormal_prior": (jstats.lognormal_prior(2.0, 0.5), tstats.lognormal_prior(2.0, 0.5),
                        XI / 2),
    "lognormal_invprior": (jstats.lognormal_invprior(2.0, 0.5),
                           tstats.lognormal_invprior(2.0, 0.5), POSITIVE),
    "laplace_prior": (jstats.laplace_prior(0.7), tstats.laplace_prior(0.7), XI),
    "uniform_prior": (jstats.uniform_prior(-1.0, 3.0), tstats.uniform_prior(-1.0, 3.0), XI),
    "uniform_prior_01": (jstats.uniform_prior(), tstats.uniform_prior(), XI),
    "invgamma_prior": (jstats.invgamma_prior(3.0, 2.0), tstats.invgamma_prior(3.0, 2.0), XI),
    "invgamma_prior_loc": (jstats.invgamma_prior(2.5, 0.5, loc=1.0),
                           tstats.invgamma_prior(2.5, 0.5, loc=1.0), XI),
    "invgamma_prior_array_scale": (
        jstats.invgamma_prior(3.0, np.linspace(0.5, 2.0, XI.size)),
        tstats.invgamma_prior(3.0, np.linspace(0.5, 2.0, XI.size)), XI),
    "invgamma_invprior": (jstats.invgamma_invprior(3.0, 2.0), tstats.invgamma_invprior(3.0, 2.0),
                          POSITIVE),
    "invgamma_invprior_loc": (jstats.invgamma_invprior(2.5, 0.5, loc=1.0),
                              tstats.invgamma_invprior(2.5, 0.5, loc=1.0), 1.0 + POSITIVE),
    "gamma_prior": (jstats.gamma_prior(2.0, 1.5), tstats.gamma_prior(2.0, 1.5), XI),
    "gamma_prior_loc": (jstats.gamma_prior(2.0, 1.5, loc=0.5, step=0.05),
                        tstats.gamma_prior(2.0, 1.5, loc=0.5, step=0.05), XI),
    "log_invgamma_prior": (jstats.log_invgamma_prior(3.0, 2.0),
                           tstats.log_invgamma_prior(3.0, 2.0), XI),
}


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name):
    fj, ft, x = TRANSFORMS[name]
    _close(ft(torch.from_numpy(x)), fj(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["laplace_prior", "uniform_prior", "invgamma_prior",
                                  "gamma_prior", "log_invgamma_prior", "lognormal_invprior"])
def test_transform_gradient_matches_jax(name):
    fj, ft, x = TRANSFORMS[name]
    # inside the table: outside it the interpolant is flat on both sides
    x = x[np.abs(x) < 8.0] if x is XI else x
    xt = torch.from_numpy(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(ft(xt).sum(), xt)
    _close(gt, jax.grad(lambda v: jnp.sum(fj(v)))(jnp.asarray(x)), 1e-10)


def test_uniform_shortcut_maps_over_a_tree():
    tree = {"a": XI[:5], "b": XI[5:11].reshape(2, 3)}
    got = tstats.uniform_prior()(jt.from_numpy(tree))
    want = jstats.uniform_prior()(jax.tree_util.tree_map(jnp.asarray, tree))
    for k in tree:
        _close(got[k], want[k])


@pytest.mark.parametrize("kind", ["num", "step_log", "inverse"])
def test_interpolator_matches_jax(kind):
    def func(x):  # positive and increasing, so that it has a log table and an inverse
        return np.exp(0.5 * x + 0.2 * np.sin(x))

    kw_j = dict(num=57) if kind == "num" else dict(step=0.05, table_func=jnp.log,
                                                   inv_table_func=jnp.exp)
    kw_t = dict(kw_j)
    if "table_func" in kw_j:
        kw_t.update(table_func=torch.log, inv_table_func=torch.exp)
    x = np.linspace(-3.5, 3.5, 301)  # beyond both ends of [-3, 3]
    if kind == "inverse":
        fj, inv_j = jstats.interpolator(func, -3.0, 3.0, return_inverse=True, **kw_j)
        ft, inv_t = tstats.interpolator(func, -3.0, 3.0, return_inverse=True, **kw_t)
        _close(inv_t(torch.from_numpy(func(x))), inv_j(jnp.asarray(func(x))))
    else:
        fj = jstats.interpolator(func, -3.0, 3.0, **kw_j)
        ft = tstats.interpolator(func, -3.0, 3.0, **kw_t)
    _close(ft(torch.from_numpy(x)), fj(jnp.asarray(x)))
    with pytest.raises(ValueError, match="exactly one"):
        tstats.interpolator(func, -3.0, 3.0)
    with pytest.raises(ValueError, match="inv_table_func"):
        tstats.interpolator(func, -3.0, 3.0, num=5, table_func=torch.log)


def test_interp_takes_the_end_values_outside_the_table():
    xp, fp = torch.tensor([0.0, 1.0, 3.0], dtype=torch.float64), \
        torch.tensor([2.0, 4.0, 0.0], dtype=torch.float64)
    x = torch.tensor([-5.0, 0.0, 0.5, 1.0, 2.0, 3.0, 9.0], dtype=torch.float64)
    want = np.interp(x.numpy(), xp.numpy(), fp.numpy())
    assert np.array_equal(tstats.interp(x, xp, fp).numpy(), want)
    assert np.array_equal(np.asarray(jnp.interp(jnp.asarray(x.numpy()), jnp.asarray(xp.numpy()),
                                                jnp.asarray(fp.numpy()))), want)


def test_transform_arguments_are_checked():
    for fn in (tstats.invgamma_prior, tstats.gamma_prior):
        with pytest.raises(TypeError, match="scalar"):
            fn(np.ones(2), 1.0)
        with pytest.raises(TypeError, match="array-like"):
            fn(2.0, np.ones(3), loc=1.0)
    with pytest.raises(ValueError, match="greater zero"):
        tstats.lognormal_prior(-1.0, 1.0)


# name -> (JAX prior model, port prior model, attribute values)
PRIORS = {
    "NormalPrior": (jft.NormalPrior(1.0, 0.5, name="x", shape=(7,)),
                    jt.NormalPrior(1.0, 0.5, name="x", shape=(7,)), dict(mean=1.0, std=0.5)),
    "LogNormalPrior": (jft.LogNormalPrior(1.0, 0.5, name="x", shape=(7,)),
                       jt.LogNormalPrior(1.0, 0.5, name="x", shape=(7,)),
                       dict(mean=1.0, std=0.5)),
    "UniformPrior": (jft.UniformPrior(-2.0, 5.0, name="x", shape=(7,)),
                     jt.UniformPrior(-2.0, 5.0, name="x", shape=(7,)),
                     dict(low=-2.0, high=5.0, a_min=-2.0, a_max=5.0)),
    "LaplacePrior": (jft.LaplacePrior(0.3, name="x", shape=(7,)),
                     jt.LaplacePrior(0.3, name="x", shape=(7,)), dict(alpha=0.3)),
    "InvGammaPrior": (jft.InvGammaPrior(3.0, 2.0, name="x", shape=(7,)),
                      jt.InvGammaPrior(3.0, 2.0, name="x", shape=(7,)),
                      dict(a=3.0, scale=2.0, loc=0.0, step=1e-2)),
    "GammaPrior": (jft.GammaPrior(2.0, 1.5, name="x", shape=(7,)),
                   jt.GammaPrior(2.0, 1.5, name="x", shape=(7,)),
                   dict(a=2.0, scale=1.5, loc=0.0)),
    "LogInvGammaPrior": (jft.LogInvGammaPrior(3.0, 2.0, name="x", shape=(7,)),
                         jt.LogInvGammaPrior(3.0, 2.0, name="x", shape=(7,)),
                         dict(a=3.0, scale=2.0, loc=0.0)),
}


@pytest.mark.parametrize("name", PRIORS)
def test_prior_model_matches_jax(name):
    pj, pt, attrs = PRIORS[name]
    assert list(pt.domain) == ["x"] and pt.domain["x"].shape == (7,)
    for k, v in attrs.items():
        assert getattr(pt, k) == getattr(pj, k) == v
    xi = np.concatenate([[-9.0, 9.0], np.random.default_rng(2).standard_normal(5)])
    _close(pt({"x": torch.from_numpy(xi)}), pj({"x": jnp.asarray(xi)}))
    # a latent with leading batch axes passes through
    xi2 = np.random.default_rng(3).standard_normal((2, 7))
    _close(pt({"x": torch.from_numpy(xi2)}), jax.vmap(pj)({"x": jnp.asarray(xi2)}))
    init = pt.init(0)
    assert init["x"].shape == (7,) and init["x"].dtype == torch.float64
