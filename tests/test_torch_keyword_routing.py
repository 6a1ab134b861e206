"""Keyword routing through the port's likelihoods against ``nifty_tpu``'s,
on a 16^2 correlated field in float64: a keyword routed to the likelihood
(``amend(..., likelihood_argnames=)``) and one to the model, through
``energy``, its gradient and jvp, ``transformation``,
``normalized_residual``, ``metric``, ``metric_at`` and both square roots
of the metric, within 1e-10 of the largest entry; the same through a
model chained by ``LikelihoodWithModel.amend(left_argnames=)``, a
``LikelihoodSum`` and a ``LikelihoodPartial``.  Without keywords the
composed likelihood gives the bits of its explicit construction."""

from functools import partial

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu_torch import likelihood as tlh  # noqa: E402
from test_torch_driver import build  # noqa: E402

torch.set_num_threads(1)
KW = dict(scale=1.3, shift=0.2)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _scaled(base):
    """``base`` (a Gaussian class) at ``scale * x``: a likelihood with a
    keyword of its own."""

    class Scaled(base):
        def energy(self, primals, *, scale=1.0):
            return super().energy(scale * primals)

        def normalized_residual(self, primals, *, scale=1.0):
            return super().normalized_residual(scale * primals)

        def transformation(self, primals, *, scale=1.0):
            return super().transformation(scale * primals)

        def metric(self, primals, tangents, *, scale=1.0):
            return scale * super().metric(scale * primals, scale * tangents)

        def left_sqrt_metric(self, primals, tangents, *, scale=1.0):
            return scale * super().left_sqrt_metric(scale * primals, tangents)

    return Scaled


def _likelihoods(dims=(16, 16), seed=4):
    cf_j, cf_t = build(jft, dims), build(jt, dims)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(dims)
    data2 = rng.standard_normal(dims)

    def model(cf):
        return lambda p, *, shift=0.0: cf(p) + shift

    def cov(x):
        return x / 0.04

    out = {}
    for name, mod, arr, cf in (("j", jft, jnp.asarray, cf_j), ("t", jt, torch.from_numpy, cf_t)):
        S = _scaled(mod.Gaussian)
        lh = S(arr(data), noise_cov_inv=cov).amend(model(cf), domain=cf.domain,
                                                   likelihood_argnames=("scale",))
        lh2 = S(arr(data2), noise_cov_inv=cov).amend(model(cf), domain=cf.domain,
                                                     likelihood_argnames=("scale",))
        out[name] = dict(cf=cf, lh=lh, sum=lh + lh2)
    return out, cf_j.domain, rng


def _jtree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _close(got, want, tol=1e-10):
    g_leaves = jt.tree.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.max(np.abs(w)), 1e-300))


@pytest.fixture(scope="module")
def setup():
    lhs, domain, rng = _likelihoods()
    x = {k: rng.standard_normal(v.shape) for k, v in domain.items()}
    t = {k: rng.standard_normal(v.shape) for k, v in domain.items()}
    d = rng.standard_normal((16, 16))
    return lhs, x, t, d


def _both(lhs, which, fn_j, fn_t):
    return fn_t(lhs["t"][which]), fn_j(lhs["j"][which])


@pytest.mark.parametrize("method", ["energy", "transformation", "normalized_residual"])
def test_values_match_jax(setup, method):
    lhs, x, _, _ = setup
    got = getattr(lhs["t"]["lh"], method)(jt.from_numpy(x), **KW)
    want = getattr(lhs["j"]["lh"], method)(_jtree(x), **KW)
    _close(got, want)
    # the keywords change the result
    plain = getattr(lhs["t"]["lh"], method)(jt.from_numpy(x))
    assert not torch.equal(jt.tree.tree_leaves(plain)[0], jt.tree.tree_leaves(got)[0])


def test_energy_gradient_and_jvp_match_jax(setup):
    lhs, x, t, _ = setup
    lh_t, lh_j = lhs["t"]["lh"], lhs["j"]["lh"]
    v_t, g_t = tlh.value_and_grad(partial(lh_t.energy, **KW), jt.from_numpy(x))
    v_j, g_j = jax.value_and_grad(partial(lh_j.energy, **KW))(_jtree(x))
    _close(v_t, v_j)
    _close(g_t, g_j)
    _, jvp_t, _ = tlh.linearize(partial(lh_t.energy, **KW), jt.from_numpy(x))
    _, jvp_j = jax.jvp(partial(lh_j.energy, **KW), (_jtree(x),), (_jtree(t),))
    _close(jvp_t(jt.from_numpy(t)), jvp_j)


@pytest.mark.parametrize("which", ["lh", "sum"])
def test_metric_and_its_roots_match_jax(setup, which):
    lhs, x, t, d = setup
    lh_t, lh_j = lhs["t"][which], lhs["j"][which]
    xt, xj, tt, tj = jt.from_numpy(x), _jtree(x), jt.from_numpy(t), _jtree(t)
    _close(lh_t.metric(xt, tt, **KW), lh_j.metric(xj, tj, **KW))
    _close(lh_t.metric_at(xt, **KW)(tt), lh_j.metric_at(xj, **KW)(tj))
    _close(lh_t.right_sqrt_metric(xt, tt, **KW), lh_j.right_sqrt_metric(xj, tj, **KW))
    dd = {"lh_left": d, "lh_right": 2.0 * d} if which == "sum" else d
    _close(lh_t.left_sqrt_metric(xt, jt.from_numpy(dd), **KW),
           lh_j.left_sqrt_metric(xj, _jtree(dd), **KW))
    lsm, rsm = lh_t.sqrt_metric_at(xt, **KW)
    _close(rsm(tt), lh_j.right_sqrt_metric(xj, tj, **KW))
    _close(lsm(jt.from_numpy(dd)), lh_j.left_sqrt_metric(xj, _jtree(dd), **KW))


def test_chained_amend_routes_left_argnames(setup):
    lhs, x, t, _ = setup

    def tilt(mod):
        return lambda p, *, tilt=0.0: {k: v * (1.0 + tilt) for k, v in p.items()}

    kw = dict(KW, tilt=0.25)
    lh_t = lhs["t"]["lh"].amend(tilt(jt), domain=lhs["t"]["cf"].domain, left_argnames=("shift",))
    lh_j = lhs["j"]["lh"].amend(tilt(jft), domain=lhs["j"]["cf"].domain, left_argnames=("shift",))
    assert isinstance(lh_t, jt.LikelihoodWithModel)
    assert lh_t.likelihood_argnames == lh_j.likelihood_argnames == ("scale",)
    xt, xj, tt, tj = jt.from_numpy(x), _jtree(x), jt.from_numpy(t), _jtree(t)
    _close(lh_t.energy(xt, **kw), lh_j.energy(xj, **kw))
    _close(lh_t.metric(xt, tt, **kw), lh_j.metric(xj, tj, **kw))
    _close(lh_t.right_sqrt_metric(xt, tt, **kw), lh_j.right_sqrt_metric(xj, tj, **kw))


def test_partial_passes_keywords_on(setup):
    lhs, x, t, _ = setup
    frozen = ("cfzeromode",)
    lp_t, liq_t = lhs["t"]["lh"].freeze(primals=jt.from_numpy(x), point_estimates=frozen)
    lp_j, liq_j = lhs["j"]["lh"].freeze(primals=_jtree(x), point_estimates=frozen)
    _close(lp_t.energy(liq_t, **KW), lp_j.energy(liq_j, **KW))
    t_liq_t = lp_t.remove(jt.from_numpy(t))
    t_liq_j = lp_j.remove(_jtree(t))
    _close(lp_t.metric(liq_t, t_liq_t, **KW), lp_j.metric(liq_j, t_liq_j, **KW))
    _close(lp_t.right_sqrt_metric(liq_t, t_liq_t, **KW),
           lp_j.right_sqrt_metric(liq_j, t_liq_j, **KW))


def test_without_keywords_the_bits_of_the_explicit_construction(setup):
    """No keywords: the composed likelihood's energy, metric and square
    roots are bitwise those of the likelihood applied to the model and
    pulled back through its linearization by hand."""
    lhs, x, t, d = setup
    cf = lhs["t"]["cf"]
    data = lhs["t"]["lh"].likelihood.data
    g = jt.Gaussian(data, noise_cov_inv=lambda v: v / 0.04)
    lh = g.amend(cf)
    xt, tt, dt = jt.from_numpy(x), jt.from_numpy(t), torch.from_numpy(d)
    with torch.no_grad():
        assert torch.equal(lh.energy(xt), g.energy(cf(xt)))
        assert torch.equal(lh(xt), g.energy(cf(xt)))
    y, fwd, bwd = tlh.linearize(cf, xt)
    want = bwd(g.metric(y, fwd(tt)))
    for got in (lh.metric(xt, tt), lh.metric_at(xt)(tt)):
        for k in want:
            assert torch.equal(got[k], want[k])
    lsm, rsm = lh.sqrt_metric_at(xt)
    _, gf, gb = tlh.linearize(g.transformation, y)
    assert torch.equal(rsm(tt), gf(fwd(tt)))
    got, want = lsm(dt), bwd(gb(dt))
    for k in want:
        assert torch.equal(got[k], want[k])
