"""MGVI draws and geoVI curves of likelihoods whose square roots of the
metric do not come from a transformation, against ``nifty_tpu`` on the same
numpy inputs and replayed noise (1e-8, as the other draw tests): a
``Categorical`` (no transformation: the right root is the transpose of the
left) with and without ``napprox`` and in lockstep, and a
``VariableCovarianceGaussian`` (a closed-form left root that is not the
vjp of its transformation) in the geoVI curve.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu_torch import evi as tevi  # noqa: E402
from test_torch_driver import JaxKey  # noqa: E402
from test_torch_likelihoods import REAL, _close, _to_jax, _to_torch  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


# -- a Categorical's MGVI draw: the left square root without a transformation


def _categorical_problem(mod):
    as_arr = jnp.asarray if mod is jft else torch.from_numpy
    tanh = jnp.tanh if mod is jft else torch.tanh
    logits = mod.Model(lambda x: 2.0 * tanh(x["w"]) + x["b"][..., None, :],
                       domain={"w": mod.ShapeWithDtype((8, 3)), "b": mod.ShapeWithDtype((3,))})
    labels = np.random.default_rng(10).integers(0, 3, (8, 1))
    return mod.Categorical(as_arr(labels)).amend(logits)


CAT_POS = {"w": np.random.default_rng(11).standard_normal((8, 3)),
           "b": np.random.default_rng(12).standard_normal(3)}


@pytest.mark.parametrize("napprox", [0, 4])
def test_categorical_draw_matches_jax(napprox):
    lh_j, lh_t = _categorical_problem(jft), _categorical_problem(jt)
    key = jax.random.PRNGKey(13)
    kw = dict(cg_kwargs=dict(maxiter=5), napprox=napprox)
    res_j, info_j = jft.draw_linear_residual(lh_j, _to_jax(CAT_POS), key, **kw)
    res_t, info_t = jt.draw_linear_residual(lh_t, _to_torch(CAT_POS), JaxKey(key), **kw)
    assert int(info_t) == int(info_j)
    _close(res_t, res_j, 1e-8)


def test_categorical_lockstep_draw_matches_vmapped_jax():
    lh_j, lh_t = _categorical_problem(jft), _categorical_problem(jt)
    keys = jax.random.split(jax.random.PRNGKey(14), 3)
    kw = dict(cg_kwargs=dict(maxiter=5))
    res_j, info_j = jax.vmap(
        lambda k: jft.draw_linear_residual(lh_j, _to_jax(CAT_POS), k, **kw))(keys)
    res_t, info_t = tevi.draw_linear_residuals(
        lh_t, _to_torch(CAT_POS), [JaxKey(k) for k in keys], **kw)
    assert info_t.tolist() == np.asarray(info_j).astype(int).tolist()
    _close(res_t, res_j, 1e-8)


# -- geoVI with a closed-form left square root that is not T's vjp ---------


def _vc_gaussian_problem(mod):
    exp = jnp.exp if mod is jft else torch.exp
    as_arr = jnp.asarray if mod is jft else torch.from_numpy
    f = mod.Model(lambda x: (x["m"], exp(0.3 * x["s"])),
                  domain={"m": mod.ShapeWithDtype((6,)), "s": mod.ShapeWithDtype((6,))})
    return mod.VariableCovarianceGaussian(as_arr(REAL)).amend(f)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_vc_gaussian_curve_matches_jax(sign):
    """``VariableCovarianceGaussian``'s left square root is the root of its
    metric, not the vjp of its (local) transformation; the geoVI curve
    takes the root, as the JAX package does."""
    lh_j, lh_t = _vc_gaussian_problem(jft), _vc_gaussian_problem(jt)
    assert not lh_t.lsm_is_transformation_vjp
    rng = np.random.default_rng(15)
    pos = {"m": rng.standard_normal(6), "s": rng.standard_normal(6)}
    res = {k: 0.3 * rng.standard_normal(6) for k in pos}
    key = jax.random.PRNGKey(16)
    mk = dict(xtol=1e-6, maxiter=3, cg_kwargs=dict(maxiter=5))
    new_j, st_j = jft.nonlinearly_update_residual(
        lh_j, _to_jax(pos), _to_jax(res), key, sign, minimize_kwargs=mk)
    new_t, st_t = jt.nonlinearly_update_residual(
        lh_t, _to_torch(pos), _to_torch(res), JaxKey(key), sign, minimize_kwargs=mk)
    assert int(st_t.nit) == int(st_j.nit)
    _close(new_t, new_j, 1e-8)
