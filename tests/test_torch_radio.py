"""Radio imaging through the port against ``nifty_tpu``: the exp of a 32^2
correlated field observed by a w-stacked ``RadioResponse`` (``ops/nufft.py``,
its window pair in the plain versions) with a complex ``Gaussian``, from the
same numpy latents, uv coverage and data.

Tolerances: the likelihood's metric matvec agrees to 1e-10 of its largest
entry (the NUFFT's terms summed in another order, then the field's
transforms); one ``OptimizeVI.update`` with CG budgets of 5 steps and the
noise replayed (``ComplexJaxKey``) agrees to 1e-8 in KL energy and position (CG
amplifies rounding step by step, see ``test_torch_optimize_kl.py``).
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.ops.nufft import RadioResponse as JRadio  # noqa: E402
from nifty_tpu_torch.ops.nufft import RadioResponse as TRadio  # noqa: E402
from test_torch_optimize_kl import SHORT, JaxKey, build  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

N_VIS = 600


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _coverage(seed=21):
    """uv (wavelengths) in a disk, w from the baselines' tilt, and the pixel
    size that puts the longest baseline at 0.45 of the 32^2 grid's Nyquist."""
    rng = np.random.default_rng(seed)
    r = 2.0e4 * np.sqrt(rng.uniform(0.0, 1.0, N_VIS))
    phi = rng.uniform(0.0, 2 * np.pi, N_VIS)
    uv = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=-1)
    w = 0.6 * uv[:, 0] + rng.normal(scale=1.0e3, size=N_VIS)
    pixsize = 0.45 * 0.5 / np.max(np.hypot(uv[:, 0], uv[:, 1]))
    return uv, w, pixsize


@pytest.fixture(scope="module")
def problem():
    cf_j, cf_t = build(jft), build(jt)
    uv, w, pixsize = _coverage()
    kw = dict(pixsize=pixsize, w=w, n_w_planes=2)
    rr_j, rr_t = JRadio((32, 32), uv, **kw), TRadio((32, 32), uv, **kw)
    fwd_j = jft.Model(lambda x: rr_j(jnp.exp(cf_j(x))), domain=cf_j.domain, init=cf_j.init)
    fwd_t = jt.Model(lambda x: rr_t(torch.exp(cf_t(x))), domain=cf_t.domain, init=cf_t.init)
    rng = np.random.default_rng(22)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    vis = np.asarray(fwd_j({k: jnp.asarray(v) for k, v in lat.items()}))
    sigma = 0.1 * np.sqrt(np.mean(np.abs(vis) ** 2))
    data = vis + sigma * (rng.standard_normal(N_VIS) + 1j * rng.standard_normal(N_VIS))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / sigma ** 2).amend(fwd_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / sigma ** 2).amend(
        fwd_t)
    pos = {k: 0.1 * rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    return lh_j, lh_t, pos


def _jax_struct(tree):
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape),
                                np.complex128 if tree.dtype.is_complex else np.float64)


class ComplexJaxKey(JaxKey):
    """``JaxKey`` for complex data: complex leaves draw the JAX package's
    complex noise."""

    def split(self, num):
        return [ComplexJaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        out = jft.random_like(self.key, _jax_struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


def _close_tree(got, want, rtol):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=rtol * np.max(np.abs(w)))


def test_energy_and_metric_matvec_match_jax(problem):
    lh_j, lh_t, pos = problem
    rng = np.random.default_rng(23)
    tan = {k: rng.standard_normal(v.shape) for k, v in pos.items()}
    pos_j = {k: jnp.asarray(v) for k, v in pos.items()}
    np.testing.assert_allclose(float(lh_t.energy(jt.from_numpy(pos))),
                               float(lh_j.energy(pos_j)), rtol=1e-12)
    got = lh_t.metric(jt.from_numpy(pos), jt.from_numpy(tan))
    want = lh_j.metric(pos_j, {k: jnp.asarray(v) for k, v in tan.items()})
    _close_tree(got, want, 1e-10)


def test_update_matches_jax(problem):
    lh_j, lh_t, pos = problem
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="vmap")
    smp_j = jft.Samples(pos={k: jnp.asarray(v) for k, v in pos.items()}, samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(7), **SHORT))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map="vmap")
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(
        smp_t, opt_t.init_state(ComplexJaxKey(jax.random.PRNGKey(7)), **SHORT))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_array_equal(np.asarray(st_t.sample_state.nit),
                                  np.asarray(st_j.sample_state.nit))
    np.testing.assert_allclose(st_t.minimization_state.fun, float(st_j.minimization_state.fun),
                               rtol=1e-8)
    _close_tree(smp_t.pos, smp_j.pos, 1e-8)
