"""Parity of the port's spherical correlated fields (Gauss-Legendre and
HEALPix) with ``nifty_tpu`` from the same latents, float64.

Tolerances: the field, its jvp and vjp and a Gaussian likelihood's metric
matvec agree to 1e-10 of the largest entry (an SHT and a handful of
pointwise passes, summed in another order); one ``OptimizeVI.update`` with
CG budgets of 5 steps and the noise replayed agrees to 1e-8 in KL energy
(CG amplifies rounding differences step by step, so long solves are not
comparable).  The a-priori std checks are the JAX package's own, on 200
prior draws.
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.models import correlated_field as jcf  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.models import correlated_field as tcf  # noqa: E402
from nifty_tpu_torch.ops import hp_longitude as hl  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-10
NOISE_STD = 0.1
CONFIGS = [(8, "spherical"), (16, "spherical"), (15, "healpix")]
IDS = ["gl_lmax8", "gl_lmax16", "hp_lmax15_nside8"]
SHORT = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def build(mod, lmax, harmonic_type, flexibility=(1.0, 0.5)):
    cfm = mod.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(lmax, None, fluctuations=(1.0, 0.5), loglogavgslope=(-2.0, 0.5),
                         flexibility=flexibility, harmonic_type=harmonic_type)
    return cfm.finalize()


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _close_tree(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol)


def _latents(domain, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in domain.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def fields(request):
    lmax, kind = request.param
    return build(jft, lmax, kind), build(jt, lmax, kind)


@pytest.mark.parametrize("kind", ["spherical", "sphere", "sh", "healpix", "hp"])
def test_grid_metadata_is_the_jax_packages(kind):
    gj, gt = jcf.make_grid(7, None, harmonic_type=kind), tcf.make_grid(7, None, harmonic_type=kind)
    assert gt.shape == tuple(gj.shape)
    assert gt.total_volume == gj.total_volume
    hj, ht = gj.harmonic_grid, gt.harmonic_grid
    assert tuple(ht.shape) == tuple(hj.shape) == (64,)
    assert ht.lmax == hj.lmax == 7
    for name in ("power_distributor", "mode_multiplicity", "mode_lengths",
                 "relative_log_mode_lengths", "log_volume"):
        np.testing.assert_array_equal(getattr(ht, name), getattr(hj, name))


def test_domain_and_forward_match(fields):
    cf_j, cf_t = fields
    assert sorted(cf_t.domain) == sorted(cf_j.domain)
    for k in cf_j.domain:
        assert cf_t.domain[k].shape == tuple(cf_j.domain[k].shape)
    lat = _latents(cf_j.domain, 0)
    _close(cf_t(jt.from_numpy(lat)), jax.jit(cf_j)(_jax_tree(lat)))
    # the l map goes through the distributor: (lmax+1)^2 modes in lmax+1 bins
    lmax = cf_t.target_grids[0].harmonic_grid.lmax
    assert cf_t.dist.shape == ((lmax + 1) ** 2,) and cf_t.dist.nb == lmax + 1
    assert not cf_t.use_quarter


def test_jvp_and_vjp_match(fields):
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j.domain, 1), _latents(cf_j.domain, 2)
    y = jax.jit(cf_j)(_jax_tree(lat))
    ct = np.random.default_rng(3).standard_normal(y.shape)
    tan_j = jax.jit(lambda p, t: jax.jvp(cf_j, (p,), (t,))[1])(_jax_tree(lat), _jax_tree(tan))
    cot_j = jax.jit(lambda p, c: jax.vjp(cf_j, p)[1](c)[0])(_jax_tree(lat), jnp.asarray(ct))
    _, fwd, bwd = linearize(cf_t, jt.from_numpy(lat))
    _close(fwd(jt.from_numpy(tan)), tan_j)
    _close_tree(bwd(torch.from_numpy(ct)), cot_j)
    _, tan_f = torch.func.jvp(cf_t, (jt.from_numpy(lat),), (jt.from_numpy(tan),))
    _close(tan_f, tan_j)


def test_gaussian_metric_matches(fields):
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j.domain, 4), _latents(cf_j.domain, 5)
    data = np.array(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 6))))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data),
                       noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    p_t = jt.from_numpy(lat)
    _close(lh_t(p_t), jax.jit(lh_j)(_jax_tree(lat)))
    want = jax.jit(lh_j.metric)(_jax_tree(lat), _jax_tree(tan))
    _close_tree(lh_t.metric(p_t, jt.from_numpy(tan)), want)
    _close_tree(lh_t.metric_at(p_t)(jt.from_numpy(tan)), want)


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


def test_one_update_matches():
    """HEALPix lmax 15, nside 8, the main path's transform, with the sample
    loop (``"smap"``, as the main path runs it; the JAX package's HEALPix
    transform has no batching rule for per-sample tables under ``"vmap"``)."""
    cf_j, cf_t = build(jft, 15, "healpix", None), build(jt, 15, "healpix", None)
    rng = np.random.default_rng(7)
    truth = np.asarray(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 8))))
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data),
                       noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    pos = _latents(cf_j.domain, 9)
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="smap", kl_map="smap")
    smp_j = jft.Samples(pos=_jax_tree(pos), samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(7), **SHORT))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map="smap", kl_map="smap")
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(7)), **SHORT))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_array_equal(np.asarray(st_t.sample_state.nit),
                                  np.asarray(st_j.sample_state.nit))
    np.testing.assert_allclose(st_t.minimization_state.fun, float(st_j.minimization_state.fun),
                               rtol=1e-8)
    _close_tree(smp_t.pos, smp_j.pos, 1e-6)


def _prior_std(cf, n=200, seed=0):
    shapes = {k: jt.ShapeWithDtype((n,) + tuple(v.shape)) for k, v in cf.domain.items()}
    with torch.no_grad():
        return cf(jt.random_like(torch.Generator().manual_seed(seed), shapes, device="cpu"))


def test_spherical_correlated_field_std():
    """The JAX package's check: fluctuations (2, 1e-3) give a pointwise std
    of 2 on a Gauss-Legendre grid (quadrature-weighted over the sphere)."""
    cfm = jt.CorrelatedFieldMaker("s")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-3, 1e-4))
    cfm.add_fluctuations(16, None, fluctuations=(2.0, 1e-3), loglogavgslope=(-0.5, 1e-3),
                         flexibility=None, harmonic_type="spherical")
    outs = _prior_std(cfm.finalize()).numpy()
    sht = jt.SphericalHarmonicTransform(16, device="cpu")
    w = sht.quad_weights[:, None] * np.ones((1, sht.nphi)) * 2 * np.pi / sht.nphi
    std = np.sqrt(float((np.var(outs, axis=0) * w).sum() / (4 * np.pi)))
    assert abs(std - 2.0) < 0.25


def test_healpix_correlated_field():
    """The JAX package's check on HEALPix: default nside (lmax+1)//2 and a
    pointwise std of 2."""
    cfm = jt.CorrelatedFieldMaker("h")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-3, 1e-4))
    cfm.add_fluctuations(12, None, fluctuations=(2.0, 1e-3), loglogavgslope=(-0.5, 1e-3),
                         flexibility=None, harmonic_type="healpix")
    outs = _prior_std(cfm.finalize()).numpy()
    assert outs.shape[1] == 12 * 6 ** 2
    std = float(np.sqrt(np.var(outs, axis=0).mean()))
    assert abs(std - 2.0) < 0.3


def test_sole_subgrid_rule_and_simple_field():
    cfm = jt.CorrelatedFieldMaker("x")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 1e-2))
    cfm.add_fluctuations(8, None, fluctuations=(1.0, 0.1), loglogavgslope=(-2.0, 0.1),
                         harmonic_type="healpix", prefix="sky")
    cfm.add_fluctuations(4, 0.25, fluctuations=(1.0, 0.1), loglogavgslope=(-2.0, 0.1),
                         prefix="freq")
    with pytest.raises(NotImplementedError, match="sole subgrid"):
        cfm.finalize()
    with pytest.raises(ValueError, match="harmonic_type"):
        tcf.make_grid(8, 1.0, harmonic_type="wavelet")
    cf = jt.SimpleCorrelatedField(7, None, harmonic_type="hp")
    hl.reset_launch_counts()
    y = cf(cf.init(0))
    assert y.shape == (12 * 4 ** 2,) and bool(torch.isfinite(y).all())
    # on the CPU the plain version runs, never the kernel
    assert hl.hp_longitude.launches == 0


def test_transform_compute_dtype_runs_the_sphere_in_float32(fields):
    cf_j, cf_t = fields
    lat = jt.from_numpy(_latents(cf_j.domain, 10))
    want = cf_t(lat)
    jt.config.update("transform_compute_dtype", "float32")
    try:
        got = cf_t(lat)
    finally:
        jt.config.update("transform_compute_dtype", None)
    assert got.dtype == torch.float64
    _close(got, want, 1e-5)
