"""Parity of the port's correlated field and Gaussian likelihood with
``nifty_tpu`` from the same latents.

Tolerance 1e-10 relative to the largest entry: the field is a handful of
FFT and pointwise passes whose rounding differs between the two FFT
libraries by ~1e-15; the metric, a linearization plus its transpose, by
~1e-13.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.models import correlated_field as jcf  # noqa: E402
from nifty_tpu.models import gauss_markov as jgm  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.models import correlated_field as tcf  # noqa: E402
from nifty_tpu_torch.models import gauss_markov as tgm  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10
NOISE_STD = 0.1


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def build(mod, dims, n_bins=None):
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    kw = {} if n_bins is None else dict(n_bins=n_bins)
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
        asperity=(5e-1, 5e-2), **kw,
    )
    return cfm.finalize()


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _close_tree(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol)


def _latents(cf_j, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


CONFIGS = [((32, 32), None), ((64, 64), 16)]
IDS = ["32sq_unbinned", "64sq_16bins"]


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def fields(request):
    dims, n_bins = request.param
    return build(jft, dims, n_bins), build(jt, dims, n_bins)


def test_grid_metadata_is_the_jax_packages():
    for dims, n_bins in CONFIGS + [((128, 128), None), ((128, 128), 128)]:
        gj = jcf.make_grid(dims, 1.0 / dims[0], n_bins=n_bins).harmonic_grid
        gt = tcf.make_grid(dims, 1.0 / dims[0], n_bins=n_bins).harmonic_grid
        for name in gj._fields:
            if name != "shape":
                np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))
    # the 128^2 unbinned distributor has 1621 distinct modes
    assert tcf.make_grid((128, 128), 1 / 128).harmonic_grid.mode_lengths.size == 1621


def test_domain_and_forward_match(fields):
    cf_j, cf_t = fields
    assert sorted(cf_t.domain) == sorted(cf_j.domain)
    for k in cf_j.domain:
        assert cf_t.domain[k].shape == tuple(cf_j.domain[k].shape)
    lat = _latents(cf_j, 0)
    _close(cf_t(jt.from_numpy(lat)), cf_j(_jax_tree(lat)))


def test_jvp_and_vjp_match(fields):
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j, 1), _latents(cf_j, 2)
    ct = np.random.default_rng(3).standard_normal(cf_j.target.shape)
    _, tan_j = jax.jvp(cf_j, (_jax_tree(lat),), (_jax_tree(tan),))
    _, vjp_j = jax.vjp(cf_j, _jax_tree(lat))
    (cot_j,) = vjp_j(jnp.asarray(ct))
    _, fwd, bwd = linearize(cf_t, jt.from_numpy(lat))
    _close(fwd(jt.from_numpy(tan)), tan_j)
    _close_tree(bwd(torch.from_numpy(ct)), cot_j)
    _, tan_f = torch.func.jvp(cf_t, (jt.from_numpy(lat),), (jt.from_numpy(tan),))
    _close(tan_f, tan_j)


def test_gaussian_metric_and_energy_match(fields):
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j, 4), _latents(cf_j, 5)
    data = np.array(cf_j(_jax_tree(_latents(cf_j, 6))))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    p_t = jt.from_numpy(lat)
    _close(lh_t(p_t), lh_j(_jax_tree(lat)))
    want = lh_j.metric(_jax_tree(lat), _jax_tree(tan))
    _close_tree(lh_t.metric(p_t, jt.from_numpy(tan)), want)
    _close_tree(lh_t.metric_at(p_t)(jt.from_numpy(tan)), want)
    _close(lh_t.right_sqrt_metric(p_t, jt.from_numpy(tan)),
           lh_j.right_sqrt_metric(_jax_tree(lat), _jax_tree(tan)))
    _close_tree(lh_t.left_sqrt_metric(p_t, torch.from_numpy(data)),
                lh_j.left_sqrt_metric(_jax_tree(lat), jnp.asarray(data)))
    _close(lh_t.normalized_residual(p_t), lh_j.normalized_residual(_jax_tree(lat)))


@pytest.mark.parametrize("dims,n_bins", [((32, 32), None), ((48, 40), 12)])
def test_quarter_route_matches_full_map(monkeypatch, dims, n_bins):
    full = build(jt, dims, n_bins)
    monkeypatch.setattr(tcf.CorrelatedFieldMaker, "QUARTER_MIN_ENTRIES", 1)
    quarter = build(jt, dims, n_bins)
    assert quarter.use_quarter and not full.use_quarter
    assert quarter.dist.shape == tuple(n // 2 + 1 for n in dims)
    rng = np.random.default_rng(8)
    lat = {k: rng.standard_normal(v.shape) for k, v in full.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in full.domain.items()}
    p = jt.from_numpy(lat)
    _close(quarter(p), full(p), 1e-13)
    _, fwd_q, bwd_q = linearize(quarter, p)
    _, fwd_f, bwd_f = linearize(full, p)
    ct = torch.from_numpy(rng.standard_normal(dims))
    _close(fwd_q(jt.from_numpy(tan)), fwd_f(jt.from_numpy(tan)).numpy(), 1e-12)
    _close_tree(bwd_q(ct), {k: v.numpy() for k, v in bwd_f(ct).items()}, 1e-12)


def test_stacked_latents_evaluate_each_sample(fields):
    """A leading sample axis on every latent evaluates the field per sample
    (the KL stage's stacked path)."""
    cf_j, cf_t = fields
    lats = [_latents(cf_j, s) for s in (12, 13, 14)]
    stacked = cf_t(jt.from_numpy({k: np.stack([lat[k] for lat in lats]) for k in lats[0]}))
    for i, lat in enumerate(lats):
        _close(stacked[i], cf_j(_jax_tree(lat)))


def test_integrated_wiener_process_matches_jax():
    rng = np.random.default_rng(11)
    xi = rng.standard_normal((20, 2))
    x0 = rng.standard_normal(2)
    dt = rng.uniform(0.1, 1.0, 20)
    want = jgm.integrated_wiener_process(jnp.asarray(xi), jnp.asarray(x0), 0.7, jnp.asarray(dt),
                                         asperity=0.3)
    got = tgm.integrated_wiener_process(torch.from_numpy(xi), torch.from_numpy(x0), 0.7,
                                        torch.from_numpy(dt), asperity=0.3)
    _close(got, want, 1e-14)
    iwp_t = tgm.IntegratedWienerProcess((0.0, 1.0), (1.0, 0.5), dt, name="w", asperity=(0.5, 0.1))
    iwp_j = jgm.IntegratedWienerProcess((0.0, 1.0), (1.0, 0.5), jnp.asarray(dt), name="w",
                                        asperity=(0.5, 0.1))
    assert sorted(iwp_t.domain) == sorted(iwp_j.domain)
    lat = {k: rng.standard_normal(v.shape) for k, v in iwp_j.domain.items()}
    _close(iwp_t(jt.from_numpy(lat)), iwp_j(_jax_tree(lat)), 1e-14)


def test_field_buffers_move_with_the_module():
    cf = build(jt, (16, 16))
    names = {n for n, _ in cf.named_buffers()}
    assert {"dists.0.idx", "dists.0.perm", "dists.0.offsets", "amplitudes.0.log_k_rel"} <= names
    moved = cf.to(torch.float32)  # floating buffers follow .to(); index maps stay int
    assert moved.dist.idx.dtype == torch.int32
    assert moved.amplitude.log_k_rel.dtype == torch.float32


def test_chunked_cumsum_matches_torch_cumsum():
    """Axes above the chunk length are scanned in rows (for bits that repeat
    on the card); same sums as ``torch.cumsum`` to rounding (1e-13 of the
    largest partial sum), same gradient, and the same bits for short axes."""
    rng = np.random.default_rng(5)
    chunk = tgm._SCAN_CHUNK
    for shape in [(chunk,), (chunk + 1,), (3 * chunk,), (2, 5 * chunk + 17), (chunk * chunk + 3,)]:
        x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
        got, want = tgm._cumsum(x), torch.cumsum(x, -1)
        assert got.shape == want.shape
        scale = float(want.abs().max())
        if shape[-1] <= chunk:
            assert torch.equal(got, want)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-13 * scale)
        w = torch.from_numpy(rng.standard_normal(shape))
        g_got, = torch.autograd.grad((got * w).sum(), x)
        g_want, = torch.autograd.grad((want * w).sum(), x)
        torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-13 * float(g_want.abs().max()))
