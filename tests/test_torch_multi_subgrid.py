"""Parity of the port's correlated field on several subgrids with
``nifty_tpu``: Matern amplitudes, ``total_N`` / ``dofdex`` batching, the
maker's read-outs, ``SimpleCorrelatedField``, ``adjust_variances``, the
``hartley_fn`` hook, ``transform_compute_dtype`` and one geoVI update.

The same numpy latents go through both packages in float64.  Tolerances:
1e-10 relative to the largest entry for the field, its jvp and vjp and
the Gaussian metric (FFT libraries and summation orders differ by
~1e-15); 1e-12 where a read-out is a few scalar operations; 1e-5 for the
float32 transform (float32 rounding of two FFT libraries); 1e-6 for a
whole update with short solver budgets (CG 5 steps), as
``tests/test_torch_optimize_kl.py`` explains; 3 % for two Monte Carlo
estimates from different generators at 20,000 draws (their standard
error is about 0.3 %).
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import stats as jstats  # noqa: E402
from nifty_tpu.models import correlated_field as jcf  # noqa: E402
from nifty_tpu_torch import stats as tstats  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.models import correlated_field as tcf  # noqa: E402
from nifty_tpu_torch.ops.harmonic import hartley_via_c2c  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-10
NOISE_STD = 0.2


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _space(cfm, shape=(32, 32)):
    cfm.add_fluctuations(
        shape, distances=1.0 / shape[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1.0, 5e-1), asperity=(5e-1, 5e-2),
        prefix="space",
    )


def _freq(cfm, n=8, prefix="freq"):
    cfm.add_fluctuations(
        (n,), distances=1.0 / n, fluctuations=(5e-1, 2e-1), loglogavgslope=(-4.0, 2e-1),
        prefix=prefix,
    )


def _matern(cfm, shape=(8,), **kw):
    cfm.add_fluctuations_matern(
        shape, distances=1.0 / shape[0], scale=(5e-1, 2e-1), cutoff=(2.0, 1.0),
        loglogslope=(-3.0, 5e-1), prefix="matern", **kw,
    )


def _three_lines(cfm):
    cfm.add_fluctuations((16,), 1.0 / 16, (1.0, 5e-1), (-3.0, 2e-1), (1.0, 5e-1),
                         (5e-1, 5e-2), prefix="a")
    _freq(cfm, 8, prefix="b")
    _freq(cfm, 4, prefix="c")


# each config: the subgrids its maker adds, in order
SUBGRIDS = {
    "32sq_x_8": lambda cfm: (_space(cfm), _freq(cfm)),
    "16_8_4": _three_lines,
    "32sq_x_matern8": lambda cfm: (_space(cfm), _matern(cfm, renormalize_amplitude=True)),
}
BATCHING = {"one_field": {}, "total_N3": dict(total_N=3, dofdex=[0, 0, 1])}


def make(mod, config, **finalize_kw):
    cfm = mod.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
    SUBGRIDS[config](cfm)
    return cfm, cfm.finalize(**finalize_kw)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _close_tree(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol)


def _latents(domain, seed, stack=None):
    """numpy latents of ``domain``, with a leading sample axis of ``stack``."""
    rng = np.random.default_rng(seed)
    lead = () if stack is None else (stack,)
    return {k: rng.standard_normal(lead + tuple(v.shape)) for k, v in domain.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module", params=[(c, b) for c in SUBGRIDS for b in BATCHING],
                ids=[f"{c}-{b}" for c in SUBGRIDS for b in BATCHING])
def fields(request):
    config, batching = request.param
    return make(jft, config, **BATCHING[batching])[1], make(jt, config, **BATCHING[batching])[1]


def test_domain_and_shapes_match(fields):
    cf_j, cf_t = fields
    assert list(cf_t.domain) == list(cf_j.domain)
    for k in cf_j.domain:
        assert cf_t.domain[k].shape == tuple(cf_j.domain[k].shape)
    init = cf_t.init(3)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in cf_j.domain.items()}
    assert tuple(cf_t(init).shape) == tuple(cf_j.target.shape)
    assert len(cf_t.dists) == len(cf_j.target_grids)


@pytest.mark.parametrize("stack", [None, 2], ids=["unstacked", "stacked2"])
def test_field_jvp_and_vjp_match(fields, stack):
    """Forward, jvp and vjp; with ``stack`` every latent has a leading
    sample axis of 2 (against the JAX field vmapped over it), which with
    ``total_N`` stands before the field axis."""
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j.domain, 1, stack), _latents(cf_j.domain, 2, stack)
    out_shape = tuple(cf_j.target.shape) if stack is None else (stack,) + tuple(cf_j.target.shape)
    ct = np.random.default_rng(3).standard_normal(out_shape)
    f_j = cf_j if stack is None else jax.vmap(cf_j)
    want, tan_j = jax.jit(lambda p, t: jax.jvp(f_j, (p,), (t,)))(_jax_tree(lat), _jax_tree(tan))
    (cot_j,) = jax.jit(lambda p, c: jax.vjp(f_j, p)[1](c))(_jax_tree(lat), jnp.asarray(ct))
    got, fwd, bwd = linearize(cf_t, jt.from_numpy(lat))
    _close(got, want)
    _close(fwd(jt.from_numpy(tan)), tan_j)
    _close_tree(bwd(torch.from_numpy(ct)), cot_j)


@pytest.mark.parametrize("stack", [None, 2], ids=["unstacked", "stacked2"])
def test_gaussian_metric_matches(fields, stack):
    cf_j, cf_t = fields
    lat, tan = _latents(cf_j.domain, 4, stack), _latents(cf_j.domain, 5, stack)
    data = np.array(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 6))))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data),
                       noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    metric_j = jax.jit(lh_j.metric if stack is None else jax.vmap(lh_j.metric))
    _close_tree(lh_t.metric(jt.from_numpy(lat), jt.from_numpy(tan)),
                metric_j(_jax_tree(lat), _jax_tree(tan)))
    if stack is None:
        _close(lh_t(jt.from_numpy(lat)), jax.jit(lh_j)(_jax_tree(lat)))


def test_one_distributor_call_a_subgrid_for_all_samples_and_fields(monkeypatch):
    """The tables of every sample and field go to one distributor call per
    subgrid: rows = samples x total_N; the dofdex gather is on the set
    axis, after the sample axis."""
    calls, distribute_power = [], tcf.distribute_power

    def recording(table, dist):
        calls.append((tuple(table.shape), dist.shape))
        return distribute_power(table, dist)

    monkeypatch.setattr(tcf, "distribute_power", recording)
    _, cf = make(jt, "32sq_x_8", total_N=3, dofdex=[0, 0, 1])
    lat = jt.from_numpy(_latents(cf.domain, 7, stack=4))
    out = cf(lat)
    assert tuple(out.shape) == (4, 3, 32, 32, 8)
    assert [(t[:2], d) for t, d in calls] == [((4, 3), (32, 32)), ((4, 3), (8,))]
    # field 1 shares field 0's parameters, field 2 has set 1's: with equal
    # excitations fields 0 and 1 agree and field 2 differs
    lat["mfxi"] = lat["mfxi"][:, :1].expand(4, 3, 32, 32, 8)
    out = cf(lat)
    assert torch.equal(out[:, 0], out[:, 1]) and not torch.allclose(out[:, 0], out[:, 2])
    with pytest.raises(ValueError, match="len\\(dofdex\\)"):
        make(jt, "32sq_x_8", total_N=3, dofdex=[0, 1])


def test_quarter_route_is_chosen_per_subgrid(monkeypatch):
    full = make(jt, "32sq_x_8")[1]
    monkeypatch.setattr(tcf.CorrelatedFieldMaker, "QUARTER_MIN_ENTRIES", 100)
    mixed = make(jt, "32sq_x_8")[1]
    assert mixed.use_quarters == (True, False) and full.use_quarters == (False, False)
    assert [d.shape for d in mixed.dists] == [(17, 17), (8,)]
    p = jt.from_numpy(_latents(full.domain, 8, stack=2))
    _close(mixed(p), full(p).numpy(), 1e-13)
    with pytest.raises(ValueError, match="2 subgrids"):
        mixed.dist  # noqa: B018


def test_hartley_fn_hook_gets_each_subgrids_axes():
    seen = []

    def hartley_fn(x, axes):
        seen.append(tuple(axes))
        return hartley_via_c2c(x, axes=axes)

    _, cf_hook = make(jt, "32sq_x_8", hartley_fn=hartley_fn)
    _, cf = make(jt, "32sq_x_8")
    p = jt.from_numpy(_latents(cf.domain, 9, stack=2))
    _close(cf_hook(p), cf(p).numpy(), 1e-12)
    assert seen == [(1, 2), (3,)]


@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("kind", ["amplitude", "power"])
def test_matern_amplitude_matches(renormalize, kind):
    """Values, domains and init rules: unlike the non-parametric
    amplitude's parts, the Matern parts are ``WrappedCall``s without
    ``white_init`` (their init rule comes from the domain when asked)."""
    grid_j = jcf.make_grid((16, 16), 1.0 / 16)
    grid_t = tcf.make_grid((16, 16), 1.0 / 16)
    kw = dict(renormalize_amplitude=renormalize, prefix="m", kind=kind)
    args_j = (jstats.lognormal_prior(0.5, 0.2), jstats.lognormal_prior(2.0, 1.0),
              jstats.normal_prior(-3.0, 0.5))
    args_t = (tstats.lognormal_prior(0.5, 0.2), tstats.lognormal_prior(2.0, 1.0),
              tstats.normal_prior(-3.0, 0.5))
    m_j = jcf.matern_amplitude(grid_j, *args_j, **kw)
    m_t = tcf.matern_amplitude(grid_t, *args_t, **kw)
    assert list(m_t.domain) == list(m_j.domain) == ["mscale", "mcutoff", "mloglogslope"]
    assert m_t.init.opaque and m_j.init.opaque
    for part in (m_t.fluctuation_amplitude, m_t.cutoff, m_t.loglogslope):
        assert part._init is jt.model.NoValue and not part.init.opaque
    assert m_j.fluctuation_amplitude._init is jft.model.NoValue
    lat = _latents(m_j.domain, 10)
    _close(m_t(jt.from_numpy(lat)), m_j(_jax_tree(lat)), 1e-12)
    stacked = _latents(m_j.domain, 11, stack=3)
    _close(m_t(jt.from_numpy(stacked)), jax.vmap(m_j)(_jax_tree(stacked)), 1e-12)
    with pytest.raises(ValueError, match="invalid kind"):
        tcf.matern_amplitude(grid_t, *args_t, kind="spectrum")


@pytest.mark.parametrize("config", ["32sq_x_8", "32sq_x_matern8"])
def test_readouts_match(config):
    (m_j, _), (m_t, _) = make(jft, config), make(jt, config)
    lat = _latents(m_j._parameter_tree, 12, stack=3)
    p_j, p_t = _jax_tree(lat), jt.from_numpy(lat)
    for a_j, a_t in zip(m_j.get_normalized_amplitudes(), m_t.get_normalized_amplitudes()):
        _close(a_t(p_t), jax.vmap(a_j)(p_j), 1e-12)
    for f_j, f_t in zip(m_j.fluctuation_amplitudes(), m_t.fluctuation_amplitudes()):
        _close(f_t(p_t), f_j(p_j), 1e-12)
    _close(m_t.total_fluctuation()(p_t), m_j.total_fluctuation()(p_j), 1e-12)
    for space in (0, 1):
        _close(m_t.average_fluctuation(space)(p_t), m_j.average_fluctuation(space)(p_j), 1e-12)
        _close(m_t.slice_fluctuation(space)(p_t), m_j.slice_fluctuation(space)(p_j), 1e-12)
    for m in (m_j, m_t):
        with pytest.raises(NotImplementedError):
            m.amplitude  # noqa: B018
        with pytest.raises(ValueError):
            m.slice_fluctuation(2)
    samples = np.random.default_rng(13).standard_normal((5, 32, 32, 8))
    sub_axes = [(0, 1), (2,)]
    statics = (("total_fluctuation_realized", (samples,)),
               ("average_fluctuation_realized", (samples, sub_axes, 0)),
               ("average_fluctuation_realized", (samples, sub_axes, 1)),
               ("slice_fluctuation_realized", (samples, sub_axes, 1)))
    for name, args in statics:
        got = getattr(tcf.CorrelatedFieldMaker, name)(
            *((torch.from_numpy(args[0]),) + args[1:]))
        want = getattr(jcf.CorrelatedFieldMaker, name)(*((jnp.asarray(args[0]),) + args[1:]))
        assert abs(got - want) <= 1e-12 * abs(want)


def test_simple_correlated_field_and_one_subgrid_readouts():
    kw = dict(offset_mean=0.3, offset_std=(1e-1, 1e-2), fluctuations=(1.0, 0.5),
              loglogavgslope=(-3.0, 0.5), flexibility=(1.0, 0.5), asperity=(0.3, 0.1))
    cf_j = jft.SimpleCorrelatedField((24, 20), 1.0 / 24, **kw)
    cf_t = jt.SimpleCorrelatedField((24, 20), 1.0 / 24, **kw)
    assert list(cf_t.domain) == list(cf_j.domain)
    lat = _latents(cf_j.domain, 14)
    p_j, p_t = _jax_tree(lat), jt.from_numpy(lat)
    _close(cf_t(p_t), jax.jit(cf_j)(p_j))
    m_j, m_t = cf_j.maker, cf_t.maker
    _close(m_t.amplitude(p_t), m_j.amplitude(p_j), 1e-12)
    _close(m_t.power_spectrum(p_t), m_j.power_spectrum(p_j), 1e-12)
    _close(m_t.total_fluctuation()(p_t), m_j.total_fluctuation()(p_j), 1e-12)
    _close(m_t.slice_fluctuation(0)(p_t), m_j.slice_fluctuation(0)(p_j), 1e-12)


def _one_subgrid(mod):
    cfm = mod.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
    _space(cfm)
    return cfm, cfm.finalize()


def test_adjust_variances_leaves_the_field_unchanged():
    (m_j, cf_j), (m_t, cf_t) = _one_subgrid(jft), _one_subgrid(jt)
    lat = _latents(cf_j.domain, 15)
    lat["mfxi"] = 2.7 * lat["mfxi"]
    adj_j = jcf.adjust_variances(_jax_tree(lat), m_j)
    adj_t = tcf.adjust_variances(jt.from_numpy(lat), m_t)
    _close_tree(adj_t, adj_j, 1e-12)
    _close(cf_t(adj_t), cf_t(jt.from_numpy(lat)).numpy(), 1e-12)
    assert abs(float(torch.sqrt(torch.mean(adj_t["mfxi"] ** 2))) - 1.0) < 0.1
    matern = make(jt, "32sq_x_matern8")[0]
    with pytest.raises(ValueError, match="fluctuations"):
        tcf.adjust_variances(jt.from_numpy(lat), matern, space=1)


def test_moment_slice_to_average():
    """The port's estimate is the formula on its own draws (a generator of
    the same seed replays them) and agrees with the reference's estimate
    from JAX's draws within 3 % at 20,000 draws."""
    (m_j, _), (m_t, _) = make(jft, "32sq_x_8"), make(jt, "32sq_x_8")
    n = 20000
    got = m_t.moment_slice_to_average(0.7, key=torch.Generator().manual_seed(5), nsamples=n)
    gen = torch.Generator().manual_seed(5)
    scm = np.ones(n)
    for npa in m_t.fluctuations:
        dom = {**npa.fluctuation_amplitude.domain, "mfzeromode": jt.ShapeWithDtype(())}
        draws = jt.random_like(gen, {k: jt.ShapeWithDtype((n,)) for k in dom}, device="cpu")
        flu_key = next(k for k in draws if k != "mfzeromode")
        mean, std = (1.0, 5e-1) if flu_key.startswith("mfspace") else (5e-1, 2e-1)
        log_mean, log_std = tstats.lognormal_moments(mean, std)
        zm_mean, zm_std = tstats.lognormal_moments(1e-1, 3e-2)
        flu = np.exp(log_mean + log_std * draws[flu_key].numpy())
        zm = np.exp(zm_mean + zm_std * draws["mfzeromode"].numpy())
        scm = scm * ((flu / zm) ** 2 + 1.0)
    assert abs(got - 0.7 / np.mean(np.sqrt(scm))) <= 1e-12 * got
    want = m_j.moment_slice_to_average(0.7, key=jax.random.PRNGKey(5), nsamples=n)
    assert abs(got - want) <= 0.03 * want
    with pytest.raises(ValueError):
        m_t.moment_slice_to_average(-1.0)


@pytest.mark.parametrize("config", ["one_subgrid", "32sq_x_8"])
def test_transform_compute_dtype_float32(config):
    """With the transform in float32 the field and its jvp and vjp match
    the JAX package's under the same key, to float32 rounding."""
    def build(mod):
        return (make(mod, config) if config == "32sq_x_8" else _one_subgrid(mod))[1]

    cf_j, cf_t = build(jft), build(jt)
    lat, tan = _latents(cf_j.domain, 16), _latents(cf_j.domain, 17)
    ct = np.random.default_rng(18).standard_normal(cf_j.target.shape)
    olds = jft.config.get("transform_compute_dtype"), jt.config.get("transform_compute_dtype")
    try:
        jft.config.update("transform_compute_dtype", "float32")
        jt.config.update("transform_compute_dtype", "float32")
        want, tan_j = jax.jit(lambda p, t: jax.jvp(cf_j, (p,), (t,)))(
            _jax_tree(lat), _jax_tree(tan))
        (cot_j,) = jax.jit(lambda p, c: jax.vjp(cf_j, p)[1](c))(_jax_tree(lat), jnp.asarray(ct))
        got, fwd, bwd = linearize(cf_t, jt.from_numpy(lat))
        assert got.dtype == torch.float64
        _close(got, want, 1e-5)
        _close(fwd(jt.from_numpy(tan)), tan_j, 1e-5)
        _close_tree(bwd(torch.from_numpy(ct)), cot_j, 1e-5)
    finally:
        jft.config.update("transform_compute_dtype", olds[0])
        jt.config.update("transform_compute_dtype", olds[1])
    # the float32 transform is visible against the float64 field
    full = cf_t(jt.from_numpy(lat)).numpy()
    assert 1e-12 < np.max(np.abs(full - np.asarray(want))) / np.max(np.abs(full)) < 1e-5


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG (as in
    ``tests/test_torch_optimize_kl.py``)."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        struct = jax.tree_util.tree_map(
            lambda v: jax.ShapeDtypeStruct(tuple(v.shape), np.float64), primals,
            is_leaf=lambda v: isinstance(v, jt.ShapeWithDtype))
        out = jft.random_like(self.key, struct)
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


def test_geovi_update_of_two_subgrids_with_total_n_matches_jax():
    """One whole update (CG 5) of a two-subgrid field with ``total_N``:
    the lockstep stages' rows are samples, each holding all the fields."""
    short = dict(
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
        sample_mode="nonlinear_resample",
    )

    def build(mod):
        cfm = mod.CorrelatedFieldMaker("mf")
        cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
        _space(cfm, (16, 16))
        _matern(cfm)
        return cfm.finalize(total_N=3, dofdex=[0, 0, 1])

    cf_j, cf_t = build(jft), build(jt)
    rng = np.random.default_rng(19)
    truth = np.array(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 20))))
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data),
                       noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    pos = _latents(cf_j.domain, 21)
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="vmap")
    smp_j = jft.Samples(pos=_jax_tree(pos), samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(7), **short))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map="vmap")
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(7)), **short))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_allclose(
        st_t.minimization_state.fun, float(st_j.minimization_state.fun), rtol=1e-6)
    _close_tree(smp_t.pos, smp_j.pos, 1e-6)
    _close_tree(smp_t._samples, smp_j._samples, 1e-6)
