"""The port's float32 precision policy (``config.update("enable_x64",
False)``) against the JAX package with ``jax_enable_x64`` off.

Both packages take the same float32 numpy inputs, made from a seed:

- the correlated field (32^2 with 16 log bins, 16^2 unbinned): forward,
  jvp, vjp and the Gaussian's energy within 1e-5 of the largest entry
  (measured on a CPU: at most 3.6e-6, the
  vjp), the Gaussian-amended metric matvec within 1e-4 (measured 7.1e-5);
- the distributor against the JAX package's Pallas bodies in interpret
  mode (the select loop on the 32^2 binned map, the one-hot chunks on the
  1621-bin 128^2 map): the gather bit for bit, the segment sum within 1e-5
  of the largest sum of |cotangent| (measured 6.2e-8);
- every likelihood case of ``test_torch_likelihoods.py`` within 1e-5
  (measured 3.1e-6), and a 5-step CG solve of the geoVI draw's curvature
  within 1e-4 (measured 2.8e-5).

A dispatch mode records the dtype of every tensor that a forward, a
metric matvec, one ``OptimizeVI.update`` and an ``optimize_kl`` run with a
checkpoint and its resume produce: none is float64 or complex128 under
float32, none float32 or complex64 by default.  The port of
``test_f32_acceptance.py`` runs at that test's own configuration (64^2, 4
iterations, 2 pairs) on its criteria, with the run that ``chip_smoke.py``'s
phase 43 makes on the card.
"""

import importlib
import logging
from collections import Counter

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.ops import pallas_gather as pg  # noqa: E402
from nifty_tpu.solvers.cg import _static_cg as j_cg  # noqa: E402
from nifty_tpu_torch import config  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.models import correlated_field as tcf  # noqa: E402
from nifty_tpu_torch.ops import bin_gather as bg  # noqa: E402
from nifty_tpu_torch.solvers.cg import _static_cg as t_cg  # noqa: E402
from test_torch_likelihoods import CASES, _like, _tangents  # noqa: E402

import chip_smoke  # noqa: E402

sample_io = importlib.import_module("nifty_tpu_torch.sample_io")

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

FIELD_RTOL = 1e-5
METRIC_RTOL = 1e-4
NOISE_STD = 0.1
SHORT = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


@pytest.fixture
def f32():
    """x64 off in both packages for one test, restored afterwards."""
    x64_before = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    config.update("enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", x64_before)
        config.update("enable_x64", True)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol):
    gl, wl = jt.tree.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.max(np.abs(w)), 1e-30))


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


def _latents(domain, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in sorted(domain.items())}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


FIELDS = {"32sq_16bins": ((32, 32), 16), "16sq_unbinned": ((16, 16), None)}


@pytest.mark.parametrize("name", FIELDS)
def test_field_and_metric_match_jax_in_float32(f32, name):
    dims, n_bins = FIELDS[name]
    cf_j, cf_t = build(jft, dims, n_bins), build(jt, dims, n_bins)
    lat, tan = _latents(cf_j.domain, 0), _latents(cf_j.domain, 1)
    ct = np.random.default_rng(2).standard_normal(dims).astype(np.float32)
    p_t = jt.from_numpy(lat)
    assert all(v.dtype == torch.float32 for v in p_t.values())

    # the JAX side jitted: eager JAX runs op by op
    pj, tj = _jax_tree(lat), _jax_tree(tan)
    field = cf_t(p_t)
    assert field.dtype == torch.float32
    _close(field, jax.jit(cf_j)(pj), FIELD_RTOL)
    tan_j = jax.jit(lambda p, t: jax.jvp(cf_j, (p,), (t,))[1])(pj, tj)
    cot_j = jax.jit(lambda p, c: jax.vjp(cf_j, p)[1](c)[0])(pj, jnp.asarray(ct))
    _, fwd, bwd = linearize(cf_t, p_t)
    _close(fwd(jt.from_numpy(tan)), tan_j, FIELD_RTOL)
    _close(bwd(torch.from_numpy(ct)), cot_j, FIELD_RTOL)

    data = np.array(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 3))))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2
                       ).amend(cf_t)
    _close(lh_t(p_t), jax.jit(lh_j)(pj), FIELD_RTOL)
    _close(lh_t.metric(p_t, jt.from_numpy(tan)), jax.jit(lh_j.metric)(pj, tj), METRIC_RTOL)


# map -> (shape, n_bins, the JAX package's kernel pair)
MAPS = {"32sq_16bins": ((32, 32), 16, "select loop"), "128sq_unbinned": ((128, 128), None, "mxu")}


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("name", MAPS)
def test_distributor_matches_pallas_interpret_in_float32(f32, monkeypatch, name, rows):
    """K1/K2 (select loop) and K3/K4 (one-hot chunks) of
    ``nifty_tpu.ops.pallas_gather`` in interpret mode, float32, as
    ``tests/test_pallas_gather.py`` runs them, against the port's
    distributor on the same tables and cotangents."""
    shape, n_bins, kind = MAPS[name]
    hg = tcf.make_grid(shape, 1.0 / shape[0], n_bins=n_bins).harmonic_grid
    idx = np.asarray(hg.power_distributor).ravel()
    nb = np.asarray(hg.mode_lengths).size
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, nb)).astype(np.float32)
    cot = rng.standard_normal((rows, idx.size)).astype(np.float32)

    monkeypatch.setattr(pg, "_INTERPRET", True)
    if kind == "mxu":
        assert pg._use_mxu(nb, idx.size, jnp.float32, False)
    else:
        assert not pg._use_mxu(nb, idx.size, jnp.float32, False)
        assert pg._use_pallas(nb, rows, jnp.float32)
        assert nb <= (pg.SCATTER_MAX_BINS if rows > 1 else pg.WIDE_TABLE_MAX_BINS)
    got_j = np.asarray(pg.bin_gather_p.bind(jnp.asarray(table), jnp.asarray(idx)))
    sum_j = np.asarray(pg.bin_scatter_p.bind(jnp.asarray(cot), jnp.asarray(idx), nb=nb))
    monkeypatch.setattr(pg, "_INTERPRET", False)

    dist = bg.BinIndex(idx, nb=nb)
    got_t = bg.bin_gather(torch.from_numpy(table), dist)
    sum_t = bg.bin_segment_sum(torch.from_numpy(cot), dist)
    assert got_t.dtype == sum_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), got_j)
    scale = bg.bin_segment_sum_plain(torch.from_numpy(np.abs(cot)), dist.perm, dist.offsets)
    np.testing.assert_allclose(sum_t.numpy(), sum_j, rtol=0,
                               atol=FIELD_RTOL * float(scale.max()))


@pytest.mark.parametrize("batch", [(), (2,)], ids=["one", "B2"])
@pytest.mark.parametrize("case", CASES)
def test_likelihood_matches_jax_in_float32(f32, case, batch):
    """``test_torch_likelihoods.py``'s cases with x64 off: the float64
    numpy data and inputs become float32 in both packages."""
    make_j, make_t, primals = CASES[case]
    lh_j, lh_t = make_j(), make_t()
    rng = np.random.default_rng(1)
    p = primals(rng, lh_t.domain, batch)
    t = _tangents(rng, p)
    u = _like(rng, lh_t.lsm_tangents_shape, batch)
    pj, tj, uj = (jax.tree_util.tree_map(jnp.asarray, x) for x in (p, t, u))
    pt, tt, ut = jt.from_numpy(p), jt.from_numpy(t), jt.from_numpy(u)
    for leaf in jt.tree.tree_leaves((pt, tt, ut)):
        assert leaf.dtype in (torch.float32, torch.complex64)

    def jx(method, *args):
        fn = getattr(lh_j, method)
        return jax.vmap(fn)(*args) if batch else fn(*args)

    e_j = jx("energy", pj)
    _close(lh_t.energy(pt), jnp.sum(e_j) if batch else e_j, FIELD_RTOL)
    _close(lh_t.metric(pt, tt), jx("metric", pj, tj), FIELD_RTOL)
    _close(lh_t.left_sqrt_metric(pt, ut), jx("left_sqrt_metric", pj, uj), FIELD_RTOL)
    _close(lh_t.right_sqrt_metric(pt, tt), jx("right_sqrt_metric", pj, tj), FIELD_RTOL)


def test_cg_solve_matches_jax_in_float32(f32):
    """Five CG steps on the geoVI draw's curvature ``M + 1`` of the 32^2
    binned field's Gaussian likelihood."""
    cf_j, cf_t = build(jft, (32, 32), 16), build(jt, (32, 32), 16)
    lat, rhs = _latents(cf_j.domain, 4), _latents(cf_j.domain, 5)
    data = np.array(jax.jit(cf_j)(_jax_tree(_latents(cf_j.domain, 6))))
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2
                       ).amend(cf_t)
    pj, pt = _jax_tree(lat), jt.from_numpy(lat)
    met_t = lh_t.metric_at(pt)
    met_j = jax.jit(lh_j.metric)
    rj = j_cg(lambda x: jax.tree_util.tree_map(jnp.add, met_j(pj, x), x), _jax_tree(rhs),
              maxiter=5)
    rt = t_cg(lambda x: jt.tree.tree_add(met_t(x), x), jt.from_numpy(rhs), maxiter=5)
    assert (rt.nit, rt.info) == (int(rj.nit), int(rj.info))
    _close(rt.x, rj.x, METRIC_RTOL)


class _Dtypes(TorchDispatchMode):
    """The dtype of every tensor an aten operation returns (autograd's
    backward, ``torch.func`` transforms and in-place updates included),
    with the operation that first made each."""

    def __init__(self):
        super().__init__()
        self.seen, self.first = Counter(), {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in torch.utils._pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self.seen[o.dtype] += 1
                self.first.setdefault(o.dtype, str(func))
        return out


MODES = {"float32": (False, (torch.float64, torch.complex128)),
         "default": (True, (torch.float32, torch.complex64))}


@pytest.mark.parametrize("mode", MODES)
def test_main_path_makes_no_tensor_of_the_other_precision(mode, tmp_path):
    """A forward, a metric matvec, one lockstep ``OptimizeVI.update`` and an
    ``optimize_kl`` run of two iterations with a checkpoint (its minisanity
    report included), then a third resumed from it: no tensor of the other
    precision, and the checkpoint keeps the run's own."""
    x64, other = MODES[mode]
    own = torch.float64 if x64 else torch.float32
    config.update("enable_x64", x64)
    try:
        rec = _Dtypes()
        with rec:
            cf = build(jt, (32, 32), 16)
            data = cf(jt.random_like(3, cf.domain)).detach()
            lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf)
            pos = jt.random_like(1, lh.domain)
            field = cf(pos)
            met = lh.metric(pos, jt.random_like(2, lh.domain))
            opt = jt.OptimizeVI(lh, 1, residual_map="vmap")
            smp, st = opt.update(jt.Samples(pos=pos), opt.init_state(jt.HostKey(0), **SHORT))
            kw = dict(key=jt.HostKey(5), odir=str(tmp_path), plot_energy_history=False, **SHORT)
            jt.optimize_kl(lh, pos, n_total_iterations=2, **kw)
            resumed, st3 = jt.optimize_kl(lh, None, n_total_iterations=3, resume=True, **kw)
        stored, _ = sample_io.load_checkpoint(str(tmp_path / "last.pkl"))
    finally:
        config.update("enable_x64", True)
    bad = {str(d): rec.first[d] for d in other if rec.seen[d]}
    assert not bad, f"tensors of the other precision, with the first operation making each: {bad}"
    assert rec.seen[own] > 0
    assert field.dtype == own and float(st.minimization_state.fun) > 0 and st3.nit == 3
    for tree in (met, smp.pos, smp._samples, resumed.pos, resumed._samples, stored.pos,
                 stored._samples):
        assert {x.dtype for x in jt.tree.tree_leaves(tree)} == {own}


def test_a_model_keeps_the_dtype_it_was_built_with():
    """The dtype in force when a model is built is its own: its buffers,
    its domain, the draws shaped like it; called under the other setting
    it computes in its own dtype.  ``from_numpy`` keeps float32 under the
    default and narrows float64 under float32."""
    wide = build(jt, (16, 16))
    config.update("enable_x64", False)
    try:
        narrow = build(jt, (16, 16))
        assert config.default_float_dtype() == torch.float32
        assert config.default_complex_dtype() == torch.complex64
        assert jt.from_numpy(np.ones(3)).dtype == torch.float32
        assert jt.Gaussian(np.zeros(3)).data.dtype == torch.float32
        wide_out = wide(jt.random_like(0, wide.domain))
    finally:
        config.update("enable_x64", True)
    narrow_out = narrow(jt.random_like(0, narrow.domain))
    assert jt.from_numpy(np.ones(3, np.float32)).dtype == torch.float32
    assert {v.dtype for v in narrow.domain.values()} == {torch.float32}
    assert narrow.amplitude.log_k_rel.dtype == narrow.amplitude.multiplicity.dtype == torch.float32
    assert wide.amplitude.log_k_rel.dtype == torch.float64
    assert (narrow_out.dtype, wide_out.dtype) == (torch.float32, torch.float64)


def test_f32_posterior_statistically_matches_f64():
    """The criteria of ``test_f32_acceptance.py`` (``chip_smoke.acceptance_check``),
    on the CPU, through the run of ``chip_smoke.py``'s phase 43: the float32
    posterior recovers the truth within 10 % of the float64 one's rms
    error, and the posterior means agree within the mean float64 posterior
    std."""
    store = {}
    try:
        m64, s64, *_ = chip_smoke.acceptance_run(jt, True, store)
        m32, *_ = chip_smoke.acceptance_run(jt, False, store)
    finally:
        config.update("enable_x64", True)
    chip_smoke.acceptance_check(store["truth"], m64, s64, m32)
