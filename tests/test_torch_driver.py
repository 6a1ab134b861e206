"""The adaptive ``optimize_kl`` path of the port against ``nifty_tpu``: ``napprox``,
point estimates, minisanity, ``optimize_kl`` with ``odir``/``resume``,
sample files, unbinned grids on the quarter map, and the device default.

Inputs come from a numpy seed and the noise is replayed as the JAX run drew
it (a noise provider that splits, folds and draws with ``jax.random``).
Tolerances: 1e-8 of the largest entry for single stages with short solver
budgets (CG 5 steps; CG on this metric amplifies rounding differences by
orders of magnitude per step), 1e-6 for a whole update, 1e-10 for the
field and its derivatives, exact equality for files and resumed runs.
"""

import importlib
import importlib.util
import logging
import os

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.probing import approximation2endo as j_approximation2endo  # noqa: E402
from nifty_tpu_torch import evi as tevi  # noqa: E402
from nifty_tpu_torch import likelihood as tlh  # noqa: E402
from nifty_tpu_torch import sample_io as tio  # noqa: E402
from nifty_tpu_torch.models import correlated_field as tcf  # noqa: E402

# the packages export a function of the module's name
jms = importlib.import_module("nifty_tpu.minisanity")
tms = importlib.import_module("nifty_tpu_torch.minisanity")
tok = importlib.import_module("nifty_tpu_torch.optimize_kl")

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

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
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _jax_struct(tree):
    """A port tree of shapes or tensors as the JAX package's tree of
    ``ShapeDtypeStruct``s (dicts, tuples and ``Vector``s keep their kind)."""
    if isinstance(tree, jt.Vector):
        return jft.Vector(_jax_struct(tree.tree))
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jax_struct(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float64)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG: ``jax.random.split``,
    ``jax.random.fold_in`` and ``nifty_tpu.tree.random_like``."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def normal(self, primals, device=None):
        out = jft.random_like(self.key, _jax_struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


def build(mod, dims=(32, 32)):
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2),
    )
    return cfm.finalize()


def _problem(dims, seed=3):
    cf_j, cf_t = build(jft, dims), build(jt, dims)
    rng = np.random.default_rng(seed)
    lat = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    truth = np.asarray(cf_j({k: jnp.asarray(v) for k, v in lat.items()}))
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf_t)
    pos = {k: rng.standard_normal(v.shape) for k, v in cf_j.domain.items()}
    return lh_j, lh_t, pos


@pytest.fixture(scope="module")
def problem():
    return _problem((32, 32))


def _jpos(pos):
    return {k: jnp.asarray(v) for k, v in pos.items()}


def _close_tree(got, want, rtol):
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.max(np.abs(w)), 1e-300))


# -- (c) napprox ------------------------------------------------------------


def test_approximation2endo_matches_jax():
    rng = np.random.default_rng(0)
    probes = {"a": rng.standard_normal((5, 7)), "b": 1e-8 * rng.standard_normal((5, 2, 3))}
    got = jt.approximation2endo(jt.from_numpy(probes), eps=1e-12)
    want = j_approximation2endo({k: jnp.asarray(v) for k, v in probes.items()}, eps=1e-12)
    for k in probes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-14)
    assert float(got["b"].min()) == 1e-12  # clipped


def test_napprox_shares_the_samples_noise_and_preconditions(problem):
    """The preconditioner's keys are folded out of the sample's key, so the
    CG sees the same right-hand side and start with and without it."""
    _, lh_t, pos = problem
    seen = []

    def spy_cg(mat, j, x0=None, **kw):
        seen.append((j, x0, kw.get("preconditioner")))
        return x0, 0

    for key in (jt.HostKey(5), 5, torch.Generator().manual_seed(5)):
        seen.clear()
        for napprox in (0, 3):
            if isinstance(key, torch.Generator):
                key.manual_seed(5)
            jt.draw_linear_residual(lh_t, jt.from_numpy(pos), key, cg=spy_cg, napprox=napprox)
        (j0, x0, p0), (j1, x1, p1) = seen
        assert p0 is None and p1 is not None
        for k in pos:
            assert torch.equal(j0[k], j1[k]) and torch.equal(x0[k], x1[k])
        scaled = p1(j1)
        assert all(torch.isfinite(scaled[k]).all() for k in pos)
        assert not torch.equal(scaled["cfxi"], j1["cfxi"])


def test_napprox_draw_matches_jax(problem):
    lh_j, lh_t, pos = problem
    key = jax.random.PRNGKey(31)
    kw = dict(cg_kwargs=dict(maxiter=5), napprox=4)
    res_j, info_j = jft.draw_linear_residual(lh_j, _jpos(pos), key, **kw)
    res_t, info_t = jt.draw_linear_residual(lh_t, jt.from_numpy(pos), JaxKey(key), **kw)
    assert int(info_t) == int(info_j)
    _close_tree(jt.to_numpy(res_t), res_j, 1e-8)
    plain, _ = jt.draw_linear_residual(
        lh_t, jt.from_numpy(pos), JaxKey(key), cg_kwargs=dict(maxiter=5))
    assert not torch.allclose(plain["cfxi"], res_t["cfxi"], rtol=1e-6, atol=0)


def test_napprox_lockstep_draw_matches_vmapped_jax(problem):
    lh_j, lh_t, pos = problem
    keys = jax.random.split(jax.random.PRNGKey(32), 3)
    # three preconditioned steps: the diagonal's rounding is amplified
    # faster than the plain CG's
    kw = dict(cg_kwargs=dict(maxiter=3, absdelta=1e-3), napprox=4)
    res_j, info_j = jax.vmap(
        lambda k: jft.draw_linear_residual(lh_j, _jpos(pos), k, **kw))(keys)
    res_t, info_t = tevi.draw_linear_residuals(
        lh_t, jt.from_numpy(pos), [JaxKey(k) for k in keys], **kw)
    assert info_t.tolist() == np.asarray(info_j).astype(int).tolist()
    _close_tree(jt.to_numpy(res_t), res_j, 1e-8)


def test_fold_in_leaves_the_key_as_it_was():
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state().clone()
    k1, k2 = jt.tree.fold_in(gen, 7), jt.tree.fold_in(gen, 8)
    assert torch.equal(gen.get_state(), before) and k1 != k2
    assert jt.tree.fold_in(gen, 7) == k1
    assert jt.tree.fold_in(11, 1) != jt.tree.fold_in(11, 2) != jt.tree.split(11, 2)[0]
    assert jt.tree.fold_in(jt.HostKey(4), 2).seed == jt.tree.fold_in(4, 2)
    with pytest.raises(TypeError):
        class NoFold:
            split = normal = None

        jt.tree.fold_in(NoFold(), 1)


# -- (d) point estimates ----------------------------------------------------

FROZEN = ("cfzeromode", "cfloglogavgslope")


def test_freeze_insert_and_split(problem):
    _, lh_t, pos = problem
    p = jt.from_numpy(pos)
    same, live = lh_t.freeze(primals=p, point_estimates=())
    assert same is lh_t and live is p
    lp, liquid = lh_t.freeze(primals=p, point_estimates=FROZEN)
    assert isinstance(lp, tlh.LikelihoodPartial) and isinstance(liquid, jt.Vector)
    assert len(liquid.tree) == len(pos) - 2 and len(lp.primals_frozen) == 2
    back = lp.insert(liquid)
    assert sorted(back) == sorted(pos) and all(torch.equal(back[k], p[k]) for k in pos)
    zeros = lp.insert_zeros(liquid)
    assert all(float(zeros[k].abs().max()) == 0.0 for k in FROZEN)
    assert torch.equal(zeros["cfxi"], p["cfxi"])
    assert all(torch.equal(a, b) for a, b in zip(lp.remove(back).tree, liquid.tree))
    # batched liquid leaves: the frozen ones are broadcast to the rows
    rows = jt.tree.broadcast_rows(liquid, 3)
    assert lp.insert(rows)["cfzeromode"].shape == (3,)
    assert lp.insert_zeros(rows)["cfloglogavgslope"].shape == (3,)
    np.testing.assert_allclose(float(lp(liquid)), float(lh_t(p)), rtol=1e-14)
    # a tree of booleans names the same leaves
    lp2, _ = lh_t.freeze(primals=p, point_estimates={k: k in FROZEN for k in pos})
    assert lp2.point_estimates == lp.point_estimates
    with pytest.raises(ValueError):
        lh_t.freeze(primals=p, point_estimates=("nope",))
    with pytest.raises(TypeError):
        tlh.parse_point_estimates(("a",), [torch.zeros(1)])


def test_partial_likelihood_metric_matches_jax(problem):
    lh_j, lh_t, pos = problem
    lp_j, liq_j = lh_j.freeze(primals=_jpos(pos), point_estimates=FROZEN)
    lp_t, liq_t = lh_t.freeze(primals=jt.from_numpy(pos), point_estimates=FROZEN)
    rng = np.random.default_rng(8)
    tan = tuple(rng.standard_normal(x.shape) for x in liq_t.tree)
    want = lp_j.metric(liq_j, jft.Vector(tuple(jnp.asarray(t) for t in tan)))
    tan_t = jt.Vector(tuple(torch.from_numpy(t) for t in tan))
    for got in (lp_t.metric(liq_t, tan_t), lp_t.metric_at(liq_t)(tan_t)):
        for g, w in zip(got.tree, want.tree):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w), rtol=0, atol=1e-10 * np.max(np.abs(np.asarray(w))))
    lsm, rsm = lp_t.sqrt_metric_at(liq_t)
    back = lsm(rsm(tan_t))
    for g, w in zip(back.tree, want.tree):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=0, atol=1e-10 * np.max(np.abs(np.asarray(w))))


def test_draw_with_point_estimates_matches_jax(problem):
    lh_j, lh_t, pos = problem
    key = jax.random.PRNGKey(41)
    kw = dict(cg_kwargs=dict(maxiter=4), point_estimates=FROZEN)
    res_j, _ = jft.draw_linear_residual(lh_j, _jpos(pos), key, **kw)
    res_t, _ = jt.draw_linear_residual(lh_t, jt.from_numpy(pos), JaxKey(key), **kw)
    _close_tree(jt.to_numpy(res_t), res_j, 1e-8)
    assert all(float(res_t[k].abs().max()) == 0.0 for k in FROZEN)
    mk = dict(xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=4))
    new_j, st_j = jft.nonlinearly_update_residual(
        lh_j, _jpos(pos), res_j, key, 1.0, point_estimates=FROZEN, minimize_kwargs=mk)
    new_t, st_t = jt.nonlinearly_update_residual(
        lh_t, jt.from_numpy(pos), res_t, JaxKey(key), 1.0, point_estimates=FROZEN,
        minimize_kwargs=mk)
    assert (int(st_t.nit), int(st_t.status)) == (int(st_j.nit), int(st_j.status))
    _close_tree(jt.to_numpy(new_t), new_j, 1e-8)
    assert all(float(new_t[k].abs().max()) == 0.0 for k in FROZEN)


@pytest.mark.parametrize("residual_map", ["vmap", "smap"])
def test_update_with_a_frozen_leaf_matches_jax(problem, residual_map):
    lh_j, lh_t, pos = problem
    kw = dict(SHORT, point_estimates=("cfzeromode",))
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map="vmap")
    smp_j = jft.Samples(pos=_jpos(pos), samples=None, keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(13), **kw))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map=residual_map)
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(13)), **kw))
    np.testing.assert_array_equal(
        np.asarray(st_t.sample_state.nit), np.asarray(st_j.sample_state.nit))
    np.testing.assert_allclose(
        float(st_t.minimization_state.fun), float(st_j.minimization_state.fun), rtol=1e-6)
    _close_tree(jt.to_numpy(smp_t.pos), smp_j.pos, 1e-6)
    _close_tree(jt.to_numpy(smp_t._samples), smp_j._samples, 1e-6)
    assert float(smp_t._samples["cfzeromode"].abs().max()) == 0.0


# -- (e) minisanity ---------------------------------------------------------


def _samples_pair(pos, n=4, seed=6):
    rng = np.random.default_rng(seed)
    res = {k: 0.2 * rng.standard_normal((n,) + v.shape) for k, v in pos.items()}
    s_j = jft.Samples(pos=_jpos(pos), samples=_jpos(res), keys=None)
    s_t = jt.Samples(pos=jt.from_numpy(pos), samples=jt.from_numpy(res), keys=None)
    return s_j, s_t


@pytest.mark.parametrize("map", ["vmap", "smap"])
@pytest.mark.parametrize("what", ["data", "latent", "position"])
def test_minisanity_numbers_and_table_match_jax(problem, what, map):
    lh_j, lh_t, pos = problem
    s_j, s_t = _samples_pair(pos)
    if what == "data":
        args_j, args_t = (s_j, lh_j.normalized_residual), (s_t, lh_t.normalized_residual)
    elif what == "latent":
        args_j, args_t = (s_j,), (s_t,)
    else:
        args_j, args_t = (_jpos(pos),), (jt.from_numpy(pos),)
    st_j, tbl_j = jms.minisanity(*args_j, map=map)
    st_t, tbl_t = tms.minisanity(*args_t, map=map)
    flat_j = jax.tree_util.tree_leaves(st_j, is_leaf=lambda n: isinstance(n, jms.ChiSqStats))
    flat_t = [st for _, st in tms._flatten_with_labels(st_t)]
    assert len(flat_j) == len(flat_t) >= 1
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a.mean.numpy(), np.asarray(b.mean), rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(a.reduced_chisq.numpy(), np.asarray(b.reduced_chisq),
                                   rtol=1e-9, atol=1e-13)
        assert int(a.ndof) == int(b.ndof)
    assert tbl_t == tbl_j
    assert "reduced χ²" in tbl_t.splitlines()[0]


def test_status_message_matches_jax(problem):
    lh_j, lh_t, pos = problem
    jok = importlib.import_module("nifty_tpu.optimize_kl")
    s_j, s_t = _samples_pair(pos)
    fun, nits = 1234.5678, [2, 1, 2, 2]
    st_j = jok.OptimizeVIState(
        3, None, sample_state=jft.OptimizeResults(None, True, jnp.zeros(4), None, None,
                                                  nit=jnp.asarray(nits)),
        minimization_state=jft.OptimizeResults(None, True, 0, jnp.asarray(fun), None, nit=4))
    st_t = tok.OptimizeVIState(
        3, None, sample_state=jt.OptimizeResults(None, True, torch.zeros(4), None, None,
                                                 nit=torch.tensor(nits)),
        minimization_state=jt.OptimizeResults(None, True, 0, fun, None, nit=4))
    want = jok.get_status_message(s_j, st_j, lh_j.normalized_residual, name="X")
    got = tok.get_status_message(s_t, st_t, lh_t.normalized_residual, name="X")
    assert got == want
    draw_only = st_t._replace(sample_state=torch.tensor([0, -1]))
    msg = tok.get_status_message(s_t, draw_only, name="X")
    assert "linear-draw CG status per sample [0, -1]" in msg and "WARNING" in msg


def test_check_sampling_status_raises_on_request():
    bad = torch.tensor([0, -1])
    tok._check_sampling_status(bad, dict())
    tok._check_sampling_status(torch.tensor([0, 5]), dict(_raise_nonposdef=True))
    tok._check_sampling_status(None, dict(_raise_nonposdef=True))
    with pytest.raises(FloatingPointError):
        tok._check_sampling_status(bad, dict(_raise_nonposdef=True))
    with pytest.raises(FloatingPointError):
        tok._check_sampling_status(
            jt.OptimizeResults(None, False, bad, None, None), dict(_raise_nonposdef=True))


# -- (f) optimize_kl with odir, resume, sample files -------------------------


def _signal_problem():
    """demos/0_intro.py's model at 16^2: data = exp(field) + noise."""
    cf = build(jt, (16, 16))

    class Signal(jt.Model):
        def __init__(self, field):
            super().__init__(domain=field.domain, init=field.init)
            self.field = field

        def forward(self, x):
            return torch.exp(self.field(x))

    signal = Signal(cf)
    truth = signal(signal.init(jt.HostKey(1)))
    data = truth + NOISE_STD * jt.random_like(jt.HostKey(2), truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(signal)
    return lh, signal


def _run_optimize_kl(lh, n_total, odir, **kw):
    size = jt.tree.size(lh.domain)
    return jt.optimize_kl(
        lh, kw.pop("start", None), key=kw.pop("key", jt.HostKey(3)),
        n_total_iterations=n_total,
        n_samples=lambda i: 1 if i < 1 else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=1e-4 * size / 10.0, maxiter=6)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-4, maxiter=2, cg_kwargs=dict(maxiter=4))),
        kl_kwargs=dict(minimize_kwargs=dict(
            absdelta=1e-4 * size, maxiter=3, cg_kwargs=dict(maxiter=4))),
        sample_mode=lambda i: "nonlinear_resample" if i >= 1 else "linear_resample",
        odir=odir, **kw)


@pytest.mark.parametrize("key_kind", ["host", "int", "generator"])
def test_optimize_kl_writes_files_and_resumes_bitwise(tmp_path, key_kind):
    lh, _ = _signal_problem()
    make_key = {"host": lambda: jt.HostKey(3), "int": lambda: 3,
                "generator": lambda: torch.Generator().manual_seed(3)}[key_kind]
    start = jt.random_like(jt.HostKey(4), lh.domain)
    seen = []
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    smp_full, st_full = _run_optimize_kl(
        lh, 3, full_dir, start=start, key=make_key(),
        callback=lambda s, st: seen.append(st.nit))
    assert seen == [1, 2, 3] and st_full.nit == 3
    # the energy history's figure (``plot_energy_history=True``, the JAX
    # package's default) where matplotlib imports
    figure = ["energy_history.png"] if importlib.util.find_spec("matplotlib") else []
    assert sorted(os.listdir(full_dir)) == figure + ["last.pkl", "minisanity.txt"]
    report = open(os.path.join(full_dir, "minisanity.txt")).read()
    assert report.count("KL energy") == 3 and report.count("latent-space residuals") == 3
    assert "data-space residuals" in report and "linear-draw CG status" in report
    assert "geoVI curve steps per sample" in report

    _run_optimize_kl(lh, 2, cut_dir, start=start, key=make_key())
    smp_res, st_res = _run_optimize_kl(lh, 3, cut_dir, resume=True, key=None)
    assert st_res.nit == 3
    assert float(st_res.minimization_state.fun) == float(st_full.minimization_state.fun)
    for k in smp_full.pos:
        assert torch.equal(smp_res.pos[k], smp_full.pos[k])
        assert torch.equal(smp_res._samples[k], smp_full._samples[k])
    assert open(os.path.join(cut_dir, "minisanity.txt")).read() == report
    # a finished run resumes to itself
    smp_again, st_again = _run_optimize_kl(lh, 3, cut_dir, resume=True, key=None)
    assert st_again.nit == 3 and torch.equal(smp_again.pos["cfxi"], smp_full.pos["cfxi"])
    with pytest.raises(ValueError):
        _run_optimize_kl(lh, 3, str(tmp_path / "empty"), resume=True)


def test_optimize_vi_run_and_mean_and_std(problem):
    _, lh_t, pos = problem
    opt = jt.OptimizeVI(lh_t, 2)
    samples, state = opt.run(
        jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None), jt.HostKey(0), **SHORT)
    assert state.nit == 2 and len(samples) == 4
    mean, std = jt.mean_and_std([lh_t.model(s) for s in samples])
    assert mean.shape == std.shape == (32, 32) and bool((std > 0).all())
    pair, st = jt.draw_residual(
        lh_t, samples.pos, jt.HostKey(9), cg_kwargs=dict(maxiter=5),
        minimize_kwargs=dict(xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5)))
    assert pair["cfxi"].shape == (2, 32, 32) and st.nit.shape == (2,)


def test_save_and_load_samples_round_trip_with_keys(tmp_path):
    rng = np.random.default_rng(1)
    pos = jt.from_numpy({"a": rng.standard_normal(3), "v": jft.Vector({"x": np.ones(2)})})
    res = jt.from_numpy({"a": rng.standard_normal((4, 3)),
                         "v": jft.Vector({"x": rng.standard_normal((4, 2))})})
    gen = torch.Generator().manual_seed(5)
    gen_next = torch.Generator().manual_seed(5)
    s = jt.Samples(pos=pos, samples=res, keys=[jt.HostKey(7), 11, gen])
    path = str(tmp_path / "samples.pkl")
    jt.save_samples(s, path)
    back = jt.load_samples(path)
    assert torch.equal(back.pos["a"], pos["a"]) and isinstance(back.pos["v"], jt.Vector)
    assert torch.equal(back._samples["v"]["x"], res["v"]["x"]) and len(back) == 4
    k_host, k_int, k_gen = back.keys
    assert isinstance(k_host, jt.HostKey) and k_host.seed == 7 and k_int == 11
    assert torch.equal(torch.randn(3, generator=k_gen), torch.randn(3, generator=gen_next))
    empty = str(tmp_path / "empty.pkl")
    jt.save_samples(jt.Samples(pos=pos, samples=None, keys=None), empty)
    assert jt.load_samples(empty).keys is None and len(jt.load_samples(empty)) == 0
    state = tok.OptimizeVIState(
        2, gen, sample_state=torch.tensor([0, 0]),
        minimization_state=jt.OptimizeResults(None, True, 0, 1.5, None, nit=3))
    tio.save_checkpoint(path, s, state._replace(config="not stored"))
    s2, st2 = tio.load_checkpoint(path, device="cpu")
    assert st2.nit == 2 and st2.config is None and st2.minimization_state.fun == 1.5
    assert torch.equal(st2.key.get_state(), gen.get_state())
    assert torch.equal(s2._samples["a"], res["a"])


def test_samples_squeeze_and_at_old_pos():
    pos = {"a": torch.arange(3.0)}
    res = {"a": torch.arange(12.0).reshape(2, 2, 3)}
    s = jt.Samples(pos=pos, samples=res, keys=None).squeeze()
    assert s._samples["a"].shape == (4, 3) and len(s) == 4
    absolute = jt.Samples(pos=None, samples=s.samples, keys=None)
    with pytest.raises(ValueError):
        absolute.at(pos)
    moved = absolute.at({"a": torch.zeros(3)}, old_pos=pos)
    assert torch.equal(moved._samples["a"], s._samples["a"])
    sj = jft.Samples(pos=None, samples={"a": jnp.asarray(s.samples["a"].numpy())}, keys=None)
    want = sj.at({"a": jnp.zeros(3)}, old_pos={"a": jnp.arange(3.0)}).samples["a"]
    np.testing.assert_array_equal(moved.samples["a"].numpy(), np.asarray(want))


# -- (g) an unbinned grid on the quarter map ---------------------------------


def test_unbinned_256_on_the_quarter_map_matches_jax(monkeypatch):
    """Unbinned grids above the full-map size distribute on the folded
    quarter grid; the rule is forced down to 256^2 here.  Field, jvp, vjp
    and metric matvec against nifty_tpu, 1e-10 of the largest entry."""
    monkeypatch.setattr(tcf.CorrelatedFieldMaker, "QUARTER_MIN_ENTRIES", 2 ** 16)
    lh_j, lh_t, pos = _problem((256, 256), seed=12)
    cf_t = lh_t.model
    assert cf_t.use_quarter and cf_t.dist.shape == (129, 129)
    assert cf_t.dist.nb > 2000 and cf_t.dist.n_short > 0
    rng = np.random.default_rng(13)
    tan = {k: rng.standard_normal(v.shape) for k, v in pos.items()}
    cot = rng.standard_normal((256, 256))
    f_j, jvp_j = jax.jvp(lh_j.forward, (_jpos(pos),), (_jpos(tan),))
    vjp_j = jax.vjp(lh_j.forward, _jpos(pos))[1](jnp.asarray(cot))[0]
    met_j = lh_j.metric(_jpos(pos), _jpos(tan))
    f_t, fwd, bwd = tlh.linearize(cf_t, jt.from_numpy(pos))
    scale = np.max(np.abs(np.asarray(f_j)))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(
        fwd(jt.from_numpy(tan)).numpy(), np.asarray(jvp_j), rtol=0,
        atol=1e-10 * np.max(np.abs(np.asarray(jvp_j))))
    _close_tree(jt.to_numpy(bwd(torch.from_numpy(cot))), vjp_j, 1e-10)
    _close_tree(jt.to_numpy(lh_t.metric_at(jt.from_numpy(pos))(jt.from_numpy(tan))), met_j, 1e-10)


# -- (h) the device default ---------------------------------------------------


def test_the_default_device_is_the_card_and_raises_without_one():
    from nifty_tpu_torch import config

    assert config._config["device"] == "cpu"  # this module asked for the CPU
    import subprocess
    import sys

    code = (
        "import torch, nifty_tpu_torch as jt\n"
        "assert jt.config.get('device') == 'cuda'\n"
        "if torch.cuda.is_available():\n"
        "    raise SystemExit(0)\n"
        "calls = [\n"
        "    lambda: jt.config.default_device(),\n"
        "    lambda: jt.random_like(0, jt.ShapeWithDtype((2,))),\n"
        "    lambda: jt.from_numpy({'a': [1.0]}),\n"
        "    lambda: jt.tree.zeros_like(jt.ShapeWithDtype((2,))),\n"
        "    lambda: jt.Gaussian([1.0, 2.0]),\n"
        "    lambda: jt.model.module_device(torch.nn.Module()),\n"
        "    lambda: jt.Model(lambda x: x, domain=jt.ShapeWithDtype((2,)), white_init=True).init(0),\n"
        "]\n"
        "def field():\n"
        "    cfm = jt.CorrelatedFieldMaker('cf')\n"
        "    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))\n"
        "    cfm.add_fluctuations((8, 8), distances=1.0, fluctuations=(1.0, 5e-1),\n"
        "                         loglogavgslope=(-3.0, 2e-1))\n"
        "    return cfm.finalize()\n"
        "for call in calls + [field]:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('a call fell back to the CPU')\n"
        "jt.config.update('device', 'cpu')\n"
        "assert field().dist.idx.device.type == 'cpu'\n"
        "assert jt.random_like(0, jt.ShapeWithDtype((2,))).device.type == 'cpu'\n"
        "assert jt.random_like(0, jt.ShapeWithDtype((2,)), device='cpu').device.type == 'cpu'\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_explicit_devices_and_config_validation():
    from nifty_tpu_torch import config

    with pytest.raises(RuntimeError):
        torch.device("nonsense")
    with pytest.raises(RuntimeError):
        config.update("device", "nonsense")
    assert config.get("device") == "cpu"
    assert jt.random_like(1, jt.ShapeWithDtype((2,)), device="cpu").device.type == "cpu"
    assert jt.tree.zeros_like(jt.ShapeWithDtype((2,)), device="cpu").device.type == "cpu"
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((8, 8), distances=1.0, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1))
    assert cfm.finalize(device="cpu").dist.idx.device.type == "cpu"
