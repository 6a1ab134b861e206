"""The port's mesh parallelism (``nifty_tpu_torch.parallel``,
``ops/distributed_fft.py``) against ``nifty_tpu``'s: the counterpart of
each test of ``tests/test_parallel.py``, at its sizes and bounds, with
worlds of 2 and 4 gloo ranks on the CPU standing in for the JAX package's
meshes of virtual devices (8 ranks where the JAX tests take 8 devices are
too many processes: those cases run on 4).

Each world runs every case it serves in one module fixture
(``tests/torch_mesh_worker.py``; the ranks never import jax), in a thread
of this process, while this process computes the single-rank (1 x 1 mesh)
runs and the JAX package's results on ``tests/conftest.py``'s 8 virtual
devices from the same numpy inputs.  The noise of the JAX package's keys
is recorded here (a provider that splits with ``jax.random.split`` and
draws with ``nifty_tpu.tree.random_like``) and replayed on the ranks, so
a sample's noise is the JAX package's, whatever rank draws it.

Under ``deterministic_reductions`` the bitwise cases are bitwise: a
p-rank world gives the bits of one rank.
"""

import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from nifty_tpu.ops.distributed_fft import distributed_fftn as j_fftn  # noqa: E402
from nifty_tpu.ops.distributed_fft import distributed_hartley as j_hartley  # noqa: E402
from nifty_tpu.ops.harmonic import hartley_via_c2c  # noqa: E402
from nifty_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from test_parallel import _field_sharded_vi_run  # noqa: E402

from nifty_tpu_torch.parallel import pairwise_mean, pairwise_sum, run_world  # noqa: E402

pmp = pytest.mark.parametrize
WORLD_TIMEOUT = 600
HARTLEY_SHAPES = [(16, 12), (8, 6, 4), (32,)]
BUDGETS = (80, 40, 8, 60)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    torch.set_num_threads(1)
    yield
    config.update("device", old)
    config.update("deterministic_reductions", False)


def _jax_struct(tree):
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float64)


class RecordingKey:
    """``nifty_tpu``'s noise (``jax.random.split``, ``nifty_tpu.tree.
    random_like``) handed to the port, each draw recorded under its key's
    path for :class:`torch_mesh_worker.ReplayKey`."""

    def __init__(self, key, table, path=()):
        self.key, self.table, self.path = key, table, tuple(path)

    def split(self, num):
        return [RecordingKey(k, self.table, self.path + (i,))
                for i, k in enumerate(jax.random.split(self.key, num))]

    def normal(self, primals, device=None):
        out = jax.tree_util.tree_map(
            np.asarray, jft.random_like(self.key, _jax_struct(primals)))
        self.table[self.path] = out
        return jt.from_numpy(out, device=device or "cpu")


def _jax_problem(dims, data, pos_key):
    """The JAX tests' correlated field and Gaussian, and a position drawn
    with ``pos_key``, as numpy."""
    cfm = jft.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
                         asperity=(5e-1, 5e-2))
    cf = cfm.finalize()
    lh = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x).amend(cf)
    return jax.tree_util.tree_map(np.asarray, jft.random_like(pos_key, lh.domain))


def _record(data, pos, key, *, update=False, n_keys=None):
    """The noise a port run takes from ``key``: an update's (two samples,
    geoVI), ``n_keys`` keys' draws, or one draw at the key itself."""
    table = {}
    lh, p = W.field_problem(data, pos, jt.parallel.make_mesh(1, 1), distributed=False)
    jt.parallel.active_mesh().deactivate()
    if update:
        opt = jt.OptimizeVI(lh, n_total_iterations=1)
        state = opt.init_state(RecordingKey(key, table),
                               **W._vi_kwargs((1, 1, 1, 1), 1, 2, "nonlinear_resample"))
        opt.update(jt.Samples(pos=p), state)
    else:
        keys = RecordingKey(key, table).split(n_keys) if n_keys else [RecordingKey(key, table)]
        for k in keys:
            jt.draw_linear_residual(lh, p, k, cg_kwargs=dict(maxiter=1))
    return table


def _run_in_thread(results, name, n, cases):
    def target():
        try:
            results[name] = run_world(W.run_cases, n, args=(cases,), timeout=WORLD_TIMEOUT,
                                      threads=1)
        except BaseException as err:  # raised in the fixture's thread
            results[name] = err

    thread = threading.Thread(target=target)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def runs():
    """Worlds of 4 and 2 ranks (in threads), the 1 x 1 runs and the JAX
    package's results (here)."""
    rng = np.random.default_rng(42)
    hartley_in = {shape: rng.normal(size=shape) for shape in HARTLEY_SHAPES}
    fft_in = rng.normal(size=(16, 8)) + 1j * rng.normal(size=(16, 8))
    adj_x, adj_y = rng.normal(size=(16, 12)), rng.normal(size=(16, 12))
    fft_y = rng.normal(size=(16, 8)) + 1j * rng.normal(size=(16, 8))
    one_d = rng.normal(size=32) + 1j * rng.normal(size=32)
    nondiv = rng.normal(size=(16, 5))
    cube_x, cube_y = rng.normal(size=(64, 64, 64)), rng.normal(size=(64, 64, 64))
    pair_x = rng.normal(size=(8, 64)).astype(np.float32)
    ss_pos = {"xi": rng.normal(size=(8, 8)), "s": np.asarray(0.3)}
    ss_resid = {"xi": rng.normal(size=(4, 8, 8)), "s": rng.normal(size=(4,))}

    data64 = np.random.default_rng(42).normal(size=(64, 64))
    pos64 = _jax_problem((64, 64), data64, jax.random.PRNGKey(1))
    tan64 = _jax_problem((64, 64), data64, jax.random.PRNGKey(5))
    data16 = np.random.default_rng(42).normal(size=(16, 16))
    pos16 = _jax_problem((16, 16), data16, jax.random.PRNGKey(42))
    data8 = np.random.default_rng(42).normal(size=(8, 8))
    pos8 = _jax_problem((8, 8), data8, jax.random.PRNGKey(42))
    t_update = _record(data64, pos64, jax.random.PRNGKey(7), update=True)
    t_stage = _record(data64, pos64, jax.random.PRNGKey(3))
    t_draw = _record(data64, pos64, jax.random.PRNGKey(70), n_keys=2)
    t_kl16 = _record(data16, pos16, jax.random.PRNGKey(2), n_keys=4)
    t_kl8 = _record(data8, pos8, jax.random.PRNGKey(5), n_keys=8)

    vi = dict(data=data64, pos=pos64, key_table=t_update)
    det_lin = dict(vi, sample_mode="linear_resample", nl_maxiter=0, budgets=BUDGETS, det=True)
    det_geo = dict(vi, sample_mode="nonlinear_resample", nl_maxiter=5, budgets=BUDGETS, det=True)
    lin = dict(vi, sample_mode="linear_resample", nl_maxiter=0)
    geo = dict(vi, sample_mode="nonlinear_resample", nl_maxiter=10)
    stages = dict(data=data64, pos=pos64, tan=tan64, key_table=t_stage)
    draw = dict(data=data64, pos=pos64, key_table=t_draw)
    kl16 = dict(data=data16, pos=pos16, key_table=t_kl16, n_keys=4,
                cg_kwargs=dict(resnorm=1e-9, maxiter=50))
    kl8 = dict(data=data8, pos=pos8, key_table=t_kl8, n_keys=8, pairwise=True,
               cg_kwargs=dict(resnorm=1e-6, maxiter=30))

    def transforms(field):
        return [
            *[(f"hartley {shape}", "hartley_case", dict(x=x, field=field))
              for shape, x in hartley_in.items()],
            ("fftn", "fftn_case", dict(x=fft_in, field=field)),
            ("fftn 1-d", "fftn_case", dict(x=one_d, field=field)),
            ("pairwise", "pairwise_case", dict(x=pair_x, samples=field)),
        ]

    cases4 = transforms(4) + [
        ("hartley adjoint", "hartley_vjp_case", dict(x=adj_x, y=adj_y, field=4)),
        ("fftn adjoint", "fftn_vjp_case", dict(x=fft_in, y=fft_y, field=4)),
        ("nondivisible", "hartley_case", dict(x=nondiv, field=4)),
        ("pencil", "hartley_vjp_case", dict(x=cube_x, y=cube_y, field=4)),
        ("shard samples", "shard_samples_case", dict(pos=ss_pos, resid=ss_resid, keys=[10, 11],
                                                     samples=2, field=2)),
        ("random_like", "random_like_case", dict(shape=(16, 12), field=4, seed=3)),
        ("from_numpy", "from_numpy_case", dict(tree=ss_pos, samples=1, field=4)),
        ("kl pairwise", "kl_step_case", dict(kl8, samples=4)),
        ("stages", "stages_case", dict(stages, samples=2, field=2)),
        ("det linear", "vi_update_case", dict(det_lin, samples=2, field=2)),
        ("det geovi", "vi_update_case", dict(det_geo, samples=2, field=2)),
        ("linear", "vi_update_case", dict(lin, samples=2, field=2)),
        ("geovi", "vi_update_case", dict(geo, samples=2, field=2)),
    ]
    cases2 = transforms(2) + [
        ("sample draw", "sample_draw_case", dict(draw, samples=2)),
        ("kl step", "kl_step_case", dict(kl16, samples=2)),
        ("det geovi samples", "vi_update_case", dict(det_geo, samples=2, field=1)),
    ]
    cases1 = [
        ("stages", "stages_case", dict(stages, samples=1, field=1)),
        ("det linear", "vi_update_case", dict(det_lin, samples=1, field=1)),
        ("det geovi", "vi_update_case", dict(det_geo, samples=1, field=1)),
        ("linear", "vi_update_case", dict(lin, samples=1, field=1)),
        ("geovi", "vi_update_case", dict(geo, samples=1, field=1)),
        ("sample draw", "sample_draw_case", dict(draw, samples=1)),
        ("kl step", "kl_step_case", dict(kl16, samples=1)),
        ("kl pairwise", "kl_step_case", dict(kl8, samples=1)),
        ("random_like", "random_like_case", dict(shape=(16, 12), field=1, seed=3)),
    ]
    worlds = {}
    threads = [_run_in_thread(worlds, 4, 4, cases4), _run_in_thread(worlds, 2, 2, cases2)]
    try:
        one = W.run_cases(cases1)
        jax_ref = _jax_references(hartley_in, fft_in, adj_x, adj_y, one_d, nondiv, cube_x, cube_y,
                                  data64)
    finally:
        for t in threads:
            t.join()
    for n, res in worlds.items():
        if isinstance(res, BaseException):
            raise res
    return dict(four=worlds[4], two=worlds[2], one=one, jax=jax_ref, inputs=dict(
        hartley=hartley_in, fft=fft_in, fft_y=fft_y, one_d=one_d, nondiv=nondiv, cube=cube_x,
        cube_y=cube_y, pair=pair_x, ss_pos=ss_pos, ss_resid=ss_resid, adj_y=adj_y))


def _field_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("field",))


def _sharded(x, mesh):
    return jax.device_put(x, NamedSharding(mesh, P(*(["field"] + [None] * (x.ndim - 1)))))


def _jax_references(hartley_in, fft_in, adj_x, adj_y, one_d, nondiv, cube_x, cube_y, data64):
    """The JAX package's distributed transforms (on 2 and 4 of its virtual
    devices, 8 for the pencil), and its deterministic fused linear update
    (``_field_sharded_vi_run`` at the budgets (80, 40, 8, 60))."""
    out = {}
    for n in (2, 4):
        mesh = _field_mesh(n)
        for shape, x in hartley_in.items():
            out["hartley", shape, n] = np.asarray(j_hartley(_sharded(jnp.asarray(x), mesh), mesh))
        out["fftn", n] = np.asarray(j_fftn(_sharded(jnp.asarray(fft_in), mesh), mesh))
        out["fftn 1-d", n] = np.asarray(j_fftn(_sharded(jnp.asarray(one_d), mesh), mesh))
    mesh4 = _field_mesh(4)
    y = jnp.asarray(adj_y)
    out["hartley adjoint"] = np.asarray(jax.grad(
        lambda v: jnp.vdot(j_hartley(v, mesh4), y))(_sharded(jnp.asarray(adj_x), mesh4)))
    out["nondivisible"] = np.asarray(j_hartley(_sharded(jnp.asarray(nondiv), mesh4), mesh4))
    mesh8 = _field_mesh(8)
    yc = jnp.asarray(cube_y)
    xc = _sharded(jnp.asarray(cube_x), mesh8)
    out["pencil"] = np.asarray(j_hartley(xc, mesh8))
    out["pencil adjoint"] = np.asarray(jax.grad(lambda v: jnp.vdot(j_hartley(v, mesh8), yc))(xc))
    jft.config.update("deterministic_reductions", True)
    try:
        _, st = _field_sharded_vi_run(data64, j_make_mesh(samples=1, field=1),
                                      "linear_resample", 0, budgets=BUDGETS)
    finally:
        jft.config.update("deterministic_reductions", False)
    out["det linear energy"] = float(st.minimization_state.fun)
    return out


def _max_leaf_err(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in b)


# -- the transforms ---------------------------------------------------------------


@pmp("shape", HARTLEY_SHAPES, ids=str)
@pmp("n_dev", [2, 4])
def test_distributed_hartley_matches_local(runs, shape, n_dev):
    got = runs["four" if n_dev == 4 else "two"][0][f"hartley {shape}"]
    x = runs["inputs"]["hartley"][shape]
    np.testing.assert_allclose(got, np.asarray(hartley_via_c2c(jnp.asarray(x))), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(got, runs["jax"]["hartley", shape, n_dev], rtol=1e-10, atol=1e-10)


@pmp("n_dev", [2, 4])
def test_distributed_fftn_matches_local(runs, n_dev):
    got = runs["four" if n_dev == 4 else "two"][0]["fftn"]
    np.testing.assert_allclose(got, np.fft.fftn(runs["inputs"]["fft"]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, runs["jax"]["fftn", n_dev], rtol=1e-10, atol=1e-10)


def test_distributed_hartley_adjoint(runs):
    h, grad = runs["four"][0]["hartley adjoint"]
    y = runs["inputs"]["adj_y"]
    np.testing.assert_allclose(grad, np.asarray(hartley_via_c2c(jnp.asarray(y))), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(grad, runs["jax"]["hartley adjoint"], rtol=1e-10, atol=1e-10)


def test_distributed_fftn_adjoint_by_autograd(runs):
    """The gradient of ``Re <F x, y>`` equals the one autograd gives the
    local ``torch.fft.fftn`` of the whole field."""
    x = torch.from_numpy(runs["inputs"]["fft"]).requires_grad_(True)
    y = torch.from_numpy(runs["inputs"]["fft_y"])
    (torch.fft.fftn(x).conj() * y).real.sum().backward()
    np.testing.assert_allclose(runs["four"][0]["fftn adjoint"], x.grad.numpy(), rtol=1e-10,
                               atol=1e-10)


def test_distributed_fft_1d_four_step(runs):
    """1-D distributed FFT runs the four-step algorithm (no gather)."""
    x = runs["inputs"]["one_d"]
    for n_dev, world in ((2, "two"), (4, "four")):
        got = runs[world][0]["fftn 1-d"]
        np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, runs["jax"]["fftn 1-d", n_dev], rtol=1e-12, atol=1e-12)


def test_distributed_hartley_nondivisible_axis(runs):
    """A partner axis not divisible by the ranks (5 over 4) is zero-padded
    for the transpose, never gathered."""
    got = runs["four"][0]["nondivisible"]
    x = runs["inputs"]["nondiv"]
    np.testing.assert_allclose(got, np.asarray(hartley_via_c2c(jnp.asarray(x))), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(got, runs["jax"]["nondivisible"], rtol=1e-10, atol=1e-10)


def test_distributed_hartley_3d_pencil_vjp(runs):
    """64^3 over 4 ranks (the JAX test's 8 devices): forward and adjoint
    by autograd match the local transform and the JAX package's."""
    h, grad = runs["four"][0]["pencil"]
    x, y = runs["inputs"]["cube"], runs["inputs"]["cube_y"]
    np.testing.assert_allclose(h, np.asarray(hartley_via_c2c(jnp.asarray(x))), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(h, runs["jax"]["pencil"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(grad, np.asarray(hartley_via_c2c(jnp.asarray(y))), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(grad, runs["jax"]["pencil adjoint"], rtol=1e-9, atol=1e-9)


def test_distributed_fft_module_never_gathers():
    """Memory contract: the pencil module must not materialize the whole
    field on any rank."""
    import nifty_tpu_torch.ops.distributed_fft as dfft

    assert "all_gather" not in inspect.getsource(dfft)


def test_every_rank_holds_the_same_transform(runs):
    for world in ("two", "four"):
        for r in runs[world][1:]:
            for shape in HARTLEY_SHAPES:
                np.testing.assert_array_equal(r[f"hartley {shape}"], runs[world][0][
                    f"hartley {shape}"])


# -- reductions and layouts --------------------------------------------------------


def test_pairwise_sum_mesh_size_independent(runs):
    """The fixed-order reduction is bitwise independent of the ranks it
    is spread over (1, 2, 4), with each rank reducing its own rows."""
    x = runs["inputs"]["pair"]
    local = pairwise_sum(torch.from_numpy(x)).numpy()
    want = np.asarray(jft.parallel.pairwise_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(local, want)
    for world in ("two", "four"):
        got, stats = runs[world][0]["pairwise"]
        np.testing.assert_array_equal(got, local)
        assert stats == {"samples subtree": 1}


def test_pairwise_sum_matches_sum(rng):
    for n in (1, 2, 3, 5, 8, 13):
        x = rng.normal(size=(n, 4))
        np.testing.assert_allclose(pairwise_sum(torch.from_numpy(x)).numpy(), x.sum(0),
                                   rtol=1e-12)
        np.testing.assert_allclose(pairwise_mean(torch.from_numpy(x)).numpy(), x.mean(0),
                                   rtol=1e-12)
        np.testing.assert_array_equal(pairwise_sum(torch.from_numpy(x)).numpy(),
                                      np.asarray(jft.parallel.pairwise_sum(jnp.asarray(x))))


def test_shard_samples_roundtrip(runs):
    """2 x 2: each rank holds its two rows (the keys of its pair) and its
    slab of the field-sharded leaf; gathering gives back the samples."""
    pos, resid = runs["inputs"]["ss_pos"], runs["inputs"]["ss_resid"]
    for r, out in enumerate(runs["four"]):
        s, f = out["shard samples"]["index"]
        local = out["shard samples"]["local"]
        np.testing.assert_array_equal(local["xi"], resid["xi"][2 * s:2 * s + 2, 4 * f:4 * f + 4])
        np.testing.assert_array_equal(local["s"], resid["s"][2 * s:2 * s + 2])
        assert out["shard samples"]["keys"] == [[10], [11]][s]
        for k in resid:
            np.testing.assert_array_equal(out["shard samples"]["back"][k], resid[k])
            np.testing.assert_array_equal(out["shard samples"]["back_pos"][k], pos[k])
        assert out["shard samples"]["back_keys"] == [10, 11]


def test_random_like_noise_does_not_depend_on_the_world(runs):
    """A field-sharded leaf's noise is its global draw's rows: 4 ranks
    give the 1-rank draw, from an int seed and from a ``HostKey``."""
    one, four = runs["one"]["random_like"], runs["four"][0]["random_like"]
    for key in ("seed", "host"):
        np.testing.assert_array_equal(four[key]["xi"], one[key]["xi"])
        np.testing.assert_array_equal(four[key]["s"], one[key]["s"])


def test_from_numpy_places_a_global_tree_on_the_mesh(runs):
    """A global numpy tree (the JAX package's latents) becomes each rank's
    rows of its field-sharded leaves; the rest stay whole."""
    pos = runs["inputs"]["ss_pos"]
    for out in runs["four"]:
        got, f = out["from_numpy"]["local"], out["from_numpy"]["index"]
        np.testing.assert_array_equal(got["xi"], pos["xi"][2 * f:2 * f + 2])
        np.testing.assert_array_equal(got["s"], pos["s"])
        assert out["from_numpy"]["sharded"] == [False, True]


# -- sample parallelism and the KL ------------------------------------------------


def test_sharded_kl_step_matches_single_device(runs):
    """The draw and KL value and gradient with the samples spread over 2
    ranks equal one rank's (within fp tolerance; no fixed order here)."""
    v0, g0, _ = runs["one"]["kl step"]
    v1, g1, _ = runs["two"][0]["kl step"]
    np.testing.assert_allclose(v1, v0, rtol=1e-10)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-8, atol=1e-10)


def test_kl_with_pairwise_reduce_mesh_independent(runs):
    """The pairwise reduce over 4 ranks of 2 keys each (the JAX test's 8
    devices of one) gives one rank's KL value and gradient."""
    v0, g0, _ = runs["one"]["kl pairwise"]
    v1, g1, stats = runs["four"][0]["kl pairwise"]
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-10, atol=1e-12)
    assert stats.get("samples subtree", 0) > 0 and "samples gathered" not in stats


def test_field_sharded_fused_vi_update_matches_unsharded(runs):
    """One update (antithetic draw + KL Newton-CG) on a 2 x 2 world with the
    pencil Hartley against the 1 x 1 run, solvers to convergence."""
    a, b = runs["four"][0]["linear"], runs["one"]["linear"]
    assert _max_leaf_err(a["samples"], b["samples"]) <= 5e-7
    np.testing.assert_allclose(a["fun"], b["fun"], rtol=1e-8)


def test_field_sharded_geovi_update_statistically_consistent(runs):
    a, b = runs["four"][0]["geovi"], runs["one"]["geovi"]
    assert abs(a["fun"] - b["fun"]) / abs(b["fun"]) < 1e-3
    assert _max_leaf_err(a["samples"], b["samples"]) < 0.3


def test_deterministic_mode_stages_bitwise(runs):
    """Energy, a metric matvec and a 200-step CG draw on a 2 x 2 world are
    bitwise one rank's."""
    a, b = runs["four"][0]["stages"], runs["one"]["stages"]
    assert a["energy"] == b["energy"]
    assert _max_leaf_err(a["metric"], b["metric"]) == 0.0
    assert _max_leaf_err(a["draw"], b["draw"]) == 0.0


def test_deterministic_mode_sample_parallel_draw_bitwise(runs):
    assert _max_leaf_err(runs["two"][0]["sample draw"], runs["one"]["sample draw"]) == 0.0


def test_deterministic_mode_fused_linear_update_tight(runs):
    """The fused linear update on 2 x 2 under ``deterministic_reductions``
    equals the 1 x 1 run (bitwise here; the JAX test's bounds asserted),
    and the JAX package's update to 1e-8 in the KL energy."""
    a, b = runs["four"][0]["det linear"], runs["one"]["det linear"]
    assert _max_leaf_err(a["samples"], b["samples"]) <= 1e-11
    assert a["nit"] == b["nit"]
    np.testing.assert_allclose(a["fun"], b["fun"], rtol=1e-12)
    np.testing.assert_allclose(b["fun"], runs["jax"]["det linear energy"], rtol=1e-8)


def test_deterministic_mode_fused_linear_update_bitwise(runs):
    a, b = runs["four"][0]["det linear"], runs["one"]["det linear"]
    assert a["fun"] == b["fun"]
    assert _max_leaf_err(a["samples"], b["samples"]) == 0.0
    assert _max_leaf_err(a["pos"], b["pos"]) == 0.0
    assert a["stats"].get("samples subtree", 0) > 0 and "samples gathered" not in a["stats"]


def test_deterministic_mode_geovi_update_tight(runs):
    a, b = runs["four"][0]["det geovi"], runs["one"]["det geovi"]
    assert abs(a["fun"] - b["fun"]) / abs(b["fun"]) < 1e-9
    assert _max_leaf_err(a["samples"], b["samples"]) < 1e-9


def test_deterministic_mode_full_update_bitwise_samples_mesh(runs):
    """The full geoVI iteration with the samples spread over 2 ranks
    (1 rank == 2 ranks, the reference's MPI invariant)."""
    a, b = runs["two"][0]["det geovi samples"], runs["one"]["det geovi"]
    assert _max_leaf_err(a["samples"], b["samples"]) < 1e-9
    np.testing.assert_allclose(a["fun"], b["fun"], rtol=1e-9)


@pmp("det, on_mesh, device, lockstep", [
    (False, True, "cuda", True), (True, False, "cuda", True), (True, True, "cpu", True),
    (True, True, "cuda", False)])
def test_auto_maps_loop_where_lockstep_rows_would_part_the_worlds(monkeypatch, det, on_mesh,
                                                                   device, lockstep):
    """``"auto"`` keeps the lockstep maps of a small field except on a card
    under ``deterministic_reductions`` with a mesh active, where a row's
    bits would follow the samples rank's share of the rows (the card test
    ``test_row_sums_on_the_card_depend_on_the_row_count``)."""
    import importlib

    from nifty_tpu_torch import config
    from nifty_tpu_torch.parallel import make_mesh

    okl = importlib.import_module("nifty_tpu_torch.optimize_kl")
    lh = jt.Gaussian(torch.zeros(4, dtype=torch.float64))
    monkeypatch.setattr(okl, "module_device", lambda module: torch.device(device))
    config.update("deterministic_reductions", det)
    mesh = make_mesh(1, 1).activate() if on_mesh else None
    try:
        opt = jt.OptimizeVI(lh, n_total_iterations=1)
    finally:
        config.update("deterministic_reductions", False)
        if mesh is not None:
            mesh.deactivate()
    assert opt.lockstep is lockstep
    assert opt.kl_map == ("vmap" if lockstep else "smap")
