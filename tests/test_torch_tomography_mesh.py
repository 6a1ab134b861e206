"""The 3-D tomography of ``tests/test_tomography_3d.py`` on a samples x
field mesh of the port: a 16^3 correlated field with the pencil Hartley,
``exp``, then the line of sight (48 rays x 64 points), field-sharded over
gloo worlds of 4 ranks (``tests/torch_mesh_worker.py``; the ranks never
import jax), against the JAX package's pencil-sharded update on
``tests/conftest.py``'s virtual devices and against the 1 x 1 mesh of the
port; the line of sight's slab route (K11 on a rank's rows, its (ray,
row) partials folded in a fixed order) against the whole grid's plain
versions; and a 1-D ICR update with its samples over 2 ranks.

Under ``deterministic_reductions`` every world gives the bits of one
rank.  The JAX package's noise is recorded here and replayed on the ranks
(``test_torch_parallel.RecordingKey``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from nifty_tpu.parallel import shard_position as j_shard_position  # noqa: E402
from test_tomography_3d import _tomography_setup, make_mesh as j_make_mesh  # noqa: E402
from test_torch_parallel import RecordingKey, _max_leaf_err  # noqa: E402

from nifty_tpu_torch.ops import los_interp as li  # noqa: E402
from nifty_tpu_torch.parallel import make_mesh, run_world  # noqa: E402
from nifty_tpu_torch.tree import _fold_halving  # noqa: E402

pmp = pytest.mark.parametrize
WORLD_TIMEOUT = 600
DIMS = (16, 16, 16)
N_RAYS, N_POINTS, RAY_SEED = 48, 64, 7
#: (draw CG, geoVI CG, KL Newton, KL CG): the converged solvers of the
#: JAX comparison, and the short fixed trips of the bitwise worlds
CONVERGED = (200, 100, 30, 150)
SHORT = (20, 10, 3, 10)


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


def _rays(n_rays=N_RAYS, dims=DIMS, seed=RAY_SEED):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, size=(n_rays, len(dims))),
            rng.uniform(0.05, 0.95, size=(n_rays, len(dims))))


def _jax_problem():
    """``_tomography_setup`` on a 1 x 4 mesh of virtual devices (the field
    pencil-sharded), its likelihood, start position and a tangent placed
    on the mesh as the JAX test places them; and the data, the noise, the
    position and the tangent as numpy.

    Not a samples axis: the JAX package's samples-sharded update draws
    other noise than its keys give unsharded (its 2 x 2 and unsharded
    updates of this problem differ by 0.64 in the residuals after 10 CG
    steps), so it cannot be replayed on the port's ranks."""
    mesh = j_make_mesh(samples=1, field=4)
    lh, _, _ = _tomography_setup(DIMS, N_RAYS, mesh=mesh)
    data = np.asarray(lh.likelihood.data)
    noise_std = float(1.0 / np.sqrt(np.asarray(lh.likelihood.noise_cov_inv(jnp.ones(1)))[0]))
    lh = jax.tree_util.tree_map(lambda x: j_shard_position(x, mesh) if hasattr(x, "ndim") else x,
                                lh)
    pos = j_shard_position(jft.random_like(jax.random.PRNGKey(1), lh.domain), mesh)
    tan = j_shard_position(jft.random_like(jax.random.PRNGKey(5), lh.domain), mesh)
    return (lh, pos, tan), dict(data=data, noise_std=noise_std, pos=_as_np(pos), tan=_as_np(tan))


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_update(lh, pos, tan):
    """The energy and a metric matvec, and one linear update with the
    solvers to convergence, of the JAX package's pencil-sharded problem:
    the stages, and the update's samples and energy, as numpy."""
    stages = dict(energy=float(lh(pos)), metric=_as_np(lh.metric(pos, tan)))
    draw_mi, nl_cg_mi, kl_mi, kl_cg_mi = CONVERGED
    opt = jft.OptimizeVI(lh, n_total_iterations=1)
    state = opt.init_state(
        jax.random.PRNGKey(3), n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=draw_mi, absdelta=1e-13)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-8, maxiter=0, cg_kwargs=dict(maxiter=nl_cg_mi))),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-9, maxiter=kl_mi,
                                            cg_kwargs=dict(maxiter=kl_cg_mi))),
        sample_mode="linear_resample")
    samples, state = opt.update(jft.Samples(pos=pos, samples=None, keys=None), state)
    return dict(stages=stages, new_pos=_as_np(samples.pos), samples=_as_np(samples._samples),
                fun=float(state.minimization_state.fun))


def _record(data, noise_std, pos):
    """The noise the port's update takes from the JAX key ``PRNGKey(3)``,
    recorded by a short unsharded run."""
    table = {}
    lh, p = W.tomography_problem(data, noise_std, pos, make_mesh(1, 1))
    jt.parallel.active_mesh().deactivate()
    opt = jt.OptimizeVI(lh, n_total_iterations=1)
    state = opt.init_state(RecordingKey(jax.random.PRNGKey(3), table),
                           **W._vi_kwargs((1, 1, 1, 1), 0, 2, "linear_resample"))
    opt.update(jt.Samples(pos=p), state)
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
    """A 4-rank world (the JAX comparison on 2 x 2, the bitwise updates on
    2 x 2 and 4 x 1, the slab cases on 1 x 4) and a 2-rank one (ICR on
    2 x 1), in threads, while this process computes the JAX package's
    update and the 1 x 1 runs."""
    jax_args, prob = _jax_problem()
    table = _record(prob["data"], prob["noise_std"], prob["pos"])
    tan = prob.pop("tan")
    linear = dict(prob, key=table, sample_mode="linear_resample", nl_maxiter=0,
                  budgets=CONVERGED)
    det = dict(prob, key=7, sample_mode="nonlinear_resample", nl_maxiter=2, budgets=SHORT,
               det=True, n_samples=4)
    rng = np.random.default_rng(20)
    start, end = _rays()
    start[0, 0] = -0.05  # a ray with a corner outside the grid
    slab_in = dict(f=rng.normal(size=(2,) + DIMS), ybar=rng.normal(size=(2, N_RAYS)), start=start,
                   end=end, dims=DIMS, n_points=N_POINTS)
    icr_data = np.exp(0.5 * np.random.default_rng(21).normal(size=W.icr_chart().shape))
    cases4 = [
        ("stages 2x2", "tomography_stages_case", dict(prob, tan=tan, samples=2, field=2)),
        ("linear 2x2", "tomography_update_case", dict(linear, samples=2, field=2)),
        ("det 2x2", "tomography_update_case", dict(det, samples=2, field=2)),
        ("det 4x1", "tomography_update_case", dict(det, samples=4, field=1)),
        *[(f"slab det={d}", "los_slab_case", dict(slab_in, field=4, det=d))
          for d in (True, False)],
    ]
    worlds = {}
    threads = [_run_in_thread(worlds, 4, 4, cases4)]
    try:
        icr_lh = W.icr_problem(icr_data, 0.1, (14,), 3)
        icr = dict(data=icr_data, noise_std=0.1, pos=jt.to_numpy(jt.random_like(5, icr_lh.domain)),
                   seed=9)
        threads.append(_run_in_thread(worlds, 2, 2, [("icr", "icr_update_case",
                                                      dict(icr, samples=2))]))
        ref = _jax_update(*jax_args)
        one = W.run_cases([
            ("det 1x1", "tomography_update_case", dict(det, samples=1, field=1)),
            ("icr", "icr_update_case", dict(icr, samples=1)),
            *[(f"slab det={d}", "los_slab_case", dict(slab_in, field=1, det=d))
              for d in (True, False)],
        ])
    finally:
        for t in threads:
            t.join()
    for res in worlds.values():
        if isinstance(res, BaseException):
            raise res
    return dict(four=worlds[4], two=worlds[2], one=one, jax=ref, slab_in=slab_in)


# -- the update against the JAX package and across worlds ----------------------------


def test_sharded_tomography_stages_match_the_jax_package(runs):
    """The energy and a metric matvec of the 16^3 tomography on a 2 x 2
    world against the JAX package's on its pencil-sharded mesh."""
    got, want = runs["four"][0]["stages 2x2"], runs["jax"]["stages"]
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-12)
    for k in want["metric"]:
        np.testing.assert_allclose(got["metric"][k], want["metric"][k], rtol=1e-10,
                                   atol=1e-10 * np.abs(want["metric"][k]).max())


def test_sharded_tomography_update_matches_the_jax_package(runs):
    """One linear update (draw CG 200, KL 30 Newton steps of CG 150) of the
    16^3 tomography on a 2 x 2 world against the JAX package's on its
    pencil-sharded mesh.  Not ``test_field_sharded_fused_vi_update_matches_
    unsharded``'s 5e-7 / 1e-8: on this problem the solvers stop at their
    budgets and rounding moves them, and the JAX package's own unsharded
    and pencil-sharded updates differ by 2.1e-4 in the residuals, 0.049 in
    the position and 4.0e-5 in the energy (the port's 1 x 1 run against
    the JAX package's pencil-sharded one: 1.2e-4, 0.039, 1.9e-4).  The bounds are those
    spreads times 5."""
    got, ref = runs["four"][0]["linear 2x2"], runs["jax"]
    assert got["slab"] == (8, 16, 16)
    assert _max_leaf_err(got["samples"], ref["samples"]) <= 1e-3
    assert _max_leaf_err(got["pos"], ref["new_pos"]) <= 0.25
    np.testing.assert_allclose(got["fun"], ref["fun"], rtol=1e-3)


@pmp("world", ["det 2x2", "det 4x1"])
def test_deterministic_tomography_update_bitwise_across_worlds(runs, world):
    """A geoVI update under ``deterministic_reductions`` on 2 x 2 (the field
    over 2 ranks) and 4 x 1 (the samples over 4) gives the bits of 1 x 1,
    on every rank."""
    want = runs["one"]["det 1x1"]
    for rank in runs["four"]:
        got = rank[world]
        assert got["fun"] == want["fun"]
        assert got["nit"] == want["nit"]
        assert _max_leaf_err(got["samples"], want["samples"]) == 0.0
        assert _max_leaf_err(got["pos"], want["pos"]) == 0.0
    assert np.isfinite(want["fun"])


def test_deterministic_tomography_update_reduces_by_gathered_partials(runs):
    """The 2 x 2 update under ``deterministic_reductions`` runs the pencil
    Hartley's transposes and gathers partials to fold them; nothing is
    all-reduced (an all-reduce's order would follow the world)."""
    got = runs["four"][0]["det 2x2"]["collectives"]
    assert got.get("all_to_all", 0) > 0 and got.get("all_gather", 0) > 0
    assert "all_reduce" not in got


# -- the slab route of K11 ---------------------------------------------------------------


@pmp("det", [True, False])
def test_slab_forward_and_adjoint_sum_to_the_whole_grid(runs, det):
    """On 1 x 4 the ranks' slabs of the line of sight give the whole grid's
    ray values (plain forward, the NaN offset once) and its adjoint, to
    1e-12 of the per-output sum of |term|; the ray with a corner outside
    the grid stays NaN."""
    inp = runs["slab_in"]
    idx, w, scale, nan_rays = li.los_tables(inp["start"], inp["end"], DIMS,
                                            tuple(1.0 / d for d in DIMS), N_POINTS)
    tab = li.LosTable(idx, w, scale, DIMS, nan_rays)
    f = torch.from_numpy(inp["f"]).reshape(2, -1)
    ybar = torch.from_numpy(inp["ybar"])
    want_y = li.los_integrate_plain(f, tab) + tab.nan_offset
    want_g = li.los_integrate_adjoint_plain(ybar, tab).reshape((2,) + DIMS)
    scale_y = li.sum_abs_terms(tab, f=f)
    scale_g = li.sum_abs_terms(tab, ybar=ybar).reshape((2,) + DIMS).clamp_min(1e-300)
    assert nan_rays[0] and not nan_rays[1:].any()
    for rank in runs["four"]:
        got = rank[f"slab det={det}"]
        assert np.isnan(got["y"][:, 0]).all()
        np.testing.assert_array_less(np.abs(got["y"][:, 1:] - want_y[:, 1:].numpy()),
                                     1e-12 * scale_y[:, 1:].numpy())
        np.testing.assert_array_less(np.abs(got["grad"] - want_g.numpy()) / scale_g.numpy(),
                                     1e-12)


@pmp("det", [True, False])
def test_slab_route_crosses_only_ray_sized_tensors(runs, det):
    """The forward sends one tensor of (B, rows, R) (the (ray, row)
    partials, ``deterministic_reductions``) or (B, R) (the rays' partials,
    all-reduced); the adjoint sends nothing."""
    for rank in runs["four"]:
        got = rank[f"slab det={det}"]
        counts, nbytes = got["forward"]
        kind = "all_gather" if det else "all_reduce"
        rows = DIMS[0] // 4 if det else 1
        assert counts == {kind: 1}
        assert nbytes == {kind: 2 * rows * N_RAYS * 8}
        assert got["adjoint"] == ({}, {})


@pmp("det", [True, False])
def test_slab_route_bitwise_across_worlds(runs, det):
    """Under ``deterministic_reductions`` the 4 ranks' ray values and
    adjoint equal one rank's bitwise; the adjoint is bitwise in both
    modes (a cell's sum keeps the global ray order)."""
    one = runs["one"][f"slab det={det}"]
    for rank in runs["four"]:
        got = rank[f"slab det={det}"]
        np.testing.assert_array_equal(got["grad"], one["grad"])
        if det:
            np.testing.assert_array_equal(got["y"], one["y"])
    ranks = [r[f"slab det={det}"]["rows"] for r in runs["four"]]
    assert ranks == [(4 * i, 4 * i + 4) for i in range(4)]


@pmp("p", [1, 2, 4])
@pmp("det", [True, False])
def test_slab_pair_is_adjoint(p, det, rng):
    """Each rank's slab forward and slab adjoint (plain versions) are each
    other's transposes, ``<A x, y> = <x, A^T y>``, and their sum over the
    slabs is the whole grid's, with the (ray, row) partials folded over
    the rows."""
    start, end = _rays()
    idx, w, scale, nan_rays = li.los_tables(start, end, DIMS, tuple(1.0 / d for d in DIMS),
                                            N_POINTS)
    tab = li.LosTable(idx, w, scale, DIMS, nan_rays)
    x = torch.from_numpy(rng.normal(size=(3,) + DIMS))
    y = torch.from_numpy(rng.normal(size=(3, N_RAYS)))
    n = DIMS[0] // p
    slabs = [li.LosSlab(idx, w, scale, DIMS, (i * n, i * n + n), nan_rays) for i in range(p)]
    xs = [x[:, i * n:i * n + n].reshape(3, -1).contiguous() for i in range(p)]
    fwd = [li.slab_forward_plain(xi, s, det) for xi, s in zip(xs, slabs)]
    adj = [li.slab_adjoint_plain(y, s) for s in slabs]
    for xi, f, g in zip(xs, fwd, adj):
        f = _fold_halving(f) if det else f
        np.testing.assert_allclose((f * y).sum(1), (xi * g).sum(1), rtol=1e-12)
    total = _fold_halving(torch.cat(fwd, 1)) if det else sum(fwd)
    whole = li.los_integrate_plain(x.reshape(3, -1), tab)
    np.testing.assert_allclose(total, whole, rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(torch.cat([g.reshape(3, n, -1) for g in adj], 1).reshape(3, -1),
                                  li.los_integrate_adjoint_plain(y, tab))


def test_slab_tables_hold_every_entry_once():
    """The virtual rays (ray, row) of the slabs of 2 ranks hold each valid
    entry of the whole table once, compact in entry order, each at its
    pair's place ``(row - r0) * R + ray`` in the partials."""
    start, end = _rays()
    idx, w, scale, _ = li.los_tables(start, end, DIMS, tuple(1.0 / d for d in DIMS), N_POINTS)
    slabs = [li.LosSlab(idx, w, scale, DIMS, (8 * i, 8 * i + 8)) for i in range(2)]
    assert sum(s.v_idx.numel() for s in slabs) == int((idx >= 0).sum())
    row_cells = DIMS[1] * DIMS[2]
    for s in slabs:
        r0 = s.rows[0]
        off, cells, wv = s.v_off.numpy(), s.v_idx.numpy(), s.v_w.numpy()
        assert s.table.n_valid == off[-1] == cells.size and s.n_virtual == off.size - 1
        for v, d in enumerate(s.v_dest.numpy()):
            ray, row = d % N_RAYS, r0 + d // N_RAYS
            ents = np.flatnonzero(idx[ray] // row_cells == row)
            np.testing.assert_array_equal(cells[off[v]:off[v + 1]] + r0 * row_cells, idx[ray, ents])
            np.testing.assert_array_equal(wv[off[v]:off[v + 1]], w[ray, ents])
            assert s.v_scale[v] == scale[ray]


# -- the whole-grid wrappers refuse a slab -----------------------------------------------


def test_integrate_refuses_half_slabs_of_two_samples():
    """Two samples' half slabs have the cells of one whole field: the
    unsharded integral raises, naming both shapes, instead of taking them
    for one."""
    start, end = _rays()
    los = jt.SamplingCartesianGridLOS(start, end, shape=DIMS, distances=(1 / 16,) * 3,
                                      n_sampling_points=N_POINTS, device="cpu")
    half = torch.zeros((2, 8, 16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"\(2, 8, 16, 16\).*\(16, 16, 16\).*mesh"):
        li.integrate(half, los.table(torch.float64))
    with pytest.raises(ValueError, match="shard_position"):
        los(half)


def test_integrate_adjoint_refuses_a_wrong_ray_axis():
    start, end = _rays()
    tab = jt.SamplingCartesianGridLOS(start, end, shape=DIMS, distances=(1 / 16,) * 3,
                                      n_sampling_points=N_POINTS,
                                      device="cpu").table(torch.float64)
    with pytest.raises(ValueError, match=r"\(2, 24\).*\(48,\).*mesh"):
        li.integrate_adjoint(torch.zeros((2, 24), dtype=torch.float64), tab)


def test_ray_space_data_is_never_cut():
    """On a 1 x 1 mesh the grid is recorded as the field's, so ray-space
    data of two dimensions, a (R, 3) array or (R, E) table, stays whole;
    the field-sized data of a 2-D field is still cut by the shape rule."""
    mesh = make_mesh(1, 1)
    mesh.field_grids.add(DIMS)
    assert not mesh.cuts((N_RAYS, 3))
    assert not mesh.cuts((N_RAYS, 512))
    assert mesh.cuts(DIMS)
    assert make_mesh(1, 1).cuts((N_RAYS, 3))


# -- ICR on a samples mesh ---------------------------------------------------------------


def test_icr_update_on_a_samples_mesh_bitwise(runs):
    """A 1-D chart's ICR geoVI update with its samples over 2 ranks (the
    latents whole on each) equals one rank's bitwise under
    ``deterministic_reductions``."""
    want = runs["one"]["icr"]
    for rank in runs["two"]:
        got = rank["icr"]
        assert got["fun"] == want["fun"] and np.isfinite(got["fun"])
        assert _max_leaf_err(got["samples"], want["samples"]) == 0.0
        assert _max_leaf_err(got["pos"], want["pos"]) == 0.0
