"""The refinement step K9 (``nifty_tpu_torch.ops.icr_refine``) on the CPU:
its plain versions and the wrappers' CPU route against the JAX package's
level step (``nifty_tpu/refine/charted_field.py:289-302``,
``healpix_field.py:195-221``) on the same numpy inputs, the transpose
against a dense operator built from the tables and against autograd, the
CSR inverse of the window tables against a dense incidence (repeated
window entries included), and the ``autograd.Function`` pair's ``jvp``,
``vjp``, ``vmap`` and double backward against the plain route.

Tolerances: against the JAX step 1e-10 of the largest entry (each package
builds its own matrices, which agree to ~1e-11 on these well-conditioned
Matern kernels, and sums in its own order); against the dense operator
and autograd 1e-12 (the same products, summed in another order); the
wrapper's CPU route and the Function's transforms equal the plain
version to the bit.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.refine import charted_field as jcf  # noqa: E402
from nifty_tpu.refine import chart as jc, healpix_field as jhf  # noqa: E402
from nifty_tpu_torch.ops import icr_refine as ir  # noqa: E402
from nifty_tpu_torch.refine import chart as tc, charted_field as tcf  # noqa: E402
from nifty_tpu_torch.refine import healpix_field as thf  # noqa: E402

torch.set_num_threads(1)

RTOL_JAX = 1e-10
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _matern_j(r):
    return (1.0 + r / 0.7) * jnp.exp(-r / 0.7)


def _matern_t(r):
    return (1.0 + r / 0.7) * torch.exp(-r / 0.7)


def _warp(reg):
    return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)


def _radial(mod):
    return mod.CoordinateChart(5, depth=2, distances0=0.2, nonlinear_map=lambda x: 1.0 + x)


# name -> (package -> field): every window route a level can take
FIELDS = {
    "irregular_shape_2d": lambda m, cf, k: cf.RefinementField(
        m.CoordinateChart((9, 6), depth=2, distances0=(0.5, 0.8)), k),
    "periodic": lambda m, cf, k: cf.RefinementField(
        m.CoordinateChart((8, 8), depth=1, distances0=0.5, periodic=(True, False)), k),
    "jump_5_4": lambda m, cf, k: cf.RefinementField(
        m.CoordinateChart((8, 7), depth=1, distances0=0.4, coarse_size=5, fine_size=4,
                          fine_strategy="jump"), k),
    "deformed": lambda m, cf, k: cf.RefinementField(
        m.CoordinateChart((8, 7), depth=2, distances0=0.4, nonlinear_map=_warp), k),
    "extend_5_2_3d": lambda m, cf, k: cf.RefinementField(
        m.CoordinateChart((6, 5, 5), depth=1, distances0=0.4, coarse_size=5, fine_size=2,
                          periodic=(False, True, False)), k),
    "sphere": lambda m, hf, k: hf.RefinementHPField(hf.HEALPixChart(2, depth=2), k),
    "sphere_radius": lambda m, hf, k: hf.RefinementHPField(
        hf.HEALPixChart(1, depth=2, radial_chart=_radial(m)), k),
}


def _build(name, jax_side):
    m, k = (jc, _matern_j) if jax_side else (tc, _matern_t)
    sub = ((jhf if jax_side else thf) if name.startswith("sphere")
           else (jcf if jax_side else tcf))
    return FIELDS[name](m, sub, k)


@pytest.fixture(scope="module")
def fields():
    return {name: (_build(name, True), _build(name, False)) for name in FIELDS}


def _jax_step(jf, level, coarse, xi):
    """The JAX package's refinement step of ``level`` on rows of flat
    coarse values and excitations: the lines of its fields' ``__call__``."""
    if isinstance(jf, jcf.RefinementField):
        chart = jf.chart
        _, olfs, kers = jf._matrices
        ndim = chart.ndim

        def one(c, x):
            field = c.reshape(chart.shapes[level])
            x = x.reshape(chart.site_counts(level) + (chart.fine_size ** ndim,))
            windows = jcf.coarse_windows(field, ndim, chart=chart, level=level)
            olf, ker = jnp.asarray(olfs[level]), jnp.asarray(kers[level])
            if olf.ndim == 2:
                y = jnp.einsum("...w,fw->...f", windows, olf) + jnp.einsum("...e,fe->...f", x, ker)
            else:
                ns = windows.shape[:ndim]
                y = (jnp.einsum("...w,...fw->...f", windows,
                                jnp.broadcast_to(olf, ns + olf.shape[-2:]))
                     + jnp.einsum("...e,...fe->...f", x, jnp.broadcast_to(ker, ns + ker.shape[-2:])))
            return jcf._interleave_children(y, ndim, chart.fine_size).reshape(-1)
    else:
        _, olfs, kers, windows = jf._matrices
        shape = jf.chart.shapes[level]

        def one(c, x):
            field = c.reshape(shape)
            w = field[jnp.asarray(windows[level])]
            if len(shape) == 1:
                y = (jnp.einsum("pw,pfw->pf", w, jnp.asarray(olfs[level]))
                     + jnp.einsum("pe,pfe->pf", x.reshape(shape[0], 4), jnp.asarray(kers[level])))
                return y.reshape(-1)
            npix, nr = shape
            w = jnp.stack([w[:, :, q:q + 3] for q in range(nr - 2)], axis=1).reshape(npix, nr - 2, 27)
            y = (jnp.einsum("pqw,pqfw->pqf", w, jnp.asarray(olfs[level]))
                 + jnp.einsum("pqe,pqfe->pqf", x.reshape(npix, nr - 2, 8), jnp.asarray(kers[level])))
            y = jnp.transpose(y.reshape(npix, nr - 2, 4, 2), (0, 2, 1, 3))
            return y.reshape(-1)
    return np.asarray(jax.vmap(one)(jnp.asarray(coarse), jnp.asarray(xi)))


def _inputs(level, nrows, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nrows, level.n_coarse)),
            rng.standard_normal((nrows, level.S * level.F)),
            rng.standard_normal((nrows, level.n_fine)))


def _close(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _levels():
    return [(name, lv) for name in FIELDS for lv in range(2 if name not in (
        "periodic", "jump_5_4", "extend_5_2_3d") else 1)]


@pytest.mark.parametrize("name,lv", _levels())
@pytest.mark.parametrize("nrows", [1, 3])
def test_plain_step_and_cpu_route_match_the_jax_step(fields, name, lv, nrows):
    jf, tf = fields[name]
    level = tf.levels[lv]
    coarse, xi, _ = _inputs(level, nrows, seed=lv)
    want = _jax_step(jf, lv, coarse, xi)
    c, x = torch.from_numpy(coarse), torch.from_numpy(xi)
    plain = ir.icr_refine_plain(c, x, level)
    _close(plain, want, RTOL_JAX)
    before = ir.icr_refine.launches
    assert torch.equal(ir.icr_refine(c, x, level), plain)
    assert ir.icr_refine.launches == before  # the CPU route is not a launch


def _dense(level):
    """The step as dense matrices (A_coarse (n_fine, n_coarse), A_xi (n_fine,
    S F)), built with numpy from the tables, strides and matrices."""
    d = level.ndim
    tabs = [getattr(level, f"window{a}").numpy().astype(np.int64) for a in range(d)]
    win = np.zeros(level.sites + level.slots, dtype=np.int64)
    fine = np.zeros(level.sites + level.child_shape, dtype=np.int64)
    msite = np.zeros(level.sites, dtype=np.int64)
    for a in range(d):
        shape = [1] * (2 * d)
        shape[a], shape[d + a] = level.sites[a], level.slots[a]
        win = win * level.coarse_shape[a] + tabs[a].reshape(shape)
        shape[d + a] = level.child_shape[a]
        pos = (np.arange(level.sites[a])[:, None] * level.child_shape[a]
               + np.arange(level.child_shape[a])[None, :])
        fine = fine * level.fine_shape[a] + pos.reshape(shape)
        mshape = [1] * d
        mshape[a] = level.sites[a]
        msite = msite + level.mstrides[a] * np.arange(level.sites[a]).reshape(mshape)
    win, fine, msite = win.reshape(level.S, level.W), fine.reshape(level.S, level.F), msite.ravel()
    olf, ker = level.olf.numpy()[msite], level.ker.numpy()[msite]  # (S, F, W), (S, F, F)
    a_c = np.zeros((level.n_fine, level.n_coarse))
    np.add.at(a_c, (fine[:, :, None], win[:, None, :]), olf)
    a_x = np.zeros((level.n_fine, level.S * level.F))
    cols = np.arange(level.S * level.F).reshape(level.S, 1, level.F)
    np.add.at(a_x, (fine[:, :, None], cols), ker)
    return a_c, a_x, win


@pytest.mark.parametrize("name,lv", _levels())
def test_step_and_transpose_against_the_dense_operator(fields, name, lv):
    level = fields[name][1].levels[lv]
    coarse, xi, cot = _inputs(level, 2, seed=10 + lv)
    a_c, a_x, _ = _dense(level)
    _close(ir.icr_refine_plain(torch.from_numpy(coarse), torch.from_numpy(xi), level),
           coarse @ a_c.T + xi @ a_x.T, RTOL)
    got_c, got_x = ir.icr_refine_transpose(torch.from_numpy(cot), level)
    _close(got_c, cot @ a_c, RTOL)
    _close(got_x, cot @ a_x, RTOL)


@pytest.mark.parametrize("name,lv", _levels())
def test_csr_inverse_matches_a_dense_incidence(fields, name, lv):
    """The product of the per-axis inverses lists every (site, slot) that
    reads a coarse entry, as often as it reads it: the transpose's sums."""
    level = fields[name][1].levels[lv]
    _, _, win = _dense(level)
    want = np.zeros((level.n_coarse, level.S * level.W), dtype=np.int64)
    np.add.at(want, (win.ravel(), np.arange(win.size)), 1)
    got = np.zeros_like(want)
    d = level.ndim
    offs = [getattr(level, f"inverse_offsets{a}").numpy() for a in range(d)]
    invs = [getattr(level, f"inverse{a}").numpy() for a in range(d)]
    for c in range(level.n_coarse):
        ca = np.unravel_index(c, level.coarse_shape)
        lists = [invs[a][offs[a][ca[a]]:offs[a][ca[a] + 1]] for a in range(d)]
        for combo in np.array(np.meshgrid(*lists, indexing="ij")).reshape(d, -1).T:
            s = np.ravel_multi_index([k // level.slots[a] for a, k in enumerate(combo)], level.sites)
            w = np.ravel_multi_index([k % level.slots[a] for a, k in enumerate(combo)], level.slots)
            got[c, s * level.W + w] += 1
    np.testing.assert_array_equal(got, want)
    if name.startswith("sphere"):  # a missing corner neighbour repeats the centre
        assert any(len(set(row)) < len(row) for row in win)


def test_repeated_window_entries_add_up():
    """A window that names one coarse entry twice pulls its cotangent back
    twice."""
    windows = [np.array([[0, 0, 1], [1, 2, 2]])]
    olf = torch.tensor([[[1.0, 2.0, 3.0]], [[4.0, 5.0, 6.0]]], dtype=torch.float64)
    ker = torch.tensor([[[0.5]], [[0.25]]], dtype=torch.float64)
    level = ir.RefineLevel((3,), windows, (1,), olf, ker, (2,))
    coarse = torch.tensor([[1.0, 10.0, 100.0]], dtype=torch.float64)
    xi = torch.tensor([[2.0, 4.0]], dtype=torch.float64)
    assert ir.icr_refine(coarse, xi, level).tolist() == [[1 + 2 + 30 + 1.0, 40 + 500 + 600 + 1.0]]
    cot_c, cot_x = ir.icr_refine_transpose(torch.tensor([[1.0, 1.0]], dtype=torch.float64), level)
    assert cot_c.tolist() == [[3.0, 7.0, 11.0]] and cot_x.tolist() == [[0.5, 0.25]]
    offsets, positions = ir.window_inverse(windows[0], 3)
    assert offsets.tolist() == [0, 2, 4, 6] and positions.tolist() == [0, 1, 2, 3, 4, 5]


def test_function_transforms_match_the_plain_route(fields):
    level = fields["deformed"][1].levels[1]
    coarse, xi, cot = (torch.from_numpy(a) for a in _inputs(level, 3, seed=5))
    dc, dx, _ = (torch.from_numpy(a) for a in _inputs(level, 3, seed=6))

    def step(c, x):
        return ir.IcrRefine.apply(c, x, level)

    y, ty = torch.func.jvp(step, (coarse, xi), (dc, dx))
    assert torch.equal(y, ir.icr_refine_plain(coarse, xi, level))
    assert torch.equal(ty, ir.icr_refine_plain(dc, dx, level))
    _, pull = torch.func.vjp(step, coarse, xi)
    want = ir.icr_refine_transpose_plain(cot, level)
    for got, w in zip(pull(cot), want):
        assert torch.equal(got, w)
    # vmap over a leading axis of both inputs, of one, and of the transpose
    cv, xv = coarse.expand(4, 3, -1) * torch.arange(1.0, 5.0)[:, None, None], xi.expand(4, 3, -1)
    want = ir.icr_refine_plain(cv.reshape(12, -1), xv.reshape(12, -1), level).reshape(4, 3, -1)
    assert torch.equal(torch.func.vmap(step)(cv, xv), want)
    assert torch.equal(torch.func.vmap(lambda c: step(c, xi))(cv), want)
    ct = cot.expand(4, 3, -1) * torch.arange(1.0, 5.0)[:, None, None]
    got = torch.func.vmap(lambda t: ir.IcrRefineTranspose.apply(t, level))(ct)
    want = ir.icr_refine_transpose_plain(ct.reshape(12, -1), level)
    for g, w in zip(got, want):
        assert torch.equal(g, w.reshape(4, 3, -1))
    # the transpose's jvp is itself; its backward is the step (double
    # backward, as the metric's recorded linearization takes it)
    _, tt = torch.func.jvp(lambda t: ir.IcrRefineTranspose.apply(t, level), (cot,), (cot,))
    assert all(torch.equal(a, b) for a, b in zip(tt, ir.icr_refine_transpose_plain(cot, level)))
    c = coarse.clone().requires_grad_(True)
    x = xi.clone().requires_grad_(True)
    u = torch.zeros_like(cot, requires_grad=True)
    with torch.enable_grad():
        gc, gx = torch.autograd.grad(step(c, x), (c, x), u, create_graph=True)
        back = torch.autograd.grad((gc * dc).sum() + (gx * dx).sum(), u)[0]
    assert torch.equal(back, ir.icr_refine_plain(dc, dx, level))


def test_refine_level_takes_leading_axes(fields):
    level = fields["sphere_radius"][1].levels[0]
    coarse, xi, _ = (torch.from_numpy(a) for a in _inputs(level, 6, seed=7))
    got = ir.refine_level(coarse.reshape(2, 3, -1), xi.reshape(2, 3, -1), level)
    assert torch.equal(got.reshape(6, -1), ir.icr_refine_plain(coarse, xi, level))
    # a shared coarse field broadcast against batched excitations
    got = ir.refine_level(coarse[0], xi.reshape(2, 3, -1), level)
    assert torch.equal(got.reshape(6, -1), ir.icr_refine_plain(coarse[:1].expand(6, -1), xi, level))


def test_wrappers_validate_their_inputs(fields):
    level = fields["irregular_shape_2d"][1].levels[0]
    coarse, xi, cot = (torch.from_numpy(a) for a in _inputs(level, 2, seed=8))
    with pytest.raises(ValueError, match="shape"):
        ir.icr_refine(coarse[:, :-1], xi, level)
    with pytest.raises(TypeError, match="matrices"):
        ir.icr_refine(coarse.float(), xi.float(), level)
    with pytest.raises(ValueError, match="contiguous"):
        ir.icr_refine_transpose(torch.cat([cot, cot], 1)[:, ::2], level)
    with pytest.raises(ValueError, match="shape"):
        ir.icr_refine_transpose(cot[:, 1:], level)
    with pytest.raises(ValueError, match="lie in"):
        ir.RefineLevel((3,), [np.array([[0, 3]])], (1,), torch.zeros(1, 1, 2),
                       torch.zeros(1, 1, 1), (1,))
    with pytest.raises(RuntimeError, match="no icr_refine kernel"):
        ir.icr_refine(coarse.to("meta"), xi.to("meta"), level.to("meta"))


def test_level_buffers_move_and_stay_out_of_the_state_dict(fields):
    tf = fields["irregular_shape_2d"][1]
    assert tf.state_dict() == {}
    names = {n for n, _ in tf.named_buffers()}
    assert {"cov_sqrt0", "levels.0.olf", "levels.0.ker", "levels.1.window1",
            "levels.1.inverse_offsets0", "levels.1.inverse0"} <= names
    f32 = tcf.RefinementField(tf.chart, _matern_t, dtype=torch.float32)
    assert f32.levels[0].olf.dtype == torch.float32 and f32.cov_sqrt0.dtype == torch.float32
    assert f32.domain["xi0"].dtype == torch.float32
    # matrices are shared (one a level) on a regular chart without clamping
    reg = tcf.RefinementField(tc.CoordinateChart((8, 8), depth=2, distances0=0.5), _matern_t)
    assert [lv.n_matrices for lv in reg.levels] == [1, 1]
    # on a deformed chart they vary along its irregular axes, and are
    # broadcast (stride 0) along the others
    assert [lv.mstrides for lv in fields["deformed"][1].levels] == [(5, 1), (8, 1)]
    half = tcf.RefinementField(tc.CoordinateChart((8, 7), depth=1, distances0=0.4,
                                                   nonlinear_map=_warp, irregular_axes=(0,)),
                               _matern_t)
    assert half.levels[0].matrix_grid == (6, 1) and half.levels[0].mstrides == (1, 0)


# -- the kernels' routes and the one-pass transpose's schedule ------------------


def _demo9_like():
    """Demo 9's chart: (14,), depth 3, the log deformation (matrices by site)."""
    return tcf.RefinementField(tc.CoordinateChart(shape0=(14,), depth=3, distances0=(1.0,),
                                                  nonlinear_map=lambda reg: np.expm1(0.35 * reg)),
                               _matern_t)


def _schedule_levels(fields):
    """(name, level, boxes): a 1-D deformed chart, a deformed 2-D chart at odd
    extents and a sphere x radius level, with boxes that leave every axis's
    last box ragged."""
    out = [("demo9", lv, (5,)) for lv in _demo9_like().levels]
    out += [("deformed", lv, (3, 4)) for lv in fields["deformed"][1].levels]
    out += [("sphere_radius", lv, (7, 3)) for lv in fields["sphere_radius"][1].levels]
    return out


def _site_axes(level, s):
    return np.unravel_index(s, level.sites)


def _inverse_pairs(level, c):
    """Coarse entry c's (site, slot) pairs in the CSR order: the product of
    its axes' inverse lists, the last axis fastest."""
    d = level.ndim
    ca = np.unravel_index(c, level.coarse_shape)
    lists = []
    for a in range(d):
        off = getattr(level, f"inverse_offsets{a}").numpy()
        inv = getattr(level, f"inverse{a}").numpy()
        lists.append(inv[off[ca[a]]:off[ca[a] + 1]])
    for combo in np.array(np.meshgrid(*lists, indexing="ij")).reshape(d, -1).T:
        sa = [int(k) // level.slots[a] for a, k in enumerate(combo)]
        wa = [int(k) % level.slots[a] for a, k in enumerate(combo)]
        yield sa, wa


def _boxes(level, box):
    """Every box of the schedule: (box coordinates, its coarse ranges, its
    halo ranges), from :func:`ir.box_schedule`."""
    tables = [getattr(level, f"window{a}").numpy() for a in range(level.ndim)]
    halos, owners = ir.box_schedule(tables, level.coarse_shape, box)
    for k in np.ndindex(*[len(h) for h in halos]):
        crange = [(k[a] * box[a], min((k[a] + 1) * box[a], level.coarse_shape[a]))
                  for a in range(level.ndim)]
        hrange = [tuple(halos[a][k[a]]) for a in range(level.ndim)]
        yield k, crange, hrange, owners


@pytest.mark.parametrize("index", range(7))
def test_box_schedule_covers_every_pair_once(fields, index):
    """Every coarse entry lies in one box, every (site, slot) pair of its
    inverse lies in that box's halo (so the box's shared memory holds it),
    and every site has one owner, whose halo holds it."""
    name, level, box = _schedule_levels(fields)[index]
    assert any(level.coarse_shape[a] % box[a] for a in range(level.ndim))  # ragged
    seen = np.zeros(level.n_coarse, dtype=np.int64)
    pairs = 0
    owned = np.zeros(level.S, dtype=np.int64)
    for k, crange, hrange, owners in _boxes(level, box):
        for ca in np.ndindex(*[hi - lo for lo, hi in crange]):
            c = np.ravel_multi_index([lo + i for (lo, _), i in zip(crange, ca)],
                                     level.coarse_shape)
            seen[c] += 1
            for sa, _ in _inverse_pairs(level, c):
                assert all(lo <= s < hi for s, (lo, hi) in zip(sa, hrange)), (name, k, c, sa)
                pairs += 1
        for sa in np.ndindex(*[hi - lo for lo, hi in hrange]):
            sa = [lo + i for (lo, _), i in zip(hrange, sa)]
            if all(owners[a][sa[a]] == k[a] for a in range(level.ndim)):
                owned[np.ravel_multi_index(sa, level.sites)] += 1
    assert (seen == 1).all() and (owned == 1).all()
    assert pairs == level.S * level.W  # every slot of every site reads one coarse entry


def _slot_cotangents(level, cot):
    """t[b, s, w] = sum_f olf[m(s), f, w] cot[b, i(s, f)] and x[b, s, e], summed
    in child order from 0 (the kernels' site pass)."""
    olf, ker = level.matrices()
    d = level.ndim
    c = cot.reshape((cot.shape[0],) + tuple(
        x for a in range(d) for x in (level.sites[a], level.child_shape[a])))
    c = c.permute([0] + [1 + 2 * a for a in range(d)] + [2 + 2 * a for a in range(d)])
    c = c.reshape(cot.shape[0], level.S, level.F)
    o = olf.expand(*level.sites, level.F, level.W).reshape(level.S, level.F, level.W)
    k = ker.expand(*level.sites, level.F, level.F).reshape(level.S, level.F, level.F)
    t = torch.zeros(cot.shape[0], level.S, level.W, dtype=cot.dtype)
    x = torch.zeros(cot.shape[0], level.S, level.F, dtype=cot.dtype)
    for f in range(level.F):
        t = t + o[None, :, f, :] * c[:, :, f, None]
        x = x + k[None, :, f, :] * c[:, :, f, None]
    return t, x


def _two_pass(level, t):
    """The gather pass: each coarse entry's sum of the scratch t over its CSR
    product, in order."""
    out = torch.zeros(t.shape[0], level.n_coarse, dtype=t.dtype)
    for c in range(level.n_coarse):
        acc = torch.zeros(t.shape[0], dtype=t.dtype)
        for sa, wa in _inverse_pairs(level, c):
            acc = acc + t[:, np.ravel_multi_index(sa, level.sites),
                          np.ravel_multi_index(wa, level.slots)]
        out[:, c] = acc
    return out


def _one_pass(level, t, x, box):
    """The box route as the kernel runs it: each box copies its halo's slot
    cotangents into its shared memory (t_sh[w * n_halo + h], h row-major over
    the halo), writes the excitations' cotangents of the sites it owns, and
    sums each of its coarse entries over the CSR product from t_sh."""
    nrows = t.shape[0]
    cot_c = torch.full((nrows, level.n_coarse), float("nan"), dtype=t.dtype)
    cot_x = torch.full_like(x, float("nan"))
    for k, crange, hrange, owners in _boxes(level, box):
        hn = [hi - lo for lo, hi in hrange]
        n_halo = int(np.prod(hn))
        t_sh = torch.empty(nrows, level.W * n_halo, dtype=t.dtype)
        for h in range(n_halo):
            sa = [lo + i for (lo, _), i in zip(hrange, np.unravel_index(h, hn))]
            s = np.ravel_multi_index(sa, level.sites)
            for w in range(level.W):
                t_sh[:, w * n_halo + h] = t[:, s, w]
            if all(owners[a][sa[a]] == k[a] for a in range(level.ndim)):
                cot_x[:, s] = x[:, s]
        for ca in np.ndindex(*[hi - lo for lo, hi in crange]):
            c = np.ravel_multi_index([lo + i for (lo, _), i in zip(crange, ca)],
                                     level.coarse_shape)
            acc = torch.zeros(nrows, dtype=t.dtype)
            for sa, wa in _inverse_pairs(level, c):
                h = np.ravel_multi_index([s - lo for s, (lo, _) in zip(sa, hrange)], hn)
                acc = acc + t_sh[:, np.ravel_multi_index(wa, level.slots) * n_halo + h]
            cot_c[:, c] = acc
    return cot_c, cot_x.reshape(nrows, -1)


@pytest.mark.parametrize("index", range(7))
def test_one_pass_transpose_sums_in_the_two_pass_order(fields, index):
    """The box route's order gives the two-pass order's bits, and both are
    within 1e-12 of the plain version (autograd's pull-back)."""
    _, level, box = _schedule_levels(fields)[index]
    cot = torch.from_numpy(_inputs(level, 2, seed=30 + index)[2])
    t, x = _slot_cotangents(level, cot)
    two = _two_pass(level, t)
    one_c, one_x = _one_pass(level, t, x, box)
    assert torch.equal(one_c, two) and torch.equal(one_x, x.reshape(2, -1))
    want_c, want_x = ir.icr_refine_transpose_plain(cot, level)
    _close(two, want_c.numpy(), RTOL)
    _close(one_x, want_x.numpy(), RTOL)


def _level(coarse, windows, children, grid, seed=0):
    rng = np.random.default_rng(seed)
    F, M = int(np.prod(children)), int(np.prod(grid))
    W = int(np.prod([w.shape[1] for w in windows]))
    return ir.RefineLevel(coarse, windows, children,
                          torch.from_numpy(rng.standard_normal((M, F, W))),
                          torch.from_numpy(rng.standard_normal((M, F, F))), grid)


def _runs(n, k=3):
    return np.arange(n)[:, None] + np.arange(k)[None, :]


def test_routes_follow_from_the_tables():
    # the 4100^2 chart's geometry: matrices by row; a thread a site, and
    # the one pass where the boxes fill the card, two passes below that
    big = _level((516, 516), [_runs(514), _runs(514)], (2, 2), (514, 1))
    small = _level((68, 68), [_runs(66), _runs(66)], (2, 2), (66, 1))
    assert big.routes == ("thread", "box") and small.routes == ("thread", "group")
    assert big.box == ir.BOX[2] and big.box_counts == (65, 17) and big.halo_max == (10, 34)
    # matrices by site: lane groups; a level one block covers takes the box
    per_site = _level((40, 70), [_runs(38), _runs(68)], (2, 2), (38, 68))
    assert per_site.routes == ("group", "group")
    assert _level((164,), [_runs(162)], (2,), (162,)).routes == ("group", "box")
    # matrices varying along the last axis alone, a shape with no compiled
    # kernel, three axes: a thread a fine entry, two passes
    assert _level((40, 70), [_runs(38), _runs(68)], (2, 2), (1, 68)).routes[0] == "entry"
    assert _level((9, 9), [_runs(5, 5), _runs(5, 5)], (4, 4), (1, 1)).routes == ("entry", "entry")
    assert _level((9, 8, 7), [_runs(7), _runs(6), _runs(5)], (2, 2, 2), (7, 1, 1)).routes == (
        "entry", "entry")
    # a periodic axis wraps its windows: its halos span the axis, so two
    # passes where the boxes are many
    wrap = (np.arange(600)[:, None] + np.arange(3) - 1) % 600
    assert _level((600, 600), [wrap, _runs(598)], (2, 2), (1, 1)).routes == ("thread", "group")
    # every box tables' entries
    halo0 = big._buffers["box_halo0"]
    assert halo0.dtype == torch.int32 and tuple(halo0.shape) == (65, 2)
    assert big._buffers["box_owner1"].tolist()[:40] == [0] * 32 + [1] * 8
