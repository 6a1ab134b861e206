"""The host side of K11 on a rank's slab (``ops/los_interp.py``:
``LosSlab``, ``slab_row_partials``) at 16^3, on the CPU: the compact
virtual rays, the kernel's block descriptors and zero-fill mask, and the
plain version of the (ray, row) partials against the route of one
``los_integrate_plain`` a power-of-two width (the virtual rays padded with
-1, placed in zeros) and, folded over the slabs, against the JAX package's
line of sight on the same numpy inputs.

Tolerances: 1e-13 of the per-partial sum of |term| against the padded
route (the same terms, summed by another reduction), 1e-12 against the JAX
package (its ``map_coordinates`` sums a ray's points in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
from nifty_tpu_torch.ops import los_interp as li  # noqa: E402
from nifty_tpu_torch.tree import _fold_halving  # noqa: E402

pmp = pytest.mark.parametrize
DIMS = (16, 16, 16)
N_RAYS, N_POINTS = 48, 64
ROW_CELLS = DIMS[1] * DIMS[2]


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _geometry(seed=7, far_face=False):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.05, 0.95, size=(N_RAYS, 3))
    end = rng.uniform(0.05, 0.95, size=(N_RAYS, 3))
    if far_face:
        start[0], end[0] = (1.0, 0.2, 0.3), (1.0, 0.8, 0.6)
    return start, end


def _tables(dtype=np.float64, far_face=False):
    start, end = _geometry(far_face=far_face)
    return li.los_tables(start, end, DIMS, tuple(1.0 / d for d in DIMS), N_POINTS, 1, dtype)


def _slabs(p, dtype=np.float64):
    idx, w, scale, nan_rays = _tables(dtype)
    n = DIMS[0] // p
    return [li.LosSlab(idx, w, scale, DIMS, (i * n, i * n + n), nan_rays) for i in range(p)]


def _padded_route(f, idx, w, scale, rows, absolute=False):
    """The (ray, row) partials by one table a power-of-two width ``W``: each
    virtual ray's entries in entry order, padded with -1 to ``W``, through
    ``los_integrate_plain`` (or the sum of |term|), placed in zeros."""
    r0, r1 = rows
    lo, hi = r0 * ROW_CELLS, r1 * ROW_CELLS
    inside = (idx >= lo) & (idx < hi)
    ray, ent = np.nonzero(inside)
    vid = ray * DIMS[0] + idx[ray, ent] // ROW_CELLS
    order = np.argsort(vid, kind="stable")
    ray, ent = ray[order], ent[order]
    vray, first, count = np.unique(vid[order], return_index=True, return_counts=True)
    width = 1 << np.ceil(np.log2(count)).astype(np.int64)
    out = f.new_zeros((f.shape[0], (r1 - r0) * N_RAYS))
    for wdt in np.unique(width):
        sel = np.flatnonzero(width == wdt)
        b_idx = np.full((sel.size, wdt), -1, dtype=np.int32)
        b_w = np.zeros((sel.size, wdt), dtype=w.dtype)
        for k, v in enumerate(sel):
            span = slice(first[v], first[v] + count[v])
            b_idx[k, :count[v]] = idx[ray[span], ent[span]] - lo
            b_w[k, :count[v]] = w[ray[span], ent[span]]
        b_ray = vray[sel] // DIMS[0]
        tab = li.LosTable(b_idx, b_w, scale[b_ray], (r1 - r0,) + DIMS[1:])
        vals = li.sum_abs_terms(tab, f=f) if absolute else li.los_integrate_plain(f, tab)
        dest = torch.from_numpy((vray[sel] % DIMS[0] - r0) * N_RAYS + b_ray)
        out[:, dest] = vals
    return out.reshape(f.shape[0], r1 - r0, N_RAYS)


@pmp("count", [(1, 1024), (1025, 2048), (2049, 4096)], ids=["to1024", "to2048", "to4096"])
def test_lanes_of_a_count_are_those_of_its_power_of_two(count):
    """A compact virtual ray of ``c`` entries runs on the lanes a padded one
    of the next power of two ran on, so it takes the same terms in the
    same order: the kernel's bits do not follow the padding."""
    for c in range(count[0], count[1] + 1):
        assert li.lanes_per_ray(c) == li.lanes_per_ray(1 << (c - 1).bit_length())


@pmp("p", [1, 2, 4])
def test_block_descriptors_serve_every_virtual_ray_once(p):
    """The blocks' (first, end, lanes, lanes a thread) cover the virtual
    rays in order, each once, ``THREADS`` threads' worth a block (the last
    of a class may hold fewer), every one on the lanes its entry count
    gives it and the lanes a thread ``slab_lanes_per_thread`` gives it;
    the classes run by lanes, the most a thread first."""
    for s in _slabs(p):
        blocks = s.v_blocks.numpy()
        counts = np.diff(s.v_off.numpy())
        assert blocks.shape[1] == 4
        assert blocks[0, 0] == 0 and blocks[-1, 1] == s.n_virtual == counts.size
        np.testing.assert_array_equal(blocks[1:, 0], blocks[:-1, 1])
        assert np.all(blocks[:, 1] > blocks[:, 0])
        per = li.THREADS * blocks[:, 3] // blocks[:, 2]
        assert np.all(blocks[:, 1] - blocks[:, 0] <= per)
        same = np.all(blocks[1:, 2:] == blocks[:-1, 2:], axis=1)
        assert np.all((blocks[:-1, 1] - blocks[:-1, 0] == per[:-1])[same])
        order = blocks[:, 2] * (li.BATCH + 1) - blocks[:, 3]
        assert np.all(np.diff(order) >= 0)
        for first, end, lanes, per_thread in blocks:
            for c in counts[first:end]:
                assert li.lanes_per_ray(int(c)) == lanes
                assert li.slab_lanes_per_thread(int(lanes), int(c)) == per_thread
        assert s.n_blocks == blocks.shape[0]
        assert sum(s.groups.values()) == s.n_virtual


@pmp("count", [(1, 256), (257, 4096)], ids=["warp", "wider"])
def test_a_thread_plays_whole_lanes_and_loads_one_batch(count):
    """A thread of the slab kernel plays a power of two of its group's
    lanes, at most ``BATCH`` and one in a group wider than a warp (whose
    warps meet in shared memory), so that the group's threads tile it, a
    batch's entries go round the thread's lanes evenly and no thread walks
    more than ``BATCH`` entries (one batch of loads each) up to ``BATCH *
    THREADS`` entries, a group's most; it plays as many as that allows."""
    for c in range(count[0], count[1] + 1):
        group = li.lanes_per_ray(c)
        k = li.slab_lanes_per_thread(group, c)
        assert k & (k - 1) == 0 and group % k == 0 and li.BATCH % k == 0
        assert k == 1 if group > 32 else 1 <= k <= li.BATCH
        assert -(-c // (group // k)) <= li.BATCH or c > li.BATCH * li.THREADS
        if group <= 32 and k < min(group, li.BATCH):
            assert -(-c // (group // (2 * k))) > li.BATCH


def _lane_butterfly(lanes, width):
    """The kernels' butterfly over ``width`` lane values: lane x adds lane
    x ^ o for o = 16, 8, ... 1 below ``width``; lane 0's value."""
    v, x = lanes.copy(), np.arange(lanes.size)
    for o in (16, 8, 4, 2, 1):
        if o < width:
            v = v + v[x ^ o]
    return v[0]


def _group_sum(terms, group):
    """``los_forward``'s sum of a ray's terms on ``group`` lanes: lane l adds
    terms l, l + group, ... in order from +0, then the butterfly."""
    lanes = np.zeros(group, dtype=terms.dtype)
    for e, term in enumerate(terms):
        lanes[e % group] += term
    return _lane_butterfly(lanes, group)


def _threads_sum(terms, group, k):
    """The slab kernel's sum: ``k`` lanes a thread, ``span = group // k``
    threads; thread t walks terms t, t + span, ..., its n-th into lane n %
    k, then adds lanes j and j + h within the thread for h from k / 2 down,
    then the butterfly over the threads."""
    span = group // k
    acc = np.zeros((span, k), dtype=terms.dtype)
    for e, term in enumerate(terms):
        acc[e % span, (e // span) % k] += term
    h = k // 2
    while h:
        acc[:, :h] = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return _lane_butterfly(acc[:, 0], span)


@pmp("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_threads_playing_several_lanes_keep_the_bits(dtype, rng):
    """Emulated on the CPU, a virtual ray of every entry count up to 256
    (the groups of a warp or less) summed by threads that play 2, 4 or 8
    lanes (every count the kernel may be given, not only
    ``slab_lanes_per_thread``'s) equals, bit for bit, its sum by a lane a
    thread: the bits follow the lanes, not the threads."""
    for c in range(1, 257):
        group = li.lanes_per_ray(c)
        for k in (k for k in (2, 4, 8) if k <= group):
            terms = rng.normal(size=c).astype(dtype) * dtype(10.0) ** rng.integers(-3, 4, c)
            want, got = _group_sum(terms, group), _threads_sum(terms, group, k)
            assert want.tobytes() == got.tobytes(), (c, group, k, want, got)


@pmp("p", [1, 2, 4])
def test_zero_fill_mask_is_the_complement_of_the_destinations(p):
    """Bit ``q`` of the mask is set exactly where pair ``q`` holds no
    virtual ray; the words' bits past the pairs are clear; every virtual
    ray has a pair of its own."""
    for s in _slabs(p):
        words = s.empty.numpy().view(np.uint32)
        assert words.size == -(-s.nout // 32)
        bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)
        held = np.zeros(bits.size, dtype=bool)
        held[s.v_dest.numpy()] = True
        assert np.unique(s.v_dest.numpy()).size == s.n_virtual
        np.testing.assert_array_equal(bits[:s.nout], ~held[:s.nout])
        assert not bits[s.nout:].any()


def test_compact_tables_are_smaller_than_the_padded_ones():
    """The compact virtual rays with their descriptors and mask take fewer
    bytes than the padded tables' indices and weights alone."""
    idx, *_ = _tables()
    for s in _slabs(2):
        inside = (idx >= s.rows[0] * ROW_CELLS) & (idx < s.rows[1] * ROW_CELLS)
        ray, ent = np.nonzero(inside)
        _, count = np.unique(ray * DIMS[0] + idx[ray, ent] // ROW_CELLS, return_counts=True)
        padded = int((1 << np.ceil(np.log2(count)).astype(np.int64)).sum()) * (4 + 8)
        compact = sum(b.numel() * b.element_size() for name, b in s.named_buffers()
                      if not name.startswith("table.") and name != "nan_offset")
        assert s.table_bytes == compact < padded


@pmp("rows", [1, 3, "vmap"])
@pmp("p", [1, 2, 4])
def test_plain_partials_match_the_padded_route(p, rows, rng):
    """The plain version on the compact layout against the padded route,
    within 1e-13 of the per-partial sum of |term|, for 1 and 3 rows and
    under ``torch.func.vmap`` of the slab forward (two rows a slice, the
    partials folded over the rows); pairs without a virtual ray are +0."""
    idx, w, scale, _ = _tables()
    for s in _slabs(p):
        nrows = 3 if rows == "vmap" else rows
        f = torch.from_numpy(rng.normal(size=(nrows, 2, s.ncells)))
        if rows == "vmap":
            got = torch.func.vmap(lambda x: li.LosSlabIntegrate.apply(x, s, None, True))(f)
            want = torch.stack([_fold_halving(_padded_route(x, idx, w, scale, s.rows))
                                for x in f])
            tol = torch.stack([_fold_halving(_padded_route(x.abs(), idx, w, scale, s.rows, True))
                               for x in f])
        else:
            x = f[:, 0].contiguous()
            got = li.slab_row_partials(x, s)
            want = _padded_route(x, idx, w, scale, s.rows)
            tol = _padded_route(x.abs(), idx, w, scale, s.rows, True)
            torch.testing.assert_close(li.slab_sum_abs_terms(s, x), tol, rtol=1e-14, atol=0)
            zero = got == 0
            assert not bool(torch.signbit(got[zero]).any())
        assert got.shape == want.shape
        assert bool(torch.all((got - want).abs() <= 1e-13 * tol))


@pmp("p", [1, 2, 4])
def test_partials_csr_is_the_slab_forward(p, rng):
    """``partials_csr`` times the fields is the plain version of the
    partials, within 1e-13 of the per-partial sum of |term|: the CSR the
    library route multiplies holds the same map as the compact layout."""
    for s in _slabs(p):
        f = torch.from_numpy(rng.normal(size=(3, s.ncells)))
        csr = s.partials_csr()
        assert csr.layout == torch.sparse_csr and csr.shape == (s.nout, s.ncells)
        got = torch.sparse.mm(csr, f.T).T.reshape(3, -1, s.nrays)
        want = li.slab_row_partials_plain(f, s)
        tol = li.slab_sum_abs_terms(s, f)
        assert bool(torch.all((got - want).abs() <= 1e-13 * tol))


def test_slab_refuses_lanes_its_kernel_does_not_play(monkeypatch):
    """A virtual ray given lanes a thread that the kernel has no case for
    (it would run them as one lane) is refused when the slab is built."""
    idx, w, scale, nan_rays = _tables()
    monkeypatch.setattr(li, "slab_lanes_per_thread", lambda group, nent: 16)
    with pytest.raises(ValueError, match="lanes a thread"):
        li.LosSlab(idx, w, scale, DIMS, (0, 8), nan_rays)


@pmp("p", [1, 2, 4])
def test_folded_slab_partials_match_the_jax_line_of_sight(p, rng):
    """The slabs' partials concatenated over the rows and folded, plus the
    NaN offset, are the JAX package's ``SamplingCartesianGridLOS`` on the
    same field (a ray along the far face NaN in both)."""
    start, end = _geometry(far_face=True)
    idx, w, scale, nan_rays = _tables(far_face=True)
    los = jft.SamplingCartesianGridLOS(start, end, shape=DIMS,
                                       distances=tuple(1.0 / d for d in DIMS),
                                       n_sampling_points=N_POINTS)
    x = rng.normal(size=DIMS)
    want = np.asarray(los(jnp.asarray(x)))
    n = DIMS[0] // p
    slabs = [li.LosSlab(idx, w, scale, DIMS, (i * n, i * n + n), nan_rays) for i in range(p)]
    flat = torch.from_numpy(x).reshape(1, DIMS[0], -1)
    parts = [li.slab_row_partials(flat[:, i * n:i * n + n].reshape(1, -1).contiguous(), s)
             for i, s in enumerate(slabs)]
    sums = [li.slab_sum_abs_terms(s, flat[:, i * n:i * n + n].reshape(1, -1).contiguous())
            for i, s in enumerate(slabs)]
    got = (_fold_halving(torch.cat(parts, 1)) + slabs[0].nan_offset)[0].numpy()
    tol = _fold_halving(torch.cat(sums, 1))[0].numpy()
    assert nan_rays[0] and np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_array_less(np.abs(got[1:] - want[1:]), 1e-12 * tol[1:] + 1e-300)


def test_slab_forward_uses_no_kernel_on_the_cpu_and_refuses_other_devices():
    """On the CPU the plain version runs and no launch is counted; a tensor
    on another device (here ``meta``) raises instead of falling back."""
    s = _slabs(2)[0]
    li.reset_launch_counts()
    li.slab_row_partials(torch.zeros((1, s.ncells), dtype=torch.float64), s)
    assert li.slab_row_partials.launches == 0 and not li.slab_row_partials.launches_by_shape
    meta = s.to("meta")
    with pytest.raises(RuntimeError, match="meta"):
        li.slab_row_partials(torch.zeros((1, s.ncells), dtype=torch.float64, device="meta"), meta)
    with pytest.raises(TypeError):
        li.slab_row_partials(torch.zeros((1, s.ncells), dtype=torch.float32), s)
    with pytest.raises(ValueError, match="shape"):
        li.slab_row_partials(torch.zeros((1, s.ncells + 1), dtype=torch.float64), s)


@pmp("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_slab_buffers_follow_to_and_keep_their_types(dtype):
    """The compact tables are non-persistent buffers in the table's float
    type, int32 where they index; a float type conversion leaves the index
    tables alone."""
    s = _slabs(2, dtype)[0]
    want = torch.float32 if dtype == np.float32 else torch.float64
    assert s.v_w.dtype == s.v_scale.dtype == s.table.w.dtype == want
    for name in ("v_off", "v_idx", "v_dest", "v_blocks", "empty"):
        assert getattr(s, name).dtype == torch.int32
        assert name in dict(s.named_buffers()) and name not in s.state_dict()
    half = s.to(torch.float32)
    assert half.v_w.dtype == torch.float32 and half.v_idx.dtype == torch.int32
