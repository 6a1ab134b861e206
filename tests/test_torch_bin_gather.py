"""Parity of the port's power distributor (``nifty_tpu_torch.ops.bin_gather``)
with ``nifty_tpu.ops.pallas_gather``.

The JAX side runs the Pallas kernel bodies in interpret mode, as
``tests/test_pallas_gather.py`` does; the port runs its plain PyTorch
versions, which is what its wrappers do for CPU tensors.  Tolerances: the
gather is a copy (exact); the segment sum adds in another order, so it is
held to 1e-12 of the per-bin sum of |cot| (float64).  The CUDA kernels are
held against the same plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``'s phase 3.
"""

import warnings

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import pallas_gather as pg  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.ops import bin_gather as bg  # noqa: E402

torch.set_num_threads(1)

SEG_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _index_map(nb, n, seed):
    """A sorted-ish map with ragged blocks and every bin occupied."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, nb, size=n))
    idx[::7] = rng.integers(0, nb, size=len(idx[::7]))
    idx[:nb] = rng.permutation(nb)
    return idx


def _assert_segsum_close(got, want, scale):
    got, want, scale = map(np.asarray, (got, want, scale))
    assert np.all(np.abs(got - want) <= SEG_RTOL * np.maximum(scale, 1e-300))


# nb <= 1024: the select-loop kernels (K1/K2); 1024 < nb <= 4096: the MXU
# one-hot kernels (K3/K4).  B = 1 and B = 8 batch rows of one shared map.
REGIMES = [(96, 9000), (1621, 10000)]


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
@pytest.mark.parametrize("nrows", [1, 8])
def test_plain_versions_match_pallas_kernels(monkeypatch, nb, n, nrows):
    rng = np.random.default_rng(nb + nrows)
    idx = _index_map(nb, n, seed=nb)
    table = rng.standard_normal((nrows, nb))
    cot = rng.standard_normal((nrows, n))

    monkeypatch.setattr(pg, "_INTERPRET", True)
    if nb > pg.SMALL_TABLE_MAX_BINS:
        assert pg._use_mxu(nb, n, jnp.float64, False)
    want_g = np.asarray(pg.bin_gather_p.bind(jnp.asarray(table), jnp.asarray(idx)))
    want_s = np.asarray(pg.bin_scatter_p.bind(jnp.asarray(cot), jnp.asarray(idx), nb=nb))
    monkeypatch.setattr(pg, "_INTERPRET", False)

    dist = bg.BinIndex(idx, nb=nb)
    got_g = bg.bin_gather(torch.from_numpy(table), dist).numpy()
    got_s = bg.bin_segment_sum(torch.from_numpy(cot), dist).numpy()
    scale = bg.bin_segment_sum_plain(
        torch.from_numpy(np.abs(cot)), dist.perm, dist.offsets
    ).numpy()
    np.testing.assert_array_equal(got_g, want_g)
    _assert_segsum_close(got_s, want_s, scale)


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
def test_distribute_power_and_transforms_match_jax(monkeypatch, nb, n):
    """Forward, jvp, vjp and linearize of a nonlinear function of the
    distributor, against ``distribute_power`` in interpret mode."""
    rng = np.random.default_rng(5)
    idx = _index_map(nb, n, seed=3).reshape(n // 100, 100)
    w = rng.standard_normal(idx.shape)
    t = rng.standard_normal(nb)
    dt = rng.standard_normal(nb)
    ct = rng.standard_normal(idx.shape)

    def f_jax(x):
        return jnp.sin(pg.distribute_power(x, idx)) * w

    monkeypatch.setattr(pg, "_INTERPRET", True)
    y_j, tan_j = jax.jvp(f_jax, (jnp.asarray(t),), (jnp.asarray(dt),))
    _, vjp_j = jax.vjp(f_jax, jnp.asarray(t))
    (cot_j,) = vjp_j(jnp.asarray(ct))
    monkeypatch.setattr(pg, "_INTERPRET", False)

    dist = bg.BinIndex(idx, nb=nb)
    wt = torch.from_numpy(w)

    def f_torch(x):
        return torch.sin(bg.distribute_power(x, dist)) * wt

    tt, dtt, ctt = map(torch.from_numpy, (t, dt, ct))
    y_t, tan_t = torch.func.jvp(f_torch, (tt,), (dtt,))
    _, vjp_t = torch.func.vjp(f_torch, tt)
    (cot_t,) = vjp_t(ctt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fx const-folding notice
        _, lin = torch.func.linearize(f_torch, tt)
        tan_lin = lin(dtt)
    _, jvp_dbl, vjp_dbl = linearize(f_torch, tt)

    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-13, atol=1e-15)
    for got in (tan_t, tan_lin, jvp_dbl(dtt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(tan_j), rtol=1e-13, atol=1e-13)
    for got in (cot_t, vjp_dbl(ctt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(cot_j), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("nb,n", REGIMES, ids=["select_loop", "mxu"])
def test_adjoint_identity(nb, n):
    """<G x, y> == <x, S y>: the segment sum is the gather's transpose."""
    rng = np.random.default_rng(9)
    dist = bg.BinIndex(_index_map(nb, n, seed=1), nb=nb)
    x = torch.from_numpy(rng.standard_normal((3, nb)))
    y = torch.from_numpy(rng.standard_normal((3, n)))
    lhs = torch.sum(bg.bin_gather(x, dist) * y)
    rhs = torch.sum(x * bg.bin_segment_sum(y, dist))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.sum(x.abs() @ bg.bin_segment_sum(
        y.abs(), dist).T))


def test_vmap_folds_samples_into_rows():
    rng = np.random.default_rng(2)
    nb, n = 50, 700
    dist = bg.BinIndex(_index_map(nb, n, seed=4), nb=nb)
    tables = torch.from_numpy(rng.standard_normal((4, nb)))
    cots = torch.from_numpy(rng.standard_normal((4, n)))
    got_g = torch.func.vmap(lambda t: bg.distribute_power(t, dist))(tables)
    got_s = torch.func.vmap(lambda c: bg.segment_sum(c, dist))(cots)
    want_g = torch.stack([bg.distribute_power(t, dist) for t in tables])
    want_s = torch.stack([bg.segment_sum(c, dist) for c in cots])
    assert torch.equal(got_g, want_g)
    assert torch.equal(got_s, want_s)
    # higher order: the segment sum's derivative is the gather
    y, tan = torch.func.jvp(lambda c: bg.segment_sum(c, dist), (cots[0],), (cots[1],))
    assert torch.equal(tan, bg.segment_sum(cots[1], dist))


def test_sorted_scatter_aux_is_csr_of_stable_sort():
    idx = np.array([[3, 0, 3], [1, 0, 3]])
    aux = bg.sorted_scatter_aux(idx, nb=5)
    np.testing.assert_array_equal(aux["perm"], [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(aux["offsets"], [0, 2, 3, 3, 6, 6])


# The gather kernel reads the map at the narrowest width that holds nb.
NARROW_EDGES = [(1, torch.uint8), (256, torch.uint8), (257, torch.int16),
                (32768, torch.int16), (32769, torch.int32)]


@pytest.mark.parametrize("nb,dtype", NARROW_EDGES, ids=[str(e[0]) for e in NARROW_EDGES])
def test_bin_index_keeps_a_narrow_copy_of_the_map(nb, dtype):
    n = max(nb, 1000)
    idx = _index_map(nb, n, seed=nb)
    idx[-1] = nb - 1  # the largest entry sits at the end
    dist = bg.BinIndex(idx, nb=nb)
    assert bg.narrow_index_dtype(nb) == dtype
    assert dist.idx_narrow.dtype == dtype and dist.idx.dtype == torch.int32
    assert torch.equal(dist.idx_narrow.to(torch.int64), dist.idx.to(torch.int64))
    assert int(dist.idx_narrow.max()) == nb - 1


def test_narrow_map_moves_with_the_module_and_stays_out_of_state_dict():
    def make():
        return bg.BinIndex(_index_map(300, 2000, seed=6), nb=300)

    dist = make()
    assert set(dist.state_dict()) == {"idx", "perm", "offsets"}
    assert "idx_narrow" in dict(dist.named_buffers())
    assert dist.to(torch.float32).idx_narrow.dtype == torch.int16  # integer buffers keep their type
    # the narrow map is built from the map, not loaded
    again = make()
    again.load_state_dict(dist.state_dict())
    assert torch.equal(again.idx_narrow, dist.idx_narrow)
    meta = make().to("meta")
    assert meta.idx_narrow.device.type == "meta" and meta.idx_narrow.dtype == torch.int16


@pytest.mark.parametrize("nb,dtype", NARROW_EDGES[1:4], ids=["256", "257", "32768"])
def test_plain_gather_at_the_index_width_edges(nb, dtype):
    """The CPU path keeps reading the int32 map; results are exact copies."""
    rng = np.random.default_rng(nb)
    n = 2 * nb + 3
    idx = _index_map(nb, n, seed=nb + 1)
    dist = bg.BinIndex(idx, nb=nb)
    table = torch.from_numpy(rng.standard_normal((3, nb)))
    got = bg.bin_gather(table, dist)
    assert torch.equal(got, table[:, torch.from_numpy(idx)])
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx_narrow.long()))


def test_wrappers_validate_and_count_only_kernel_launches():
    dist = bg.BinIndex(np.array([0, 2, 1, 2]), nb=3)
    bg.reset_launch_counts()
    bg.bin_gather(torch.ones((1, 3)), dist)
    bg.bin_segment_sum(torch.ones((1, 4)), dist)
    assert bg.bin_gather.launches == 0 and bg.bin_segment_sum.launches == 0
    assert bg.bin_segment_sum.kernel_launches == 0
    assert not bg.bin_gather.launches_by_rows and not bg.bin_segment_sum.launches_by_rows
    assert not bg.bin_gather.kernel_launches_by_rows
    assert not bg.bin_segment_sum.kernel_launches_by_rows
    with pytest.raises(ValueError):
        bg.bin_gather(torch.ones((1, 4)), dist)  # wrong table width
    with pytest.raises(TypeError):
        bg.bin_gather(torch.ones((1, 3), dtype=torch.int64), dist)
    with pytest.raises(ValueError):
        bg.bin_segment_sum(torch.ones((1, 8))[:, ::2], dist)  # non-contiguous
    with pytest.raises(ValueError):
        bg.BinIndex(np.array([0, 3]), nb=3)
    meta = bg.BinIndex(np.array([0, 2, 1, 2]), nb=3).to("meta")
    with pytest.raises(RuntimeError, match="no bin_gather kernel"):
        bg.bin_gather(torch.ones((1, 3), device="meta"), meta)
    with pytest.raises(RuntimeError, match="no bin_segment_sum kernel"):
        bg.bin_segment_sum(torch.ones((1, 4), device="meta"), meta)


# Segment lengths for the segment-sum kernel's work (chunk C, short classes
# of SHORT_WIDTHS lanes): log-binned lengths like the 4096^2 quarter map's
# (113 bins, the largest 366,891 entries); empty bins between occupied ones;
# one bin; each edge of a chunk, of a warp's 32 entries and of every short
# class; the 1024^2 unbinned quarter map's lengths (82,799 bins of mean 3.18
# and at most 24 entries, 98.9 % of them 8 or less: the multiplicities of
# kx^2 + ky^2 on the 513^2 quarter grid) cut to a 65^2 quarter grid.
C = bg.SEGMENT_CHUNK
WIDTHS = bg.SHORT_WIDTHS


def _quarter_grid_lengths(m):
    k = np.arange(m)
    return np.unique((k[:, None] ** 2 + k[None, :] ** 2).ravel(), return_counts=True)[1]


SEGMENT_LENGTHS = {
    "skewed_4096sq": np.round(np.geomspace(1, 366891, 113)).astype(int),
    "empty_bins": [5, 0, 0, 40, 0, 3 * C + 7, 0, 1],
    "nb1": [10000],
    "one_chunk": [C],
    "chunk_edges": [C - 1, C, C + 1, 2 * C, 2 * C + 1, 32, 33, 31],
    "width_edges": [w + d for w in WIDTHS for d in (-1, 0, 1)] + [0, 1, 0],
    "unbinned_quarter_65sq": _quarter_grid_lengths(65),
}


def _offsets(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def _classes(w):
    """The short bins' lists, one per class."""
    ends = np.cumsum(w["short_counts"])
    return [w["short_bins"][e - c:e] for e, c in zip(ends, w["short_counts"])]


@pytest.mark.parametrize("case", SEGMENT_LENGTHS)
def test_work_items_cover_each_segment_once_in_order(case):
    offsets = _offsets(SEGMENT_LENGTHS[case])
    lens = np.diff(offsets)
    w = bg.segment_work_items(offsets)
    items, split, n_short = w["items"], w["split"], w["n_short"]
    assert items.dtype == split.dtype == w["short_bins"].dtype == np.int32
    assert w["short_los"].dtype == np.int32 and w["short_lens"].dtype == np.uint8
    np.testing.assert_array_equal(w["short_los"], offsets[:-1][w["short_bins"]])
    np.testing.assert_array_equal(w["short_lens"], lens[w["short_bins"]])
    # every bin of at most 32 entries, empty ones too, exactly once, in the
    # class that its length alone names, each class in bin order
    assert len(w["short_counts"]) == len(WIDTHS) and sum(w["short_counts"]) == n_short
    lower = (-1,) + WIDTHS[:-1]
    for bins, lo_w, hi_w in zip(_classes(w), lower, WIDTHS):
        np.testing.assert_array_equal(bins, np.flatnonzero((lens > lo_w) & (lens <= hi_w)))
    np.testing.assert_array_equal(np.sort(w["short_bins"]),
                                  np.flatnonzero(lens <= bg.SHORT_SEGMENT))
    assert WIDTHS[-1] == bg.SHORT_SEGMENT
    # the classes' lists cut into pieces of SHORT_VALUES * 256 / w bins, each
    # within one class, together every short bin once, in the order of their
    # first bins
    pieces = w["pieces"]
    assert pieces.dtype == np.int32
    ends = np.cumsum(w["short_counts"])
    covered = []
    for start in pieces:
        c = int(np.searchsorted(ends, start, side="right"))
        size = bg.SHORT_VALUES * 256 // WIDTHS[c]
        assert (start - (ends[c] - w["short_counts"][c])) % size == 0
        covered.append(np.arange(start, min(start + size, ends[c])))
    np.testing.assert_array_equal(np.sort(np.concatenate(covered)) if covered else [],
                                  np.arange(n_short))
    assert np.all(np.diff(w["short_bins"][pieces]) > 0)
    # block items of 1..C entries for the longer bins, in bin and chunk order
    size = items[:, 2] - items[:, 1]
    assert np.all(size > 0) and np.all(size <= C)
    assert np.all(np.diff(items[:, 1]) > 0) and np.all(np.diff(items[:, 0]) >= 0)
    np.testing.assert_array_equal(np.unique(items[:, 0]),
                                  np.flatnonzero(lens > bg.SHORT_SEGMENT))
    split_bins = []
    for k in np.flatnonzero(lens > bg.SHORT_SEGMENT):
        mine = items[items[:, 0] == k]
        # the bin's items tile [lo, hi) exactly once, in order
        assert mine[0, 1] == offsets[k] and mine[-1, 2] == offsets[k + 1]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert len(mine) == -(-lens[k] // C)
        if len(mine) > 1:
            split_bins.append(k)
            np.testing.assert_array_equal(mine[:, 3], mine[0, 3] + np.arange(len(mine)))
        else:
            assert mine[0, 3] == -1
    # the second pass: each split bin's slots, numbered in order
    np.testing.assert_array_equal(split[:, 0], split_bins)
    chunks = split[:, 2]
    np.testing.assert_array_equal(split[:, 1], np.cumsum(chunks) - chunks)
    assert w["n_slots"] == chunks.sum()
    np.testing.assert_array_equal(np.sort(items[items[:, 3] >= 0, 3]), np.arange(w["n_slots"]))


def _butterfly(v, width):
    """Numpy emulation of the kernel's ``lanes_sum``: (..., 32) lanes, a
    butterfly over groups of ``width`` adjacent lanes (steps width/2 ... 1,
    lane l adding lane l ^ step's value)."""
    lanes = np.arange(32)
    s = width // 2
    while s:
        v = v + v[..., lanes ^ s]
        s //= 2
    return v


def _emulated_short_sums(vals, offsets, w):
    """Each short bin's sum as its class's lanes compute it: one lane per
    entry, zeros beyond the bin's length, a butterfly over the class width."""
    out = {}
    for bins, width in zip(_classes(w), WIDTHS):
        for k in bins:
            lanes = np.zeros((vals.shape[0], 32), dtype=vals.dtype)
            seg = vals[:, offsets[k]:offsets[k + 1]]
            lanes[:, :seg.shape[1]] = seg
            out[int(k)] = _butterfly(lanes, width)[:, 0]
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("width", sorted(set(WIDTHS) | {2, 4, 8, 16}))
def test_narrow_butterfly_gives_the_whole_warps_bits(width, dtype):
    """A bin of at most ``width`` entries: the butterfly over ``width``
    lanes equals the one over all 32 bit for bit (its steps 16 ... width add
    exact zeros), whichever group of the warp the bin sits in."""
    rng = np.random.default_rng(width)
    for _ in range(200):
        length = int(rng.integers(0, width + 1))
        group = int(rng.integers(0, 32 // width))
        seg = (rng.standard_normal(length) * 10.0 ** rng.integers(-6, 7, length)).astype(dtype)
        alone = np.zeros(32, dtype=dtype)
        alone[:length] = seg
        # the group among other bins' entries in the same warp
        packed = rng.standard_normal(32).astype(dtype)
        packed[group * width:(group + 1) * width] = alone[:width]
        narrow = _butterfly(packed, width)[group * width]
        whole = _butterfly(alone, 32)[0]
        assert narrow.dtype == whole.dtype == dtype
        # equal as numbers: only the sign of a zero sum may differ
        np.testing.assert_array_equal(narrow, whole)


@pytest.mark.parametrize("case", ["skewed_4096sq", "empty_bins", "chunk_edges", "width_edges",
                                  "unbinned_quarter_65sq"])
def test_work_items_compose_the_segment_sum(case):
    """Summing each short bin as its class's lanes do and each block item's
    entries, then the split bins' partials by slot, gives the per-bin sums
    (what the kernel computes, in numpy): equal to ``bin_segment_sum_plain``
    to rounding."""
    offsets = _offsets(SEGMENT_LENGTHS[case])
    rng = np.random.default_rng(3)
    n, nb = int(offsets[-1]), offsets.size - 1
    perm = rng.permutation(n)  # any bijection: position in the sort -> entry
    cot = rng.standard_normal((3, n))
    vals = cot[:, perm]
    w = bg.segment_work_items(offsets)
    out = np.full((3, nb), np.nan)
    for k, total in _emulated_short_sums(vals, offsets, w).items():
        out[:, k] = total
    part = np.stack([vals[:, lo:hi].sum(axis=1) for _, lo, hi, _ in w["items"]], axis=1) \
        if len(w["items"]) else np.zeros((3, 0))
    partials = np.zeros((3, w["n_slots"]))
    for i, (k, _, _, slot) in enumerate(w["items"]):
        if slot < 0:
            out[:, k] = part[:, i]
        else:
            partials[:, slot] = part[:, i]
    for k, first, chunks, _ in w["split"]:
        out[:, k] = partials[:, first:first + chunks].sum(axis=1)
    want = bg.bin_segment_sum_plain(torch.from_numpy(cot), torch.from_numpy(perm),
                                    torch.from_numpy(offsets)).numpy()
    scale = bg.bin_segment_sum_plain(torch.from_numpy(np.abs(cot)), torch.from_numpy(perm),
                                     torch.from_numpy(offsets)).numpy()
    assert not np.isnan(out).any()
    _assert_segsum_close(out, want, scale)


def test_unbinned_quarter_map_lengths_are_short():
    """The length distribution the short classes were chosen for: on a
    quarter grid nearly every mode has a handful of entries."""
    lens = _quarter_grid_lengths(65)
    w = bg.segment_work_items(_offsets(lens))
    assert w["n_short"] == lens.size and len(w["items"]) == 0
    assert (lens <= 8).mean() > 0.95 and 2.5 < lens.mean() < 3.5
    assert sum(w["short_counts"][:2]) == (lens <= 8).sum()


def test_work_items_depend_on_the_map_alone():
    rng = np.random.default_rng(8)
    idx = np.concatenate([np.zeros(3 * C + 5, int), rng.integers(0, 40, size=2000)])
    dist = bg.BinIndex(idx, nb=45)
    want = bg.segment_work_items(dist.offsets.numpy())
    assert dist.n_split == 1 and dist.n_items == len(want["items"]) + want["n_short"]
    assert dist.short_counts == want["short_counts"] and dist.n_short == want["n_short"]
    names = {"seg_bins": "short_bins", "seg_los": "short_los", "seg_lens": "short_lens",
             "seg_pieces": "pieces", "seg_items": "items", "seg_split": "split"}
    for nrows in (1, 5):
        cot = torch.from_numpy(rng.standard_normal((nrows, dist.n)))
        bg.segment_sum(cot, dist)
        for name, key in names.items():
            np.testing.assert_array_equal(getattr(dist, name).numpy(), want[key])
    again = bg.BinIndex(idx, nb=45)
    for name in names:
        assert torch.equal(getattr(again, name), getattr(dist, name))
    # the same segment lengths under another arrangement of the entries
    shuffled = bg.BinIndex(rng.permutation(idx), nb=45)
    for name in names:
        assert torch.equal(getattr(shuffled, name), getattr(dist, name))


def test_work_items_move_with_the_module_and_stay_out_of_state_dict():
    idx = np.concatenate([np.zeros(C + 1, int), np.arange(300)])
    dist = bg.BinIndex(idx, nb=300)
    names = ("seg_bins", "seg_los", "seg_lens", "seg_pieces", "seg_items", "seg_split")
    assert set(dist.state_dict()) == {"idx", "perm", "offsets"}
    assert set(names) <= set(dict(dist.named_buffers()))
    assert dist.to(torch.float64).seg_items.dtype == torch.int32
    meta = bg.BinIndex(idx, nb=300).to("meta")
    for name in names:
        buf = getattr(meta, name)
        assert buf.device.type == "meta" and buf.dtype == getattr(dist, name).dtype
        assert buf.shape == getattr(dist, name).shape
    assert dist.seg_lens.dtype == torch.uint8 and dist.seg_los.dtype == torch.int32
    assert dist.seg_split.shape == (1, 4) and dist.n_slots == 2
    assert dist.seg_bins.shape == dist.seg_los.shape == dist.seg_lens.shape == (299,)
    assert dist.short_counts == (299,) + (0,) * (len(WIDTHS) - 1) and dist.n_block_items == 2
