"""The port's CUDA kernels (the distributor, the refinement step, the
HEALPix longitude stage, the ray integral and the NUFFT window) against
their plain PyTorch versions, on the card.  Every test here needs an
NVIDIA card and skips without one; the file imports no jax, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: the gather is a copy (bitwise equal, at every index width and
row alignment the kernel handles); the segment sum adds in
another order than the plain version, so it is held to 1e-12 (float64) or
1e-5 (float32) of the per-bin sum of |cot|, and two of its runs must be
bitwise equal (it uses no atomics), as must a replay of the call from a
CUDA graph and a call on one of the rows alone.
"""

import hashlib
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.ops import bin_gather as bg  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the distributor kernels have no CPU mode")
    return torch.device("cuda")


def _index_map(nb, n, seed):
    """A random map with every bin occupied (where it has the entries)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nb, size=n)
    idx[:nb] = rng.permutation(nb)[:n]
    return idx


# (bins, entries, rows): the 128^2 unbinned KL stage (table in static
# shared memory); a table above 48 KB in float64 (dynamic shared memory);
# a table above the 227 KB a block can hold in either type (read through
# the read-only cache).
CASES = {"128sq_B8": (1621, 16384, 8), "dynamic_smem": (7000, 50000, 2),
         "ldg": (60000, 200000, 1)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernels_match_plain_versions(cuda, case, dtype):
    nb, n, nrows = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    dist = bg.BinIndex(_index_map(nb, n, seed=nb), nb=nb).to(cuda)
    table = torch.randn((nrows, nb), dtype=dtype, device=cuda, generator=gen)
    cot = torch.randn((nrows, n), dtype=dtype, device=cuda, generator=gen)

    before = (bg.bin_gather.launches, bg.bin_segment_sum.launches,
              bg.bin_gather.launches_by_rows[nrows], bg.bin_segment_sum.launches_by_rows[nrows])
    got = bg.bin_gather(table, dist)
    s1, s2 = bg.bin_segment_sum(cot, dist), bg.bin_segment_sum(cot, dist)
    torch.cuda.synchronize()
    assert (bg.bin_gather.launches, bg.bin_segment_sum.launches,
            bg.bin_gather.launches_by_rows[nrows], bg.bin_segment_sum.launches_by_rows[nrows]
            ) == (before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 2)
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))
    assert torch.equal(s1, s2)
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


# (bins, entries, rows) for the gather alone: each edge of the narrow index
# map's width (uint8 up to 256 bins, int16 up to 32,768); an odd map with
# several rows, so rows start off a 16-byte boundary; maps shorter than one
# 8-element step, and of one entry; the 128^2 stacked KL stage; tables
# above the 227 KB (232,448 bytes: 29,056 float64 or 58,112 float32 bins) a
# block can hold, read from global memory: one and two rows directly, and 3,
# 8, 9 and 17 rows through the rows-innermost copy (a padded row group, one
# full tile, a tile of one row after a full one), with odd maps (rows start
# misaligned, a ragged tail) and even ones, bin counts just above the limit
# of each type, and a copy above half of L2 (read directly again).
GATHER_CASES = {
    "nb256": (256, 4099, 3), "nb257": (257, 4099, 3),
    "nb32768": (32768, 70001, 2), "nb32769": (32769, 70001, 2),
    "odd_rows": (113, 2049 * 65, 3), "short": (4, 5, 3), "one": (1, 1, 1),
    "128sq_B8": (1621, 16384, 8), "ldg": (60000, 200003, 2),
    "global_B1_odd": (60000, 200003, 1), "global_B3_odd": (60000, 200003, 3),
    "global_B8_odd": (60000, 200001, 8), "global_B8": (60000, 200000, 8),
    "global_B9": (60000, 200002, 9), "global_B17_odd": (60000, 100003, 17),
    "above_f64_limit_B1": (29057, 100001, 1), "above_f64_limit_B2": (29057, 100001, 2),
    "above_f64_limit_B8": (29057, 100000, 8), "at_f64_limit_B8": (29056, 100001, 8),
    "above_f32_limit_B3": (58113, 150001, 3), "above_f32_limit_B8": (58113, 150004, 8),
    "short_global_B3": (60000, 3, 3), "copy_above_half_l2_B8": (500000, 100001, 8),
}


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gather_is_bit_exact(cuda, case, dtype):
    nb, n, nrows = GATHER_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(1)
    dist = bg.BinIndex(_index_map(nb, n, seed=nb + n), nb=nb).to(cuda)
    assert dist.idx_narrow.dtype == bg.narrow_index_dtype(nb)
    table = torch.randn((nrows, nb), dtype=dtype, device=cuda, generator=gen)
    before = (bg.bin_gather.launches, bg.bin_gather.kernel_launches,
              bg.bin_gather.kernel_launches_by_rows[nrows])
    got = bg.bin_gather(table, dist)
    torch.cuda.synchronize()
    # one call; two kernels where the table is first copied rows-innermost
    kernels = 2 if bg.rows_innermost_columns(
        nb, nrows, table.element_size(), table.get_device()) else 1
    assert (bg.bin_gather.launches, bg.bin_gather.kernel_launches,
            bg.bin_gather.kernel_launches_by_rows[nrows]) == (
        before[0] + 1, before[1] + kernels, before[2] + kernels)
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))
    assert torch.equal(_graph_replay(lambda: bg.bin_gather(table, dist)), got)


def _graph_replay(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


C = bg.SEGMENT_CHUNK
# (segment lengths, rows) for the segment sum's work items: one bin with
# 90 % of 1.2M entries; lengths at each edge of a chunk; empty bins between
# occupied ones; one bin; one entry (two empty bins); the 128^2 stacked KL
# stage (1621 bins of at most 32 entries: short bins only, one launch); three
# rows of an odd-length skewed map; lengths at each edge of a short class,
# with empty bins, at 1, 3 and 9 rows (a row tile of one after a full one);
# the lengths of an unbinned 129^2 quarter grid (nearly all of 8 or less).
_rng = np.random.default_rng(11)
_k = np.arange(129)
_WIDTH_EDGES = [w + d for w in bg.SHORT_WIDTHS for d in (-1, 0, 1)] * 40 + [0, 1, 0, 2]
SEGSUM_CASES = {
    "one_bin_90pct": (np.bincount(np.where(_rng.random(1_200_000) < 0.9, 57,
                                           _rng.integers(0, 113, 1_200_000)), minlength=113), 1),
    "chunk_edges": ([C - 1, C, C + 1, 2 * C, 5, 0, 33, 32], 2),
    "empty_bins": ([0, 7, 0, 0, 5000, 0, 31, 0, 3 * C + 1, 0], 2),
    "nb1": ([3 * C + 17], 2),
    "n1": ([1, 0, 0], 1),
    "128sq_B8": (np.bincount(_index_map(1621, 16384, seed=1621), minlength=1621), 8),
    "B3_odd": (np.round(np.geomspace(1, 60000, 41)).astype(int) | 1, 3),
    "width_edges_B1": (_WIDTH_EDGES, 1), "width_edges_B3": (_WIDTH_EDGES, 3),
    "width_edges_B9": (_WIDTH_EDGES, 9),
    "unbinned_quarter_129sq_B2": (np.unique((_k[:, None] ** 2 + _k[None, :] ** 2).ravel(),
                                            return_counts=True)[1], 2),
}


@pytest.mark.parametrize("case", SEGSUM_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_segment_sum_work_items(cuda, case, dtype):
    lengths, nrows = SEGSUM_CASES[case]
    nb = len(lengths)
    rng = np.random.default_rng(nb)
    idx = rng.permutation(np.repeat(np.arange(nb), lengths))
    dist = bg.BinIndex(idx, nb=nb).to(cuda)
    if case == "128sq_B8":
        assert dist.n_split == 0 and dist.n_short == nb
    if case in ("one_bin_90pct", "nb1", "chunk_edges", "B3_odd"):
        assert dist.n_split > 0
    if case.startswith("width_edges"):
        assert min(dist.short_counts) > 0 and dist.n_block_items > 0
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = torch.randn((nrows, dist.n), dtype=dtype, device=cuda, generator=gen)

    before = bg.bin_segment_sum.launches, bg.bin_segment_sum.kernel_launches
    s1, s2 = bg.bin_segment_sum(cot, dist), bg.bin_segment_sum(cot, dist)
    last_row = bg.bin_segment_sum(cot[-1:].contiguous(), dist)
    torch.cuda.synchronize()
    # three calls, each one launch, or two where a bin is split
    per_call = 2 if dist.n_split else 1
    assert (bg.bin_segment_sum.launches, bg.bin_segment_sum.kernel_launches) == (
        before[0] + 3, before[1] + 3 * per_call)
    assert torch.equal(s1, s2)
    # the order of the sums depends on the map alone, not on the rows
    assert torch.equal(last_row, s1[-1:])
    assert torch.equal(_graph_replay(lambda: bg.bin_segment_sum(cot, dist)), s1)
    # the short classes' narrow butterflies give a whole warp's bits
    assert torch.equal(bg.bin_segment_sum_whole_warps(cot, dist), s1)
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


# grid size -> the quarter map's shape, its modes, the bins above 32 entries
# (block items) and the longest bin
UNBINNED_GRIDS = {1024: ((513, 513), 82799, 0, 24), 4096: ((2049, 2049), 1197363, 9, 40)}


@pytest.mark.parametrize("size,nrows", [(1024, 1), (1024, 8), (4096, 1)],
                         ids=["1024sq_B1", "1024sq_B8", "4096sq_B1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_unbinned_1024sq_distributor_shape(cuda, dtype, size, nrows):
    """The unbinned fields' own maps.  1024^2: 82,799 modes on the 513^2
    quarter grid, so the gather reads an int32 index and a table above the
    227 KB a block can hold (through the rows-innermost copy at 8 rows), and
    the segment sum is 82,799 short bins in one launch.  4096^2: 1,197,363
    modes on the 2049^2 quarter grid, every short class and 9 block items."""
    from nifty_tpu_torch.models.correlated_field import make_grid

    shape, nb, n_long, longest = UNBINNED_GRIDS[size]
    hg = make_grid((size, size), 1.0 / size).harmonic_grid
    dist = bg.BinIndex(hg.power_distributor_quarter, nb=hg.mode_lengths.size).to(cuda)
    assert dist.shape == shape and dist.nb == nb
    assert dist.idx_narrow.dtype == torch.int32
    assert dist.nb * torch.finfo(dtype).bits // 8 > 227 * 1024
    assert (dist.n_items, dist.n_short, dist.n_split) == (nb, nb - n_long, 0)
    assert dist.n_block_items == n_long and min(dist.short_counts) > 0
    assert int((dist.offsets[1:] - dist.offsets[:-1]).max()) == longest
    gen = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn((nrows, dist.nb), dtype=dtype, device=cuda, generator=gen)
    cot = torch.randn((nrows, dist.n), dtype=dtype, device=cuda, generator=gen)
    before = (bg.bin_segment_sum.launches, bg.bin_segment_sum.kernel_launches,
              bg.bin_gather.launches, bg.bin_gather.kernel_launches)
    got = bg.bin_gather(table, dist)
    s1, s2 = bg.bin_segment_sum(cot, dist), bg.bin_segment_sum(cot, dist)
    last_row = bg.bin_segment_sum(cot[-1:].contiguous(), dist)
    torch.cuda.synchronize()
    assert (bg.bin_segment_sum.launches, bg.bin_segment_sum.kernel_launches,
            bg.bin_gather.launches, bg.bin_gather.kernel_launches) == (
        before[0] + 3, before[1] + 3, before[2] + 1, before[3] + (2 if nrows == 8 else 1))
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))
    assert torch.equal(s1, s2) and torch.equal(last_row, s1[-1:])
    assert torch.equal(_graph_replay(lambda: bg.bin_segment_sum(cot, dist)), s1)
    assert torch.equal(_graph_replay(lambda: bg.bin_gather(table, dist)), got)
    assert torch.equal(bg.bin_segment_sum_whole_warps(cot, dist), s1)
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


def test_long_spectrum_scan_repeats_its_bits(cuda):
    """The integrated Wiener process over the 82,798 log-k steps of the
    1024^2 unbinned grid: ``torch.cumsum`` of one long row is a multi-block
    scan whose bits vary from run to run on the card; the chunked scan the
    model uses gives the same bits every time, forward and backward."""
    from nifty_tpu_torch.models.gauss_markov import _cumsum, integrated_wiener_process

    gen = torch.Generator(device=cuda).manual_seed(4)
    n = 82798
    xi = torch.randn((n, 2), dtype=torch.float64, device=cuda, generator=gen,
                     ).requires_grad_(True)
    dt = torch.rand(n, dtype=torch.float64, device=cuda, generator=gen) * 1e-3
    x0 = torch.zeros(2, dtype=torch.float64, device=cuda)
    sigma = torch.tensor(1.3, dtype=torch.float64, device=cuda)

    def run():
        out = integrated_wiener_process(xi, x0, sigma, dt, asperity=sigma / 2)
        grad, = torch.autograd.grad(out.square().sum(), xi)
        return out.detach(), grad

    first = run()
    for _ in range(10):
        again = run()
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    x = xi.detach()[:, 0].contiguous()
    want = torch.cumsum(x.cpu(), 0)
    torch.testing.assert_close(_cumsum(x).cpu(), want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_derivatives_on_the_card_match_the_cpu(cuda):
    """jvp, vjp and the recorded linearization run the kernels on the card
    and agree with the plain versions on the CPU."""
    rng = np.random.default_rng(1)
    nb, shape = 1621, (128, 128)
    idx = _index_map(nb, shape[0] * shape[1], seed=2).reshape(shape)
    t, dt = rng.standard_normal(nb), rng.standard_normal(nb)
    w, ct = rng.standard_normal(shape), rng.standard_normal(shape)

    def run(device):
        dist = bg.BinIndex(idx, nb=nb).to(device)
        wd = torch.from_numpy(w).to(device)

        def f(x):
            return torch.sin(bg.distribute_power(x, dist)) * wd

        x, dx, c = (torch.from_numpy(a).to(device) for a in (t, dt, ct))
        _, tan = torch.func.jvp(f, (x,), (dx,))
        _, vjp_fn = torch.func.vjp(f, x)
        _, jvp_lin, vjp_lin = linearize(f, x)
        return [r.cpu() for r in (tan, vjp_fn(c)[0], jvp_lin(dx), vjp_lin(c))]

    launches = bg.bin_gather.launches
    on_card, on_cpu = run(cuda), run(torch.device("cpu"))
    assert bg.bin_gather.launches > launches
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_wrappers_reject_a_map_on_another_device(cuda):
    dist = bg.BinIndex(np.array([0, 2, 1, 2]), nb=3)  # stays on the CPU
    with pytest.raises(ValueError, match="index map"):
        bg.bin_gather(torch.ones((1, 3), device=cuda), dist)
    with pytest.raises(ValueError, match="index map"):
        bg.bin_segment_sum(torch.ones((1, 4), device=cuda), dist)


@pytest.mark.parametrize("n", [16, 64], ids=["16", "64"])
@pytest.mark.parametrize("nrows", [1, 3, 8, 12, 24])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_small_1d_maps(cuda, dtype, nrows, n):
    """The 1-D subgrid maps of 16 and 64 entries (9 and 33 bins, uint8
    index, rows of 128 and 512 bytes in float64): every bin is short (one
    or two entries), a piece holds fewer bins than a warp has lanes, and
    the rows are those of the lockstep stages and of ``total_N`` fields."""
    _check_1d_map(cuda, dtype, nrows, n)


@pytest.mark.parametrize("nrows", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_density_estimator_1d_map(cuda, dtype, nrows):
    """The 256-entry 1-D map of ``density_estimator(128, 1/128)`` (the
    Matern field's padded grid: 129 bins, uint8 index, 2 KB a float64 row)
    at the rows an update of 2 pairs gives it: 1 for a model call, 2 for
    the lockstep draw, 4 for the curve and the stacked KL stage."""
    _check_1d_map(cuda, dtype, nrows, 256)


def _check_1d_map(cuda, dtype, nrows, n):
    from nifty_tpu_torch.models.correlated_field import make_grid

    hg = make_grid((n,), 1.0 / n).harmonic_grid
    dist = bg.BinIndex(hg.power_distributor, nb=hg.mode_lengths.size).to(cuda)
    assert (dist.nb, dist.n_short, dist.n_split) == (n // 2 + 1, n // 2 + 1, 0)
    assert dist.idx_narrow.dtype == torch.uint8
    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn((nrows, dist.nb), dtype=dtype, device=cuda, generator=gen)
    cot = torch.randn((nrows, dist.n), dtype=dtype, device=cuda, generator=gen)
    got = bg.bin_gather(table, dist)
    s1, s2 = bg.bin_segment_sum(cot, dist), bg.bin_segment_sum(cot, dist)
    last_row = bg.bin_segment_sum(cot[-1:].contiguous(), dist)
    torch.cuda.synchronize()
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))
    assert torch.equal(_graph_replay(lambda: bg.bin_gather(table, dist)), got)
    assert torch.equal(s1, s2) and torch.equal(last_row, s1[-1:])
    assert torch.equal(bg.bin_segment_sum_whole_warps(cot, dist), s1)
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


# -- the refinement step (K9) ----------------------------------------------


def _icr_fields():
    """name -> (dtype, device -> field): every window route a level can
    take (uniform, periodic, the 5 x 4 jump stencil, a deformed chart, three
    axes), the HEALPix sphere (windows that repeat their centre) and sphere
    x radius (27-point windows, 8 children)."""
    from nifty_tpu_torch.refine import (
        CoordinateChart,
        HEALPixChart,
        RefinementField,
        RefinementHPField,
    )

    def matern(r):
        return (1.0 + r) * torch.exp(-r)

    def warp(reg):
        return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)

    def charted(*args, **kw):
        return lambda dtype, dev: RefinementField(CoordinateChart(*args, **kw), matern,
                                                  dtype=dtype, device=dev)

    def sphere(*args, **kw):
        return lambda dtype, dev: RefinementHPField(HEALPixChart(*args, **kw), matern,
                                                    dtype=dtype, device=dev)

    return {
        "periodic": charted((8, 8), depth=2, distances0=0.5, periodic=(True, False)),
        "jump_5_4": charted((8, 7), depth=1, distances0=0.4, coarse_size=5, fine_size=4,
                            fine_strategy="jump"),
        "deformed": charted((8, 7), depth=2, distances0=0.4, nonlinear_map=warp),
        "three_axes": charted((6, 5, 5), depth=1, distances0=0.4, coarse_size=5,
                              periodic=(False, True, False)),
        "sphere": sphere(2, depth=3),
        "sphere_radius": sphere(1, depth=2, radial_chart=CoordinateChart(
            5, depth=2, distances0=0.2, nonlinear_map=lambda x: 1.0 + x)),
    }


@pytest.mark.parametrize("case", ["periodic", "jump_5_4", "deformed", "three_axes", "sphere",
                                  "sphere_radius"])
@pytest.mark.parametrize("nrows", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_icr_kernels_match_plain_versions(cuda, case, nrows, dtype):
    """Each level's step and transpose against the plain versions, within
    1e-12 (float64) or 1e-5 (float32) of the plain output's largest entry
    (the same products summed in another order), bitwise equal when run
    twice (no atomics) and when replayed from a CUDA graph."""
    from nifty_tpu_torch.ops import icr_refine as ir

    field = _icr_fields()[case](dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(nrows)
    for level in field.levels:
        coarse = torch.randn((nrows, level.n_coarse), dtype=dtype, device=cuda, generator=gen)
        xi = torch.randn((nrows, level.S * level.F), dtype=dtype, device=cuda, generator=gen)
        cot = torch.randn((nrows, level.n_fine), dtype=dtype, device=cuda, generator=gen)
        before = (ir.icr_refine.launches, ir.icr_refine_transpose.launches,
                  ir.icr_refine.launches_by_level[level.key, nrows])
        y1, y2 = ir.icr_refine(coarse, xi, level), ir.icr_refine(coarse, xi, level)
        t1, t2 = ir.icr_refine_transpose(cot, level), ir.icr_refine_transpose(cot, level)
        torch.cuda.synchronize()
        assert (ir.icr_refine.launches, ir.icr_refine_transpose.launches,
                ir.icr_refine.launches_by_level[level.key, nrows]) == (
            before[0] + 2, before[1] + 2, before[2] + 2)
        assert torch.equal(y1, y2) and all(map(torch.equal, t1, t2))
        assert torch.equal(_graph_replay(lambda: ir.icr_refine(coarse, xi, level)), y1)
        want = ir.icr_refine_plain(coarse, xi, level)
        torch.testing.assert_close(y1, want, rtol=0, atol=RTOL[dtype] * float(want.abs().max()))
        for got, want in zip(t1, ir.icr_refine_transpose_plain(cot, level)):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=RTOL[dtype] * float(want.abs().max()))


@pytest.mark.parametrize("case", ["deformed", "sphere_radius"])
def test_icr_field_derivatives_on_the_card_match_the_cpu(cuda, case):
    """Forward, jvp, vjp and the recorded linearization of an ICR field with
    a leading batch axis of 2 run the kernels on the card and agree with
    the plain versions on the CPU (1e-12)."""
    from nifty_tpu_torch.ops import icr_refine as ir

    build = _icr_fields()[case]
    rng = np.random.default_rng(2)
    cpu = build(torch.float64, torch.device("cpu"))
    lat = {k: rng.standard_normal((2,) + v.shape) for k, v in cpu.domain.items()}
    tan = {k: rng.standard_normal((2,) + v.shape) for k, v in cpu.domain.items()}
    cot = rng.standard_normal((2,) + tuple(cpu(
        {k: torch.from_numpy(v) for k, v in lat.items()}).shape[1:]))

    def run(field, device):
        x, t = ({k: torch.from_numpy(v).to(device) for k, v in d.items()} for d in (lat, tan))
        c = torch.from_numpy(cot).to(device)
        y, jt_ = torch.func.jvp(field, (x,), (t,))
        _, vjp_fn = torch.func.vjp(field, x)
        _, jvp_lin, vjp_lin = linearize(field, x)
        out = [y, jt_, jvp_lin(t)] + [v for g in (vjp_fn(c)[0], vjp_lin(c)) for v in g.values()]
        return [r.cpu() for r in out]

    launches = ir.icr_refine.launches
    on_card, on_cpu = run(build(torch.float64, cuda), cuda), run(cpu, torch.device("cpu"))
    assert ir.icr_refine.launches > launches
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def _runs(n, k=3):
    return np.arange(n)[:, None] + np.arange(k)[None, :]


def _hp_windows(nside0, level):
    from nifty_tpu_torch.refine import HEALPixChart

    return HEALPixChart(nside0, depth=level + 1).neighbor_windows(level)


# name -> (coarse shape, window tables, children, matrix grid, routes): every
# route, with boxes and tiles ragged at the grid's edges
ICR_LEVELS = {
    "thread_box": ((260, 300), lambda: [_runs(258), _runs(298)], (2, 2), (258, 1),
                   ("thread", "box")),
    "thread_group": ((37, 101), lambda: [_runs(35), _runs(99)], (2, 2), (35, 1),
                     ("thread", "group")),
    "group_2d": ((37, 101), lambda: [_runs(35), _runs(99)], (2, 2), (35, 99),
                 ("group", "group")),
    "line_box": ((300001,), lambda: [_runs(299999)], (2,), (1,), ("group", "box")),
    "line_one_box": ((101,), lambda: [_runs(99)], (2,), (99,), ("group", "box")),
    "healpix_box": ((48,), lambda: [_hp_windows(2, 0)], (4,), (48,), ("group", "box")),
    "healpix_group": ((3072,), lambda: [_hp_windows(4, 2)], (4,), (3072,), ("group", "group")),
    "shell": ((768, 12), lambda: [_hp_windows(2, 2), _runs(10)], (4, 2), (768, 10),
              ("group", "group")),
    "five_axes": ((5, 4, 4, 3, 4), lambda: [_runs(3), _runs(2), _runs(2), _runs(1), _runs(2)],
                  (2, 1, 2, 1, 2), (3, 1, 2, 1, 1), ("entry", "entry")),
}


@pytest.mark.parametrize("case", list(ICR_LEVELS))
@pytest.mark.parametrize("nrows", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_icr_routes_match_plain_versions(cuda, case, nrows, dtype):
    """Each route on levels whose boxes and tiles are ragged, HEALPix windows
    that name their centre twice and a five-axis level: the step and the
    transpose within 1e-12 (float64) or 1e-5 (float32) of the plain
    versions' largest entry, bitwise equal when run twice, replayed from a
    CUDA graph, and given inputs one value off the vectors' alignment."""
    from nifty_tpu_torch.ops import icr_refine as ir

    coarse_shape, windows, children, grid, routes = ICR_LEVELS[case]
    windows = windows()
    if case.startswith("healpix"):
        assert any(len(set(row)) < len(row) for row in windows[0])
    gen = torch.Generator().manual_seed(nrows)
    F, W = int(np.prod(children)), int(np.prod([w.shape[1] for w in windows]))
    M = int(np.prod(grid))
    level = ir.RefineLevel(coarse_shape, windows, children,
                           torch.randn((M, F, W), generator=gen, dtype=dtype),
                           torch.randn((M, F, F), generator=gen, dtype=dtype), grid).to(cuda)
    assert level.routes == routes
    coarse, xi, cot = (torch.randn((nrows, n), generator=gen, dtype=dtype).to(cuda)
                       for n in (level.n_coarse, level.S * level.F, level.n_fine))
    y1, y2 = ir.icr_refine(coarse, xi, level), ir.icr_refine(coarse, xi, level)
    t1, t2 = ir.icr_refine_transpose(cot, level), ir.icr_refine_transpose(cot, level)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and all(map(torch.equal, t1, t2))
    assert torch.equal(_graph_replay(lambda: ir.icr_refine(coarse, xi, level)), y1)
    off = torch.empty(xi.numel() + 1, dtype=dtype, device=cuda)[1:].view_as(xi).copy_(xi)
    off_t = torch.empty(cot.numel() + 1, dtype=dtype, device=cuda)[1:].view_as(cot).copy_(cot)
    assert torch.equal(ir.icr_refine(coarse, off, level), y1)
    assert all(map(torch.equal, ir.icr_refine_transpose(off_t, level), t1))
    want = ir.icr_refine_plain(coarse, xi, level)
    torch.testing.assert_close(y1, want, rtol=0, atol=RTOL[dtype] * float(want.abs().max()))
    for got, want in zip(t1, ir.icr_refine_transpose_plain(cot, level)):
        torch.testing.assert_close(got, want, rtol=0, atol=RTOL[dtype] * float(want.abs().max()))
    for kind in (False, True):
        for k in ir.describe_kernels(level, kind):
            assert k["threads"] == ir.THREADS and k["blocks"] > 0


def test_icr_wrappers_raise_on_bad_tables_and_inputs(cuda):
    from nifty_tpu_torch.ops import icr_refine as ir

    olf, ker = torch.ones((2, 1, 3), dtype=torch.float64), torch.ones((2, 1, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="lie in"):  # a window entry off the coarse grid
        ir.RefineLevel((3,), [np.array([[0, 1, 3], [1, 2, 2]])], (1,), olf, ker, (2,))
    with pytest.raises(ValueError, match="neither 1 nor the sites"):
        ir.RefineLevel((3,), [np.array([[0, 1, 2], [1, 2, 2]])], (1,), olf, ker, (3,))
    level = ir.RefineLevel((3,), [np.array([[0, 0, 1], [1, 2, 2]])], (1,), olf, ker, (2,))
    coarse, xi = torch.ones((1, 3), device=cuda, dtype=torch.float64), torch.ones(
        (1, 2), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="on cpu"):  # the level stays on the CPU
        ir.icr_refine(coarse, xi, level)
    level = level.to(cuda)
    with pytest.raises(TypeError, match="matrices"):
        ir.icr_refine(coarse.float(), xi.float(), level)
    with pytest.raises(ValueError, match="shape"):
        ir.icr_refine_transpose(torch.ones((1, 3), device=cuda, dtype=torch.float64), level)
    # repeated window entries add up on the card too
    cot_c, cot_x = ir.icr_refine_transpose(torch.ones((1, 2), device=cuda, dtype=torch.float64),
                                           level)
    assert cot_c.tolist() == [[2.0, 2.0, 2.0]] and cot_x.tolist() == [[1.0, 1.0]]


@pytest.mark.parametrize("rng", ["normal", "rademacher"])
def test_host_key_draws_the_same_for_the_card(cuda, rng):
    """A HostKey draws on the host and copies: the card gets the CPU's
    numbers, with the default draw and with an `rng`."""
    from nifty_tpu_torch import tree as tt

    shape = {"a": tt.ShapeWithDtype((300,), torch.float64),
             "z": tt.ShapeWithDtype((7, 5), torch.complex128)}
    fn = getattr(tt, rng)
    on_cpu = tt.random_like(tt.HostKey(5), shape, fn, device="cpu")
    on_card = tt.random_like(tt.HostKey(5), shape, fn, device=cuda)
    for k in shape:
        assert on_card[k].device.type == "cuda" and torch.equal(on_card[k].cpu(), on_cpu[k])


# -- the HEALPix longitude stage (K10) ------------------------------------------


def _synthetic_rings(lengths):
    """Evenly spaced rings of the given lengths at made-up colatitudes."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    theta = np.repeat(np.linspace(0.5, 2.5, len(lengths)), lengths)
    phi = np.concatenate([0.1 * (i + 1) + 2 * np.pi * np.arange(n) / n
                          for i, n in enumerate(lengths)])
    return hl.HPRings(theta, phi)


# HEALPix grids (power-of-two rings, and Bluestein's for nside 3 and 6 and
# the polar rings), rings of prime lengths with nm below and above them,
# rings whose transforms need more than 48 KB of shared memory (a Bluestein
# transform of 8192 entries, 128 KB), and rings whose transforms run in the
# workspace (Bluestein's L = 16384 for 4099 and 8188 pixels, as for the
# polar rings of nside 2048; a power of two of 16384)
SYNTHETIC_RINGS = {"primes": (7, 13, 97), "wide": (4093, 2048, 5),
                   "long": (4099, 7, 8188, 16384, 8192)}


@pytest.mark.parametrize("nside,nm", [(4, 7), (8, 16), (16, 40), (32, 100), (3, 10), (6, 30),
                                      ("primes", 5), ("primes", 120), ("wide", 300),
                                      ("long", 300)])
@pytest.mark.parametrize("nrows", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_hp_longitude_kernels_match_plain_versions(cuda, nside, nm, nrows, dtype):
    """K10 and its adjoint against the plain versions within 1e-12 / 1e-5 of
    the per-output sum of |term|; bitwise repeats and CUDA-graph replay; the
    launch counts by rows and shape."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    if nside in SYNTHETIC_RINGS:
        rings, seed = _synthetic_rings(SYNTHETIC_RINGS[nside]).to(cuda), 117
    else:
        rings, seed = hl.healpix_rings(nside).to(cuda), nside
    gen = torch.Generator(device=cuda).manual_seed(seed + nrows)
    F = torch.randn((nrows, 2, nm, rings.nrings), dtype=dtype, device=cuda, generator=gen)
    ct = torch.randn((nrows, rings.npix), dtype=dtype, device=cuda, generator=gen)
    before = (hl.hp_longitude.launches, hl.hp_longitude_adjoint.launches,
              hl.hp_longitude.launches_by_shape[rings.npix, nm, nrows])
    y1, y2 = hl.hp_longitude(F, rings), hl.hp_longitude(F, rings)
    g1, g2 = hl.hp_longitude_adjoint(ct, rings, nm), hl.hp_longitude_adjoint(ct, rings, nm)
    torch.cuda.synchronize()
    assert (hl.hp_longitude.launches, hl.hp_longitude_adjoint.launches,
            hl.hp_longitude.launches_by_shape[rings.npix, nm, nrows]) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
    assert torch.equal(_graph_replay(lambda: hl.hp_longitude(F, rings)), y1)
    assert torch.equal(_graph_replay(lambda: hl.hp_longitude_adjoint(ct, rings, nm)), g1)
    assert bool(torch.all((y1 - hl.hp_longitude_plain(F, rings)).abs()
                          <= RTOL[dtype] * hl.sum_abs_terms(rings, F=F)))
    assert bool(torch.all((g1 - hl.hp_longitude_adjoint_plain(ct, rings, nm)).abs()
                          <= RTOL[dtype] * hl.sum_abs_terms(rings, ct=ct)))


@pytest.mark.parametrize("nm", [5000, 9000])
def test_hp_longitude_long_rings_match_the_fft_route(cuda, nm):
    """Rings in the workspace with nm above their lengths: the synthesis
    folds several slabs of FOLD_SLAB m into bins held in the workspace (and,
    at nm 9000, into the ring of 8192 pixels in shared memory).  Held
    against the ``torch.fft`` route within 1e-12 of the per-output sum of
    |term| (the plain versions round m·φ_p to about that at these m); bitwise
    repeats and CUDA-graph replay."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    rings = _synthetic_rings(SYNTHETIC_RINGS["long"]).to(cuda)
    assert rings.ws_row > 0
    gen = torch.Generator(device=cuda).manual_seed(nm)
    F = torch.randn((2, 2, nm, rings.nrings), dtype=torch.float64, device=cuda, generator=gen)
    ct = torch.randn((2, rings.npix), dtype=torch.float64, device=cuda, generator=gen)
    y, g = hl.hp_longitude(F, rings), hl.hp_longitude_adjoint(ct, rings, nm)
    assert torch.equal(hl.hp_longitude(F, rings), y)
    assert torch.equal(hl.hp_longitude_adjoint(ct, rings, nm), g)
    assert torch.equal(_graph_replay(lambda: hl.hp_longitude(F, rings)), y)
    assert torch.equal(_graph_replay(lambda: hl.hp_longitude_adjoint(ct, rings, nm)), g)
    assert bool(torch.all((y - hl.hp_longitude_fft_route(F, rings)).abs()
                          <= RTOL[torch.float64] * hl.sum_abs_terms(rings, F=F)))
    assert bool(torch.all((g - hl.hp_longitude_adjoint_fft_route(ct, rings, nm)).abs()
                          <= RTOL[torch.float64] * hl.sum_abs_terms(rings, ct=ct)))


def test_hp_longitude_rows_and_adjoint_identity(cuda):
    from nifty_tpu_torch.ops import hp_longitude as hl

    rings = hl.healpix_rings(16).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    F = torch.randn((3, 2, 33, rings.nrings), dtype=torch.float64, device=cuda, generator=gen)
    ct = torch.randn((3, rings.npix), dtype=torch.float64, device=cuda, generator=gen)
    y, g = hl.hp_longitude(F, rings), hl.hp_longitude_adjoint(ct, rings, 33)
    for b in range(3):
        assert torch.equal(y[b:b + 1], hl.hp_longitude(F[b:b + 1].contiguous(), rings))
        assert torch.equal(g[b:b + 1],
                           hl.hp_longitude_adjoint(ct[b:b + 1].contiguous(), rings, 33))
    lhs, rhs = float(torch.sum(y * ct)), float(torch.sum(F * g))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    with pytest.raises(ValueError, match="on cpu"):
        hl.hp_longitude(F, hl.healpix_rings(16))


def test_healpix_field_on_the_card_matches_the_cpu(cuda):
    """A HEALPix correlated field (lmax 15, nside 8) with a leading batch axis
    of 2: forward, jvp, vjp and the recorded linearization run K10 and K10ᵀ
    on the card and agree with the plain versions on the CPU (1e-12)."""
    import nifty_tpu_torch as jt
    from nifty_tpu_torch.ops import hp_longitude as hl

    def build(device):
        cfm = jt.CorrelatedFieldMaker("sky")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(3e-1, 1e-1))
        cfm.add_fluctuations(15, None, fluctuations=(1.0, 0.5), loglogavgslope=(-3.0, 0.2),
                             flexibility=(1.0, 0.5), harmonic_type="healpix")
        return cfm.finalize(device=device)

    rng = np.random.default_rng(4)
    cpu = build("cpu")
    lat = {k: rng.standard_normal((2,) + v.shape) for k, v in cpu.domain.items()}
    tan = {k: rng.standard_normal((2,) + v.shape) for k, v in cpu.domain.items()}
    cot = rng.standard_normal((2, 12 * 8 ** 2))

    def run(field, device):
        x, t = ({k: torch.from_numpy(v).to(device) for k, v in d.items()} for d in (lat, tan))
        c = torch.from_numpy(cot).to(device)
        y, jt_ = torch.func.jvp(field, (x,), (t,))
        _, vjp_fn = torch.func.vjp(field, x)
        _, jvp_lin, vjp_lin = linearize(field, x)
        out = [y, jt_, jvp_lin(t)] + [v for g in (vjp_fn(c)[0], vjp_lin(c)) for v in g.values()]
        return [r.cpu() for r in out]

    hl.reset_launch_counts()
    on_card, on_cpu = run(build(cuda), cuda), run(cpu, torch.device("cpu"))
    assert hl.hp_longitude.launches > 0 and hl.hp_longitude_adjoint.launches > 0
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


# -- K11: the ray integral and its adjoint (ops/los_interp.py) -------------


def _los_table(case, dtype):
    """The tables of a line-of-sight response or of an interpolation, on the
    host: (rays, points, grid, order) of phases 4, 26-28's shapes at a small
    grid, a ray along the far face (NaN, its corners outside skipped), a
    grid of 1,386 cells (rows off the adjoint's 32-byte sectors), converging
    rays from one point, and SKI's clipped corners (P = 1, s = 1)."""
    from nifty_tpu_torch.ops import los_interp as li
    from nifty_tpu_torch.responses import ski

    npd = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(len(case))
    if case.startswith("ski"):
        shape = (40, 30) if case == "ski_2d" else (12, 10, 9)
        bounds = np.array([(0.0, 1.0)] * len(shape))
        pts = rng.uniform(-0.05, 1.05, size=(len(shape), 3000))
        idx, w = ski.interpolation_matrix(shape, bounds, pts)
        return li.LosTable.from_interpolation(idx, w.astype(npd), shape)
    if case == "los_observer":
        # rays out from one point, as 3-D dust maps look out from the Sun:
        # the cells around it hold CSR segments of hundreds of entries
        shape = (32,) * 3
        end = rng.uniform(0.05, 0.95, size=(256, 3))
        idx, w, scale, nan_rays = li.los_tables(np.full((1, 3), 0.5), end, shape,
                                                (1.0 / 32,) * 3, 64, 1, npd)
        return li.LosTable(idx, w, scale, shape, nan_rays)
    shape, nrays, npts, order = {"los_16": ((16,) * 3, 48, 64, 1),
                                 "los_32x32": ((16,) * 3, 32, 32, 1),
                                 "los_64": ((64,) * 3, 128, 128, 1),
                                 "los_wide": ((48,) * 3, 96, 256, 1),
                                 "los_o0": ((20, 24, 28), 40, 100, 0),
                                 "los_odd": ((9, 14, 11), 30, 40, 1)}[case]
    start = rng.uniform(0.05, 0.95, size=(nrays, 3))
    end = rng.uniform(0.05, 0.95, size=(nrays, 3))
    start[0], end[0] = (1.0, 0.2, 0.3), (1.0, 0.8, 0.6)  # along the far face of axis 0
    idx, w, scale, nan_rays = li.los_tables(start, end, shape, tuple(1.0 / n for n in shape),
                                            npts, order, npd)
    return li.LosTable(idx, w, scale, shape, nan_rays)


LOS_CASES = ["los_16", "los_32x32", "los_64", "los_wide", "los_o0", "los_odd", "los_observer",
             "ski_2d", "ski_3d"]


@pytest.mark.parametrize("case", LOS_CASES)
@pytest.mark.parametrize("nrows", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_los_kernels_match_plain_versions(cuda, case, nrows, dtype):
    """K11 and K11ᵀ against their plain versions within 1e-12 / 1e-5 of the
    per-output sum of |term|, bitwise repeats, a row alone equal to its row
    of a batch (the order of additions depends on the table alone)."""
    from nifty_tpu_torch.ops import los_interp as li

    tab = _los_table(case, dtype).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn((nrows, tab.ncells), dtype=dtype, device=cuda, generator=gen)
    ybar = torch.randn((nrows, tab.nrays), dtype=dtype, device=cuda, generator=gen)
    before = (li.los_integrate.launches, li.los_integrate_adjoint.launches,
              li.los_integrate.launches_by_shape[tab.key, nrows])
    y1, y2 = li.los_integrate(f, tab), li.los_integrate(f, tab)
    g1, g2 = li.los_integrate_adjoint(ybar, tab), li.los_integrate_adjoint(ybar, tab)
    torch.cuda.synchronize()
    assert (li.los_integrate.launches, li.los_integrate_adjoint.launches,
            li.los_integrate.launches_by_shape[tab.key, nrows]) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
    tiny = torch.finfo(dtype).tiny
    for got, want, scale in ((y1, li.los_integrate_plain(f, tab), li.sum_abs_terms(tab, f=f)),
                             (g1, li.los_integrate_adjoint_plain(ybar, tab),
                              li.sum_abs_terms(tab, ybar=ybar))):
        assert bool(torch.all((got - want).abs() <= RTOL[dtype] * scale.clamp_min(tiny)))
    # untouched cells are written (zero), every row alone as in the batch
    assert bool(torch.isfinite(g1).all())
    assert torch.equal(li.los_integrate(f[-1:].contiguous(), tab), y1[-1:])
    assert torch.equal(li.los_integrate_adjoint(ybar[-1:].contiguous(), tab), g1[-1:])


def test_los_response_on_the_card_matches_the_cpu(cuda):
    """SamplingCartesianGridLOS on fields (2, 16, 16, 16): forward (NaN on
    the far-face ray), jvp, vjp and the recorded linearization run K11 and
    K11ᵀ on the card and agree with the plain versions on the CPU (1e-12)."""
    import nifty_tpu_torch as jt
    from nifty_tpu_torch.ops import los_interp as li

    rng = np.random.default_rng(5)
    start, end = rng.uniform(0.05, 0.95, size=(24, 3)), rng.uniform(0.05, 0.95, size=(24, 3))
    start[0], end[0] = (1.0, 0.2, 0.3), (1.0, 0.8, 0.6)
    kw = dict(shape=(16,) * 3, distances=(1 / 16,) * 3, n_sampling_points=40)
    x0, t0 = rng.standard_normal((2, 16, 16, 16)), rng.standard_normal((2, 16, 16, 16))
    c0 = rng.standard_normal((2, 24))

    def run(device):
        los = jt.SamplingCartesianGridLOS(start, end, device=device, **kw)
        x, t, c = (torch.from_numpy(a).to(device) for a in (x0, t0, c0))
        y, tan = torch.func.jvp(los, (x,), (t,))
        _, vjp_fn = torch.func.vjp(los, x)
        _, jvp_lin, vjp_lin = linearize(los, x)
        return [r.cpu() for r in (y, tan, jvp_lin(t), vjp_fn(c)[0], vjp_lin(c))]

    li.reset_launch_counts()
    on_card, on_cpu = run(cuda), run(torch.device("cpu"))
    assert li.los_integrate.launches > 0 and li.los_integrate_adjoint.launches > 0
    assert bool(torch.isnan(on_card[0][:, 0]).all())
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(
            want[torch.isfinite(want)].abs().max()), equal_nan=True)


def test_los_wrappers_raise_on_bad_inputs(cuda):
    from nifty_tpu_torch.ops import los_interp as li

    tab = _los_table("los_16", torch.float64)  # stays on the CPU
    with pytest.raises(ValueError, match="on cpu"):
        li.los_integrate(torch.ones((1, tab.ncells), dtype=torch.float64, device=cuda), tab)
    tab = tab.to(cuda)
    with pytest.raises(TypeError):
        li.los_integrate(torch.ones((1, tab.ncells), dtype=torch.float32, device=cuda), tab)
    with pytest.raises(ValueError, match="shape"):
        li.los_integrate_adjoint(torch.ones((1, tab.nrays + 1), dtype=torch.float64,
                                            device=cuda), tab)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_los_slab_route_on_the_card(cuda, dtype):
    """K11 on the slabs of a 16^3 grid (rows 0-7, 8-15 and all 16): the
    (ray, row) partials (``los_slab_forward``, exactly one launch a call)
    and the slab adjoint against their plain versions within 1e-12 / 1e-5
    of the per-output sum of |term|, +0 where a pair holds no virtual ray,
    each half slab's partials and adjoint bitwise the whole grid's rows
    (what makes a world of two field ranks give the bits of one), the ray
    values of the rows folded equal to the route's own."""
    from nifty_tpu_torch.ops import los_interp as li
    from nifty_tpu_torch.tree import _fold_halving

    npd = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(16)
    start, end = rng.uniform(0.05, 0.95, size=(48, 3)), rng.uniform(0.05, 0.95, size=(48, 3))
    tables = li.los_tables(start, end, (16,) * 3, (1 / 16,) * 3, 64, 1, npd)
    slabs = {rows: li.LosSlab(*tables[:3], (16,) * 3, rows, tables[3]).to(cuda)
             for rows in ((0, 8), (8, 16), (0, 16))}
    gen = torch.Generator(device=cuda).manual_seed(1)
    f = torch.randn((2, 16 ** 3), dtype=dtype, device=cuda, generator=gen)
    ybar = torch.randn((2, 48), dtype=dtype, device=cuda, generator=gen)
    tiny = torch.finfo(dtype).tiny
    got = {}
    for (r0, r1), slab in slabs.items():
        fs = f[:, r0 * 256:r1 * 256].contiguous()
        li.reset_launch_counts()
        part, adj = li.slab_row_partials(fs, slab), li.los_integrate_adjoint(ybar, slab.table)
        torch.cuda.synchronize()
        assert li.slab_row_partials.launches == 1
        assert dict(li.slab_row_partials.launches_by_shape) == {(slab.key, 2): 1}
        assert li.los_integrate.launches == 0
        scale = li.slab_sum_abs_terms(slab, fs)
        assert bool(torch.all((part - li.slab_row_partials_plain(fs, slab)).abs()
                              <= RTOL[dtype] * scale.clamp_min(tiny)))
        assert not bool(torch.signbit(part[part == 0]).any())
        scale = li.sum_abs_terms(slab.table, ybar=ybar)
        assert bool(torch.all((adj - li.slab_adjoint_plain(ybar, slab)).abs()
                              <= RTOL[dtype] * scale.clamp_min(tiny)))
        got[r0, r1] = part, adj
    whole_part, whole_adj = got[0, 16]
    assert torch.equal(torch.cat([got[0, 8][0], got[8, 16][0]], 1), whole_part)
    assert torch.equal(torch.cat([got[0, 8][1], got[8, 16][1]], 1), whole_adj)
    assert torch.equal(li.slab_integrate(f, slabs[0, 16], None, True), _fold_halving(whole_part))


# -- K7: the NUFFT window pair (ops/nufft_window.py) ------------------------


def _window_table(case, dtype):
    """A point set's window tables on the host: 1-, 2- and 3-D grids at W =
    8 and 16 (3-D at 16: 256 leading taps, 16 stages of the spread), windows
    wider than a small grid (wrapping more than once), a dense cluster
    (hundreds of points a cell), the track of one baseline across a 2048^2
    grid (phase 35's shape, mostly empty blocks), and a uv coverage's
    centre on a 512^2 grid (hundreds of points a base cell in its middle,
    its outer lines empty)."""
    from nifty_tpu_torch.ops import nufft_window as nw

    rng = np.random.default_rng(len(case))
    shape, npts, width, spread = {"1d": ((64,), 300, 8, 0.5), "1d_w16": ((50,), 200, 16, 0.5),
                                  "2d": ((32, 24), 500, 8, 0.5), "2d_w16": ((24, 32), 300, 16, 0.5),
                                  "3d": ((10, 12, 14), 400, 8, 0.5), "wrap": ((4, 4), 100, 16, 0.5),
                                  "cluster": ((64, 64), 3000, 8, 0.01),
                                  "track": ((1024, 1024), 2849, 8, 0.0),
                                  "centre": ((256, 256), 30000, 8, 0.0),
                                  "3d_w16": ((8, 9, 10), 150, 16, 0.5)}[case]
    if case == "track":
        t = np.linspace(-1.0, 1.0, npts)
        coords = np.stack([300.0 * np.sin(t), 180.0 * np.cos(t)], axis=-1)
    elif case == "centre":
        coords = rng.normal(scale=1.5, size=(npts, 2))
    else:
        coords = rng.uniform(-spread, spread, size=(npts, len(shape))) * np.array(shape)
    return nw.WindowTable(shape, coords, width=width, dtype=dtype)


K7_CASES = ["1d", "1d_w16", "2d", "2d_w16", "3d", "wrap", "cluster", "track", "centre", "3d_w16"]


@pytest.mark.parametrize("case", K7_CASES)
@pytest.mark.parametrize("nrows", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_kernels_match_plain_versions(cuda, case, nrows, dtype):
    """K7's interpolation and spread against their plain versions within
    1e-12 / 1e-5 of the per-output sum of |term|, bitwise repeats, a row
    alone equal to its row of a batch, and adjoint to each other
    (<W g, v> = <g, W^H v> within 1e-12 / 1e-5 of |<W g, v>|)."""
    from nifty_tpu_torch.ops import nufft_window as nw

    tab = _window_table(case, dtype).to(cuda)
    cd = tab.complex_dtype
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn((nrows, tab.ncells), dtype=cd, device=cuda, generator=gen)
    v = torch.randn((nrows, tab.npts), dtype=cd, device=cuda, generator=gen)
    before = (nw.window_interp.launches, nw.window_spread.launches,
              nw.window_spread.launches_by_shape[tab.key, nrows])
    a1, a2 = nw.window_interp(g, tab), nw.window_interp(g, tab)
    s1, s2 = nw.window_spread(v, tab), nw.window_spread(v, tab)
    torch.cuda.synchronize()
    assert (nw.window_interp.launches, nw.window_spread.launches,
            nw.window_spread.launches_by_shape[tab.key, nrows]) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    tiny = torch.finfo(dtype).tiny
    for got, want, scale in ((a1, nw.window_interp_plain(g, tab), nw.sum_abs_terms(tab, g=g)),
                             (s1, nw.window_spread_plain(v, tab), nw.sum_abs_terms(tab, v=v))):
        assert bool(torch.all((got - want).abs() <= RTOL[dtype] * scale.clamp_min(tiny)))
    assert torch.equal(nw.window_interp(g[-1:].contiguous(), tab), a1[-1:])
    assert torch.equal(nw.window_spread(v[-1:].contiguous(), tab), s1[-1:])
    lhs = torch.vdot(a1.flatten(), v.flatten())
    rhs = torch.vdot(g.flatten(), s1.flatten())
    assert float((lhs - rhs).abs() / lhs.abs()) < RTOL[dtype]


@pytest.mark.parametrize("case", K7_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_spread_writes_plus_zero_where_no_window_reaches(cuda, case, dtype):
    """Every cell that no window reaches (the fill blocks' cells, and those
    of sum blocks) is +0, its sign bit clear, in every row."""
    from nifty_tpu_torch.ops import nufft_window as nw

    tab = _window_table(case, dtype)
    terms = nw.window_terms(np.diff(tab.csr_off.numpy()).reshape(tab.os_shape), tab.width)
    unreached = torch.from_numpy(terms.reshape(-1) == 0).to(cuda)
    tab = tab.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    v = -torch.rand((3, tab.npts), dtype=tab.complex_dtype, device=cuda, generator=gen)
    zeros = torch.view_as_real(nw.window_spread(v, tab))[:, unreached]
    assert bool((zeros == 0).all()) and not bool(torch.signbit(zeros).any())


@pytest.mark.parametrize("case", K7_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_factor_table_and_value_gather(cuda, case, dtype):
    """The factor table the kernel builds once a table is within 4 ulp of
    its plain version (the card's exponential and PyTorch's may round
    apart), a second call reuses it, and the values' gather is
    ``v[:, csr_pts]`` bit for bit."""
    from nifty_tpu_torch.ops import nufft_window as nw

    tab = _window_table(case, dtype).to(cuda)
    builds = nw.build_factors.launches
    fac = nw.build_factors(tab)
    assert nw.build_factors(tab) is fac and nw.build_factors.launches == builds + 1
    want = nw.csr_factors_plain(tab)
    eps = torch.finfo(dtype).eps
    assert bool(torch.all((fac - want).abs() <= 4 * eps * want.abs()))
    v = torch.randn((3, tab.npts), dtype=tab.complex_dtype, device=cuda)
    assert torch.equal(nw.gather_values(v, tab), v[:, tab.csr_pts.long()])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_kernels_captured_first_in_a_cuda_graph(cuda, dtype):
    """A table whose first K7 calls are captured in a CUDA graph keeps no
    factors from the capture: calls outside the graph, before and after its
    replays, and the replays themselves equal the calls on a twin table
    used outside any graph, bit for bit."""
    from nifty_tpu_torch.ops import nufft_window as nw

    twin, tab = (_window_table("2d", dtype).to(cuda) for _ in range(2))
    gen = torch.Generator(device=cuda).manual_seed(2)
    g = torch.randn((3, tab.ncells), dtype=tab.complex_dtype, device=cuda, generator=gen)
    v = torch.randn((3, tab.npts), dtype=tab.complex_dtype, device=cuda, generator=gen)
    want = nw.window_interp(g, twin), nw.window_spread(v, twin)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = nw.window_interp(g, tab), nw.window_spread(v, tab)
    assert tab.factors.numel() == 0
    for got in ((nw.window_interp(g, tab), nw.window_spread(v, tab)), captured):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _k7_bit_inputs(case, nrows, tab):
    """Spectra and values for the bit check: standard normal real and
    imaginary parts that numpy draws in float64 from a seed of the case and
    rows (float32 rounds the same draws), on the table's device."""
    rng = np.random.default_rng(zlib.crc32(f"{case} B={nrows}".encode()))
    draws = (rng.standard_normal((nrows, tab.ncells, 2)),
             rng.standard_normal((nrows, tab.npts, 2)))
    return tuple(torch.view_as_complex(torch.from_numpy(a).to(tab.dtype)).to(tab.xs.device)
                 for a in draws)


def _digest(x):
    """The first 8 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:8]


# The digests of the K7 kernels as first written (commit c550464's
# `nufft_window.cu`, on an NVIDIA H100 80GB HBM3 at 700 W): "interp spread"
# of each case, rows and type, on the inputs of `_k7_bit_inputs`.
K7_FIRST_BITS = {
    "1d B=1 f64": "cf487337 8d9501b2",
    "1d B=1 f32": "05274221 62cd77c0",
    "1d B=3 f64": "70e46e55 4b4d1b5a",
    "1d B=3 f32": "228c8e22 4fd1acfc",
    "1d B=8 f64": "9eddc85d 5f88f81a",
    "1d B=8 f32": "41619b17 b9546a3a",
    "1d_w16 B=1 f64": "9b24ad72 26d9bc62",
    "1d_w16 B=1 f32": "c0ac8700 fcbf54a1",
    "1d_w16 B=3 f64": "a7464536 6d87d6b2",
    "1d_w16 B=3 f32": "fb507712 ca7f159d",
    "1d_w16 B=8 f64": "dce47316 8831e3a8",
    "1d_w16 B=8 f32": "e94e7093 bd73d029",
    "2d B=1 f64": "1f204a41 94e5e914",
    "2d B=1 f32": "746257e5 226e3f99",
    "2d B=3 f64": "9fe7171b e5d3df68",
    "2d B=3 f32": "d15060a4 d759942e",
    "2d B=8 f64": "50cbe532 a49412b2",
    "2d B=8 f32": "2f0591d5 8db500e8",
    "2d_w16 B=1 f64": "b41ec32e dd0d9732",
    "2d_w16 B=1 f32": "31682de1 02de6e21",
    "2d_w16 B=3 f64": "642d8514 db870d1b",
    "2d_w16 B=3 f32": "0d2769d2 9fc9539c",
    "2d_w16 B=8 f64": "27b8a8dc 0c4d5525",
    "2d_w16 B=8 f32": "6ef03af1 86a4d9b2",
    "3d B=1 f64": "f8fb592d ad58359f",
    "3d B=1 f32": "ba49ac8d 9aa58eca",
    "3d B=3 f64": "31bbbd3e 3c88be52",
    "3d B=3 f32": "f711e30f b4c696fd",
    "3d B=8 f64": "57f7fa32 5b48d320",
    "3d B=8 f32": "901ed1e4 48600789",
    "wrap B=1 f64": "543571f1 eafa1a18",
    "wrap B=1 f32": "32c6b2f7 267227c6",
    "wrap B=3 f64": "bb67cb35 30af9ed3",
    "wrap B=3 f32": "99d58399 4df97a4f",
    "wrap B=8 f64": "eaf448ad 0a9c33b6",
    "wrap B=8 f32": "a332ecb6 4adc9a86",
    "cluster B=1 f64": "8c84e93e 8313b8bc",
    "cluster B=1 f32": "df7753c7 cdf484f3",
    "cluster B=3 f64": "87823a57 f484128f",
    "cluster B=3 f32": "d04d2f9b 7769d1f6",
    "cluster B=8 f64": "7c8f8641 68b5cbd8",
    "cluster B=8 f32": "bfc21ede ba5ef582",
    "track B=1 f64": "25e1652a ccb3d1bd",
    "track B=1 f32": "8fbfbe38 d8aba116",
    "track B=3 f64": "4ec8ff07 84f54f98",
    "track B=3 f32": "21f530f7 db35c21a",
    "track B=8 f64": "f398ceca e5cbbcc6",
    "track B=8 f32": "dd668685 e9857c3d",
    "centre B=1 f64": "978b9be6 1eb0ffa6",
    "centre B=1 f32": "6dacdb9f 0dea4474",
    "centre B=3 f64": "37beceb0 6dc0bbc3",
    "centre B=3 f32": "f99bf745 d058d1a6",
    "centre B=8 f64": "ebd93a3a 577876ba",
    "centre B=8 f32": "5eb88915 e7a27bc0",
    "3d_w16 B=1 f64": "7cdb42dd 2336bd43",
    "3d_w16 B=1 f32": "e6016196 5addb237",
    "3d_w16 B=3 f64": "edaa31d6 160e30e2",
    "3d_w16 B=3 f32": "b74cb16f de008f13",
    "3d_w16 B=8 f64": "60753b0a c7383da3",
    "3d_w16 B=8 f32": "6b49ae52 3f73d08e",
}


@pytest.mark.parametrize("case", K7_CASES)
@pytest.mark.parametrize("nrows", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_kernels_keep_their_first_bits(cuda, case, nrows, dtype):
    """Both K7 kernels' outputs equal those of the kernels as first written
    bit for bit (their digests, `K7_FIRST_BITS`): the order of every sum is
    kept."""
    from nifty_tpu_torch.ops import nufft_window as nw

    tab = _window_table(case, dtype).to(cuda)
    g, v = _k7_bit_inputs(case, nrows, tab)
    got = f"{_digest(nw.window_interp(g, tab))} {_digest(nw.window_spread(v, tab))}"
    key = f"{case} B={nrows} {'f64' if dtype == torch.float64 else 'f32'}"
    assert got == K7_FIRST_BITS[key]


def test_radio_response_on_the_card_matches_the_cpu(cuda):
    """A w-stacked RadioResponse on images (2, 32, 32): forward, jvp, vjp and
    the recorded linearization run K7 on the card and agree with the plain
    versions on the CPU (1e-12)."""
    from nifty_tpu_torch.ops import nufft_window as nw
    from nifty_tpu_torch.ops.nufft import RadioResponse

    rng = np.random.default_rng(7)
    uv = rng.uniform(-1.0, 1.0, size=(800, 2)) * 2e4
    w = 0.5 * uv[:, 0] + rng.normal(scale=1e3, size=800)
    kw = dict(pixsize=0.2 / 2e4, w=w, n_w_planes=4)
    x0, t0 = rng.standard_normal((2, 32, 32)), rng.standard_normal((2, 32, 32))
    c0 = rng.standard_normal((2, 800)) + 1j * rng.standard_normal((2, 800))

    def run(device):
        rr = RadioResponse((32, 32), uv, device=device, **kw)
        x, t, c = (torch.from_numpy(a).to(device) for a in (x0, t0, c0))
        y, tan = torch.func.jvp(rr, (x,), (t,))
        _, vjp_fn = torch.func.vjp(rr, x)
        _, jvp_lin, vjp_lin = linearize(rr, x)
        return [r.cpu() for r in (y, tan, jvp_lin(t), vjp_fn(c)[0], vjp_lin(c))]

    nw.reset_launch_counts()
    on_card, on_cpu = run(cuda), run(torch.device("cpu"))
    assert nw.window_interp.launches > 0 and nw.window_spread.launches > 0
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def test_window_wrappers_raise_on_bad_inputs(cuda):
    from nifty_tpu_torch.ops import nufft_window as nw

    tab = _window_table("2d", torch.float64)  # stays on the CPU
    g = torch.ones((1, tab.ncells), dtype=torch.complex128, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        nw.window_interp(g, tab)
    tab = tab.to(cuda)
    with pytest.raises(TypeError):
        nw.window_interp(g.to(torch.complex64), tab)
    with pytest.raises(ValueError, match="shape"):
        nw.window_spread(torch.ones((1, tab.npts + 1), dtype=torch.complex128, device=cuda), tab)
    with pytest.raises(ValueError, match="contiguous"):
        nw.window_interp(torch.ones((tab.ncells, 2), dtype=torch.complex128, device=cuda).T, tab)


# -- the field-sharded distributor and the mesh's transports -----------------------


def _slab_maps(n0, n1, nb, rows, seed):
    """A random full-grid map of (n0, n1) with every bin occupied, its
    block of ``rows`` rows (a field rank's slab), and the (row, bin) maps
    of both."""
    full = _index_map(nb, n0 * n1, seed).reshape(n0, n1)
    lo, hi = rows
    return full, full[lo:hi]


@pytest.mark.parametrize("shape", [(64, 48, 40), (512, 512, 113)], ids=["64x48", "512sq"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_slab_and_row_bin_maps_match_plain_versions(cuda, shape, dtype):
    """The distributor on a field rank's rows of a map (the slab) and on
    their (row, bin) map: the gather bitwise, the segment sums within the
    tolerance of the per-bin sum of |cot|, as the field-sharded
    correlated field launches them."""
    n0, n1, nb = shape
    _, slab = _slab_maps(n0, n1, nb, (n0 // 2, n0), seed=n0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for dist in (bg.BinIndex(slab, nb=nb).to(cuda), bg.row_bin_index(slab, nb).to(cuda)):
        for nrows in (1, 3):
            table = torch.randn((nrows, dist.nb), dtype=dtype, device=cuda, generator=gen)
            cot = torch.randn((nrows, dist.n), dtype=dtype, device=cuda, generator=gen)
            assert torch.equal(bg.bin_gather(table, dist), bg.bin_gather_plain(table, dist.idx))
            got = bg.bin_segment_sum(cot, dist)
            plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
            scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
            assert bool(torch.all((got - plain).abs() <= RTOL[dtype] * scale))


@pytest.mark.parametrize("n0", [64, 512])
def test_row_bin_sums_do_not_depend_on_the_segment_offset(cuda, n0):
    """A (row, bin) segment sums in the same order wherever it starts in
    the CSR: each half of the rows' map gives the bits of the whole map's
    rows (so every field rank sums its rows as one rank holding them all
    does)."""
    nb = 113
    full, _ = _slab_maps(n0, 256, nb, (0, n0), seed=n0)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = torch.randn((2, full.size), dtype=torch.float64, device=cuda, generator=gen)
    whole = bg.bin_segment_sum(cot, bg.row_bin_index(full, nb).to(cuda)).reshape(2, n0, nb)
    half = n0 // 2
    for lo in (0, half):
        part = bg.row_bin_index(full[lo:lo + half], nb).to(cuda)
        sums = bg.bin_segment_sum(cot[:, lo * 256:(lo + half) * 256].contiguous(), part)
        assert torch.equal(sums.reshape(2, half, nb), whole[:, lo:lo + half])


def test_fft_of_contiguous_rows_does_not_depend_on_their_number(cuda):
    """The pencil transform's FFTs run on contiguous rows with the axis
    innermost: on the card a row's bits do not depend on how many rows
    share the call (the 1-rank and the p-rank worlds cut the columns
    differently)."""
    from nifty_tpu_torch.ops.distributed_fft import _fft_along

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 4096, 1025), dtype=torch.complex128, device=cuda, generator=gen)
    whole = _fft_along(x, 1)
    for cols in (1, 2, 513, 1024):
        assert torch.equal(_fft_along(x[:, :, :cols].contiguous(), 1), whole[:, :, :cols])
    r = torch.randn((4096, 4096), dtype=torch.float64, device=cuda, generator=gen)
    rows = torch.fft.rfft(r, dim=-1)
    for n in (1, 2048):
        assert torch.equal(torch.fft.rfft(r[:n].contiguous(), dim=-1), rows[:n])


def test_row_sums_on_the_card_depend_on_the_row_count(cuda):
    """Why the lockstep maps loop over samples on the card under
    ``deterministic_reductions`` with a mesh active
    (``optimize_kl._lockstep_depends_on_world``): ``torch.sum`` along the
    rows of a (B, n) tensor picks its threads by B, so a row's sum takes
    other bits when a samples rank stacks another share of the rows; the
    port's fixed-order fold keeps them."""
    from nifty_tpu_torch.tree import _fold_halving_sum_rows

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((8, 4096), dtype=torch.float64, device=cuda, generator=gen)
    sums = [x[:b].sum(-1)[0].item() for b in (1, 2, 4, 8)]
    assert len(set(sums)) > 1, sums
    folds = [_fold_halving_sum_rows(x[:b])[0].item() for b in (1, 2, 4, 8)]
    assert len(set(folds)) == 1, folds


def test_slab_reductions_on_the_card_follow_no_world(cuda):
    """What a 3-D field's slab worlds rely on: each row of a half slab gets
    the bits of the whole field's row from the row sums of the fixed-order
    reductions (``tree._row_partials``, one axis at a time) and from the
    pencil transform's middle-axis FFTs (``distributed_fft._middle_axes``,
    on contiguous rows), at 256^3."""
    from nifty_tpu_torch.ops.distributed_fft import _middle_axes
    from nifty_tpu_torch.tree import _row_partials

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1, 256, 256, 256), dtype=torch.float64, device=cuda, generator=gen)
    assert torch.equal(_row_partials(x[:, :128].contiguous()), _row_partials(x)[:, :128])
    f = torch.fft.rfftn(x[0], dim=(2,))
    assert torch.equal(_middle_axes(f[128:].contiguous(), 0), _middle_axes(f, 0)[128:])


def test_gloo_ranks_on_one_card_move_tensors_through_ipc(cuda):
    """A 2 x 2 gloo world on card 0: every collective, through the CUDA IPC
    mailboxes, gives what the ranks' inputs make it (bitwise; the pencil
    Hartley transform within 1e-12 of the whole field's)."""
    import torch_mesh_worker as W
    from nifty_tpu_torch.parallel import run_world

    ranks = run_world(W.run_cases, 4, args=([("t", "ipc_case", {})],), device="cuda",
                      timeout=300)
    for r in ranks:
        for k, (got, want) in r["t"].items():
            if k == "hartley":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
