"""The distributor's CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs an NVIDIA card and skips without one; the
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: the gather is a copy (bitwise equal, at every index width and
row alignment the kernel handles); the segment sum adds in
another order than the plain version, so it is held to 1e-12 (float64) or
1e-5 (float32) of the per-bin sum of |cot|, and two of its runs must be
bitwise equal (it uses no atomics), as must a replay of the call from a
CUDA graph and a call on one of the rows alone.
"""

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
    """A random map with every bin occupied."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nb, size=n)
    idx[:nb] = rng.permutation(nb)
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

    before = (bg.bin_gather.launches, bg.bin_segment_sum.launches)
    got = bg.bin_gather(table, dist)
    s1, s2 = bg.bin_segment_sum(cot, dist), bg.bin_segment_sum(cot, dist)
    torch.cuda.synchronize()
    assert (bg.bin_gather.launches, bg.bin_segment_sum.launches) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))
    assert torch.equal(s1, s2)
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


# (bins, entries, rows) for the gather alone: each edge of the narrow index
# map's width (uint8 up to 256 bins, int16 up to 32,768); an odd map with
# several rows, so rows start off a 16-byte boundary; maps shorter than one
# 8-element step, and of one entry; the 128^2 stacked KL stage; a table
# above the 227 KB a block can hold (read through the read-only cache).
GATHER_CASES = {
    "nb256": (256, 4099, 3), "nb257": (257, 4099, 3),
    "nb32768": (32768, 70001, 2), "nb32769": (32769, 70001, 2),
    "odd_rows": (113, 2049 * 65, 3), "short": (4, 5, 3), "one": (1, 1, 1),
    "128sq_B8": (1621, 16384, 8), "ldg": (60000, 200003, 2),
}


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gather_is_bit_exact(cuda, case, dtype):
    nb, n, nrows = GATHER_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(1)
    dist = bg.BinIndex(_index_map(nb, n, seed=nb + n), nb=nb).to(cuda)
    assert dist.idx_narrow.dtype == bg.narrow_index_dtype(nb)
    table = torch.randn((nrows, nb), dtype=dtype, device=cuda, generator=gen)
    before = bg.bin_gather.launches
    got = bg.bin_gather(table, dist)
    torch.cuda.synchronize()
    assert bg.bin_gather.launches == before + 1
    assert torch.equal(got, bg.bin_gather_plain(table, dist.idx))


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
# stage (1621 bins of at most 32 entries: warps only, one launch); three
# rows of an odd-length skewed map.
_rng = np.random.default_rng(11)
SEGSUM_CASES = {
    "one_bin_90pct": (np.bincount(np.where(_rng.random(1_200_000) < 0.9, 57,
                                           _rng.integers(0, 113, 1_200_000)), minlength=113), 1),
    "chunk_edges": ([C - 1, C, C + 1, 2 * C, 5, 0, 33, 32], 2),
    "empty_bins": ([0, 7, 0, 0, 5000, 0, 31, 0, 3 * C + 1, 0], 2),
    "nb1": ([3 * C + 17], 2),
    "n1": ([1, 0, 0], 1),
    "128sq_B8": (np.bincount(_index_map(1621, 16384, seed=1621), minlength=1621), 8),
    "B3_odd": (np.round(np.geomspace(1, 60000, 41)).astype(int) | 1, 3),
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
    plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
    scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
    assert bool(torch.all((s1 - plain).abs() <= RTOL[dtype] * scale))


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
