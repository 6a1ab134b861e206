"""The distributor's CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs an NVIDIA card and skips without one; the
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: the gather is a copy (bitwise equal); the segment sum adds in
another order than the plain version, so it is held to 1e-12 (float64) or
1e-5 (float32) of the per-bin sum of |cot|, and two of its runs must be
bitwise equal (it uses no atomics).
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
