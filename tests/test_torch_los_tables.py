"""The host side of the ray integral kernels K11 (``ops/los_interp.py``):
the adjoint's compact list of touched cells, the forward's lane groups and
the rule that picks the rows a forward block serves, on the CPU.

The kernels' order of additions is emulated where a rule claims it keeps
the bits: the butterfly of a narrower lane group against the 32-lane one,
bit for bit in float64 and float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nifty_tpu_torch.ops import los_interp as li  # noqa: E402

# the H100's streaming multiprocessors
N_SM = 132
# phases 26-28's tables: (grid, rays, points) and the rows they launch
PHASE_TABLES = {"16^3": ((16,) * 3, 48, 64, 7, (1, 4, 8)),
                "64^3": ((64,) * 3, 128, 128, 5, (1, 4, 8)),
                "256^3": ((256,) * 3, 1024, 256, 5, (1,))}


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _table(dims, nrays, npts, seed, order=1, one_start=False):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.05, 0.95, size=(1 if one_start else nrays, len(dims)))
    end = rng.uniform(0.05, 0.95, size=(nrays, len(dims)))
    idx, w, scale, nan_rays = li.los_tables(start, end, dims, tuple(1.0 / d for d in dims), npts,
                                            order)
    return li.LosTable(idx, w, scale, dims, nan_rays)


@pytest.mark.parametrize("case", ["16^3", "64^3", "one_start", "order_0", "ski"])
def test_compact_touched_cells_are_the_csr_cells_in_order(case):
    """``cells_narrow`` is ``adjoint_csr``'s ``cells`` as int32, in CSR
    order, one entry a segment; every cell not in it is clear in the mask."""
    if case == "ski":
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 700, size=(500, 4))
        tab = li.LosTable(idx, rng.standard_normal((500, 4)), np.ones(500), (700,))
    else:
        geometry = {"one_start": ((12, 13, 14), 40, 48, 2), "order_0": ((20, 24, 28), 40, 100, 4),
                    **{k: v[:4] for k, v in PHASE_TABLES.items()}}
        tab = _table(*geometry[case], order=0 if case == "order_0" else 1,
                     one_start=case == "one_start")
    csr = li.adjoint_csr(tab.idx.numpy(), tab.w.numpy(), tab.ncells)
    assert tab.cells_narrow.dtype == torch.int32
    np.testing.assert_array_equal(tab.cells_narrow.numpy(), csr["cells"])
    assert tab.cells_narrow.numel() == tab.n_touched == tab.seg_off.numel() - 1
    assert bool(torch.all(tab.cells_narrow[1:] > tab.cells_narrow[:-1]))
    mask = tab.mask.numpy().view(np.uint32)
    cells = np.arange(tab.ncells)
    set_bits = np.flatnonzero((mask[cells >> 5] >> (cells & 31).astype(np.uint32)) & 1)
    np.testing.assert_array_equal(set_bits, tab.cells_narrow.numpy())


def test_compact_list_is_a_non_persistent_buffer_that_follows_to():
    tab = _table((10, 11, 12), 20, 24, 5)
    assert "cells_narrow" in dict(tab.named_buffers())
    assert "cells_narrow" not in tab.state_dict()
    meta = tab.to("meta")
    assert meta.cells_narrow.device.type == "meta" and meta.cells_narrow.dtype == torch.int32
    # a float type conversion leaves the index tables alone
    half = _table((10, 11, 12), 20, 24, 5).to(torch.float32)
    assert half.cells_narrow.dtype == torch.int32 and half.w.dtype == torch.float32


def test_grids_above_int32_are_refused():
    """The compact list (and every index table) is int32: a grid of 2^31
    cells or more is refused before any table is built."""
    with pytest.raises(ValueError, match="2\\^31"):
        li.LosTable(np.zeros((1, 1), np.int32), np.ones((1, 1)), np.ones(1), (2**16, 2**15))


@pytest.mark.parametrize("nent, lanes", [(0, 1), (1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                         (8, 8), (9, 16), (16, 16), (17, 32), (256, 32),
                                         (257, 64), (512, 64), (1024, 128), (2048, 256),
                                         (100000, 256)])
def test_lanes_per_ray(nent, lanes):
    """A power of two from E alone: E rounded up while E <= 16 (SKI's 2^d
    corners, short order-0 rays), else 32 a warp for E / 256 warps rounded
    up to a power of two, at most 8."""
    assert li.lanes_per_ray(nent) == lanes


# (table, rows) -> rows a forward block serves on 132 SMs
ROW_TILES = {("16^3", 1): 1, ("16^3", 4): 1, ("16^3", 8): 1,
             ("64^3", 1): 1, ("64^3", 4): 1, ("64^3", 8): 2, ("256^3", 1): 1}


@pytest.mark.parametrize("case", sorted(ROW_TILES), ids=lambda c: f"{c[0]}-B{c[1]}")
def test_forward_row_tile_at_the_phase_shapes(case):
    """One row a block while the rays' blocks times the row tiles leave SMs
    idle: 16^3 (12 blocks of 4 rays) and 64^3 (64 blocks of 2 rays) at 4
    rows take one row a block; 64^3 at 8 rows fills the card with 2."""
    (dims, nrays, npts, _, _), nrows = PHASE_TABLES[case[0]], case[1]
    nent = npts * 8
    tile = li.forward_row_tile(nrays, nent, nrows, N_SM)
    assert tile == ROW_TILES[case]
    assert tile in (1, 2, li.ROW_TILE) and tile <= max(1, nrows)


@pytest.mark.parametrize("nrays, nent", [(48, 512), (128, 1024), (1024, 2048), (3000, 4),
                                         (1, 2048), (5, 100)])
def test_forward_row_tile_fills_the_card_and_the_grid(nrays, nent):
    """A tile wider than one row leaves no SM idle, the tile never exceeds
    the rows' power of two, and every row count up to ``MAX_ROWS`` keeps
    the grid's y dimension within 65535."""
    ray_blocks = -(-nrays // (li.THREADS // li.lanes_per_ray(nent)))
    for nrows in (1, 2, 3, 4, 5, 8, 12, 24, 100, 1000, 10**5, li.MAX_ROWS):
        tile = li.forward_row_tile(nrays, nent, nrows, N_SM)
        assert tile in (1, 2, li.ROW_TILE)
        if tile > 1:
            assert ray_blocks * -(-nrows // tile) >= N_SM
            assert tile // 2 < nrows
        assert -(-nrows // tile) <= 65535


def test_calls_above_the_row_limit_are_refused():
    tab = li.LosTable(np.array([[0, 1]], np.int32), np.ones((1, 2)), np.ones(1), (2,))
    with pytest.raises(ValueError, match="rows"):
        li.los_integrate(torch.zeros((li.MAX_ROWS + 1, 2), dtype=torch.float64), tab)


def _butterfly(lanes, width, dtype):
    """Lane 0 of the kernels' butterfly: offsets 16, 8, ... below `width`,
    each lane adding its partner's value, in `dtype`."""
    v = np.array(lanes, dtype=dtype)
    off = 16
    while off > 0:
        if off < width:
            v = (v + v[np.arange(v.size) ^ off]).astype(dtype)
        off //= 2
    return v[0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_narrow_lane_groups_give_the_bits_of_a_whole_warp(dtype):
    """For E <= 16 a ray's group is E rounded up to a power of two, not a
    whole warp, whose lanes past E would hold +0 (a lane's sum starts at +0
    and so is never -0).  The butterfly over the narrow group equals the
    whole warp's, bit for bit, on values of every scale and sign."""
    rng = np.random.default_rng(4)
    for nent in range(1, 17):
        g = li.lanes_per_ray(nent)
        for _ in range(50):
            vals = rng.standard_normal(nent) * 10.0 ** rng.integers(-30, 30, nent)
            vals[rng.random(nent) < 0.2] = 0.0
            warp = np.zeros(32, dtype)
            warp[:nent] = vals
            narrow = _butterfly(warp[:g], g, dtype)
            whole = _butterfly(warp, 32, dtype)
            assert narrow.tobytes() == whole.tobytes()
