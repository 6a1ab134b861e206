"""The host side of the NUFFT window kernels K7 (``ops/nufft_window.py``):
the terms each cell takes, the spread's sum blocks (most terms first) and
fill chunks (the cells no window reaches), each point's first tap cells and
axis factors in CSR order and the values' gather, on the CPU.

The shapes are the card tests' (``tests/test_torch_cuda_kernels.py``,
``K7_CASES``) and a track of baselines across phase 35's 2048^2 grid.  The
factors are held to the plain version's weights within 1 ulp; everything
else is integer bookkeeping and is held exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nifty_tpu_torch.ops import nufft_window as nw  # noqa: E402

# the card tests' K7 cases: (image shape, points, W, spread), and phase 35's
# grid crossed by the tracks of 24 baselines
CASES = {"1d": ((64,), 300, 8, 0.5), "1d_w16": ((50,), 200, 16, 0.5),
         "2d": ((32, 24), 500, 8, 0.5), "2d_w16": ((24, 32), 300, 16, 0.5),
         "3d": ((10, 12, 14), 400, 8, 0.5), "wrap": ((4, 4), 100, 16, 0.5),
         "cluster": ((64, 64), 3000, 8, 0.01), "track": ((1024, 1024), 2849, 8, 0.0),
         "centre": ((256, 256), 30000, 8, 0.0), "3d_w16": ((8, 9, 10), 150, 16, 0.5),
         "radio_tracks": ((1024, 1024), 24 * 400, 8, 0.0)}


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _coords(case):
    rng = np.random.default_rng(len(case))
    shape, npts, _, spread = CASES[case]
    if case == "track":
        t = np.linspace(-1.0, 1.0, npts)
        return np.stack([300.0 * np.sin(t), 180.0 * np.cos(t)], axis=-1)
    if case == "centre":
        return rng.normal(scale=1.5, size=(npts, 2))
    if case == "radio_tracks":
        # ellipses of 24 baselines, 400 steps each, as earth rotation draws them
        h = np.linspace(-1.0, 1.0, 400)
        radii = rng.uniform(5.0, 450.0, size=24)
        phase = rng.uniform(0.0, 2.0 * np.pi, size=24)
        u = radii[:, None] * np.sin(h[None, :] + phase[:, None])
        v = 0.7 * radii[:, None] * np.cos(h[None, :] + phase[:, None])
        return np.stack([u.ravel(), v.ravel()], axis=-1)
    return rng.uniform(-spread, spread, size=(npts, len(shape))) * np.array(shape)


_TABLES = {}


def _table(case, dtype=torch.float64):
    if (case, dtype) not in _TABLES:
        shape, _, width, _ = CASES[case]
        _TABLES[case, dtype] = nw.WindowTable(shape, _coords(case), width=width, dtype=dtype)
    return _TABLES[case, dtype]


def _entry_terms(tab):
    """The terms of each cell, counted from the plain version's entries."""
    cells, _ = nw.window_entries(tab)
    return np.bincount(cells.reshape(-1).numpy(), minlength=tab.ncells)


def _block_cells(tab):
    """Each cell's spread block (line-major, SPREAD_CELLS cells a segment)."""
    nl = tab.os_shape[-1]
    segs = -(-nl // nw.SPREAD_CELLS)
    cell = np.arange(tab.ncells)
    return (cell // nl) * segs + (cell % nl) // nw.SPREAD_CELLS


def _block_terms(tab):
    """The terms of each spread block, from the plain version's entries."""
    return np.bincount(_block_cells(tab), weights=_entry_terms(tab)).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_window_terms_count_the_plain_entries(case):
    """``window_terms`` is the per-cell count of the plain version's (point,
    tap) entries; the reached cells are those with a term."""
    tab = _table(case)
    terms = nw.window_terms(np.diff(tab.csr_off.numpy()).reshape(tab.os_shape), tab.width)
    np.testing.assert_array_equal(terms.reshape(-1), _entry_terms(tab))
    assert tab.n_reached == np.count_nonzero(terms)


@pytest.mark.parametrize("case", list(CASES))
def test_sum_blocks_are_the_reached_blocks_most_terms_first(case):
    """The sum blocks are exactly the blocks with a term, each once, in
    non-increasing order of terms, ties in block order."""
    tab = _table(case)
    block_terms = _block_terms(tab)
    blocks = tab.sum_blocks.numpy()
    assert tab.sum_blocks.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(blocks), np.flatnonzero(block_terms))
    key = np.stack([-block_terms[blocks], blocks])
    assert np.all(np.diff(key[0]) >= 0)
    ties = np.diff(key[0]) == 0
    assert np.all(np.diff(key[1])[ties] > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_fill_chunks_cover_exactly_the_unreached_blocks(case):
    """The fill chunks cover each cell of a block that no window reaches
    once and no other cell; each chunk holds at most FILL_CELLS cells and
    stays between two multiples of FILL_CELLS; the sum blocks' cells and
    the fill's partition the grid."""
    tab = _table(case)
    fill = tab.fill.numpy()
    assert tab.fill.dtype == torch.int32 and fill.ndim == 2 and fill.shape[1] == 2
    assert np.all(fill[:, 1] > 0) and np.all(fill[:, 1] <= nw.FILL_CELLS)
    assert np.all(fill[:, 0] // nw.FILL_CELLS == (fill.sum(1) - 1) // nw.FILL_CELLS)
    written = np.zeros(tab.ncells, dtype=np.int64)
    for first, count in fill:
        written[first:first + count] += 1
    idle = _block_terms(tab)[_block_cells(tab)] == 0
    np.testing.assert_array_equal(written, idle.astype(np.int64))
    summed = np.isin(_block_cells(tab), tab.sum_blocks.numpy())
    np.testing.assert_array_equal(summed, ~idle)
    if case in ("track", "radio_tracks", "centre"):
        assert 0 < idle.sum() < tab.ncells


def test_fill_chunks_of_misaligned_and_empty_runs():
    """Lines whose length is not a multiple of the block's cells: runs start
    and end inside a line, and a grid with every block reached has no fill
    chunk."""
    active = np.array([0, 0, 1, 0, 0, 0, 1, 1, 0], dtype=np.uint8)  # 3 lines x 3 blocks of 70
    fill = nw.fill_chunks(active, 70, cells=32, chunk=64)
    want = np.zeros(210, dtype=np.int64)
    for b in np.flatnonzero(active == 0):
        line, seg = divmod(b, 3)
        want[line * 70 + seg * 32:line * 70 + min(seg * 32 + 32, 70)] = 1
    got = np.zeros(210, dtype=np.int64)
    for first, count in fill:
        assert count <= 64 and first // 64 == (first + count - 1) // 64
        got[first:first + count] += 1
    np.testing.assert_array_equal(got, want)
    assert nw.fill_chunks(np.ones(9, dtype=np.uint8), 70).shape == (0, 2)


@pytest.mark.parametrize("case", list(CASES))
def test_csr_first_is_the_first_tap_cell_in_csr_order(case):
    """``csr_first[k]`` is the first tap's cell on each axis, wrapped, of
    the point at CSR position k: the plain entries' first cell."""
    tab = _table(case)
    pts = tab.csr_pts.long()
    cells, _ = nw.window_entries(tab)
    first = tab.csr_first.long()
    flat = torch.zeros(tab.npts, dtype=torch.long)
    for a, n in enumerate(tab.os_shape):
        flat = flat * n + first[:, a]
    assert tab.csr_first.dtype == torch.int32 and tab.csr_first.shape == (tab.npts, tab.d)
    assert torch.equal(flat, cells[pts, 0])
    assert bool(((first >= 0) & (first < torch.tensor(tab.os_shape))).all())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_csr_factors_multiply_to_the_plain_weights(case, dtype):
    """The factors in CSR order, multiplied over the axes first axis first
    as the kernels do, are the plain version's weights of that point within
    1 ulp."""
    tab = _table(case, dtype)
    fac = nw.csr_factors_plain(tab)
    assert fac.shape == (tab.npts, tab.d, tab.width) and fac.dtype == dtype
    _, weights = nw.window_entries(tab)
    prod = fac[:, 0]
    for a in range(1, tab.d):
        prod = (prod[:, :, None] * fac[:, a, None, :]).reshape(tab.npts, -1)
    want = weights[tab.csr_pts.long()]
    eps = torch.finfo(dtype).eps
    assert bool(torch.all((prod - want).abs() <= eps * want.abs()))


def test_value_gather_is_the_values_in_csr_order():
    tab = _table("cluster")
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=(3, tab.npts)) + 1j * rng.normal(size=(3, tab.npts)))
    got = nw.gather_values(v, tab)
    assert got.is_contiguous() and got.shape == v.shape
    assert torch.equal(got, v[:, tab.csr_pts.long()])


def test_new_buffers_are_non_persistent_and_follow_to():
    """The tables are buffers outside the state dict that ``.to()`` moves;
    the factor table stays empty until the card builds it."""
    tab = nw.WindowTable((16, 16), _coords("2d")[:40] / 2.0)
    assert tab.state_dict() == {}
    names = {"csr_first", "sum_blocks", "fill", "factors"}
    assert names <= {name for name, _ in tab.named_buffers()}
    assert tab.factors.numel() == 0 and tab.factors.dtype == tab.dtype
    moved = tab.to("meta")
    assert all(getattr(moved, name).device.type == "meta" for name in names)
