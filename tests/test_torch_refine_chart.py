"""Parity of the port's refinement charts (``nifty_tpu_torch.refine.chart``,
host numpy) with ``nifty_tpu.refine.chart``: the shape and distance
algebra, window starts (with the clamped last window), site counts,
positions and the index <-> coordinate maps, for ``extend`` and ``jump``,
``(coarse_size, fine_size)`` in (3, 2), (5, 4) and (5, 2), periodic and
irregular axes.

Both packages run the same numpy code, so every integer table is equal and
every coordinate equal to the bit (tolerance 0).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from nifty_tpu.refine import chart as jc  # noqa: E402
from nifty_tpu_torch.refine import chart as tc  # noqa: E402

STENCILS = [(3, 2, "extend"), (3, 2, "jump"), (5, 4, "extend"), (5, 4, "jump"),
            (5, 2, "extend"), (5, 2, "jump")]


def _warp(reg):
    return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)


@pytest.mark.parametrize("csz,fsz,strategy", STENCILS)
def test_shape_and_distance_algebra(csz, fsz, strategy):
    kw = dict(coarse_size=csz, fine_size=fsz, fine_strategy=strategy)
    for shape0 in ((8,), (11,), (12, 17), (13, 9)):
        for depth in (1, 2, 3):
            want = jc.coarse2fine_shape(shape0, depth, **kw)
            assert tc.coarse2fine_shape(shape0, depth, **kw) == want
            assert tc.fine2coarse_shape(want, depth, **kw) == jc.fine2coarse_shape(want, depth, **kw)
    for periodic in (True, (True, False)):
        want = jc.coarse2fine_shape((12, 8), 2, periodic=periodic, **kw) \
            if 12 % (1 if strategy == "jump" else fsz // 2) == 0 else None
        if want is not None:
            assert tc.coarse2fine_shape((12, 8), 2, periodic=periodic, **kw) == want
    for fn in ("coarse2fine_distances", "fine2coarse_distances"):
        want = getattr(jc, fn)((0.3, 0.7), 3, fine_size=fsz, fine_strategy=strategy)
        np.testing.assert_array_equal(
            getattr(tc, fn)((0.3, 0.7), 3, fine_size=fsz, fine_strategy=strategy), want)


CHARTS = {
    "regular_2d": dict(shape0=(9, 6), depth=2, distances0=(0.5, 0.8)),
    "periodic": dict(shape0=(8, 8), depth=2, distances0=0.5, periodic=(True, False)),
    "deformed": dict(shape0=(8, 7), depth=2, distances0=0.4, nonlinear_map=_warp),
    "irregular_axes": dict(shape0=(8, 7), depth=1, distances0=0.4, nonlinear_map=_warp,
                           irregular_axes=(0,)),
    "min_shape": dict(min_shape=(30,), depth=2, distances=0.1),
}


@pytest.mark.parametrize("csz,fsz,strategy", STENCILS)
@pytest.mark.parametrize("case", CHARTS)
def test_chart_tables_and_positions_match(case, csz, fsz, strategy):
    kw = dict(CHARTS[case], coarse_size=csz, fine_size=fsz, fine_strategy=strategy)
    if kw.get("periodic") and strategy == "extend" and 8 % (fsz // 2):
        pytest.skip("a periodic axis needs a size divisible by the window stride")
    try:
        want = jc.CoordinateChart(**kw)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)[:30]):
            tc.CoordinateChart(**kw)
        return
    got = tc.CoordinateChart(**kw)
    for attr in ("shape0", "shapes", "shape", "distances0", "distances", "periodic",
                 "regular_axes", "irregular_axes", "window_stride", "ndim", "depth"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.is_regular() == want.is_regular()
    for level in range(got.depth + 1):
        np.testing.assert_array_equal(got.positions(level), want.positions(level))
        assert got.rgoffset(level) == want.rgoffset(level)
        for a, b in zip(got.level_indices(level), want.level_indices(level)):
            np.testing.assert_array_equal(a, b)
        idx = [np.arange(n) for n in got.shapes[level]]
        rg = got.ind2rg(idx, level)
        for a, b in zip(rg, want.ind2rg(idx, level)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.rg2ind(rg, level), idx):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.rg2ind(rg, level, discretize=False),
                        want.rg2ind(rg, level, discretize=False)):
            np.testing.assert_array_equal(a, b)
        if level < got.depth:
            assert got.site_counts(level) == want.site_counts(level)
            for a, b in zip(got.window_starts(level), want.window_starts(level)):
                np.testing.assert_array_equal(a, b)
    # fractional indices between the pixels, broadcast (not meshed)
    frac = [np.linspace(0.0, n - 1.0, 7) for n in got.shape0]
    np.testing.assert_array_equal(got.positions_at(frac, 0), want.positions_at(frac, 0))


def test_chart_validation_matches():
    for kw in (dict(shape0=(8,), fine_size=3), dict(shape0=(8,), fine_strategy="other"),
               dict(), dict(shape0=(3, 2), depth=1)):
        with pytest.raises(ValueError):
            jc.CoordinateChart(**kw)
        with pytest.raises(ValueError):
            tc.CoordinateChart(**kw)
