"""Parity of the port's NUFFT (``ops/nufft.py``; its window pair K7 of
``ops/nufft_window.py`` in its plain versions) and ``RadioResponse`` with
``nifty_tpu`` from the same numpy inputs.

Tolerances: ``nufft2`` / ``nufft1`` agree with the JAX package's to 1e-12
of the largest entry in float64 (the same terms summed in another order),
and to 1e-5 under ``transform_compute_dtype="float32"`` (the port runs the
transform in complex64; the JAX package promotes the image back to float64
at its deconvolution and keeps only its coordinates and weights in
float32).  The pair is adjoint to 1e-12 of ``|<F x, v>|``; the direct DFT
is matched to the JAX tests' 1e-3 (W = 8) and 1e-6 (W = 16); the JAX
package's window tables are equal array for array.  The derivatives are
compared by the conventions' relation: for a complex output, PyTorch's
vector-Jacobian product of ``v`` is ``J^H v`` where JAX's is ``J^T v``, so
``torch_vjp(v) = conj(jax_vjp(conj(v)))`` (its real part for a real
image).
"""

import itertools

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

from nifty_tpu.ops import nufft as jn  # noqa: E402
from nifty_tpu_torch import config as tconfig  # noqa: E402
from nifty_tpu_torch.ops import nufft as tn  # noqa: E402
from nifty_tpu_torch.ops import nufft_window as nw  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = tconfig.get("device")
    tconfig.update("device", "cpu")
    yield
    tconfig.update("device", old)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _inputs(shape, npts=40, cplx=True, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=shape) + (1j * rng.normal(size=shape) if cplx else 0)
    coords = rng.uniform(-0.5, 0.5, size=(npts, len(shape))) * np.array(shape)
    vals = rng.normal(size=npts) + 1j * rng.normal(size=npts)
    return img, coords, vals


SHAPES = [(32,), (16, 16), (8, 10, 12)]


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_nufft_pair_matches_jax(shape, width, cplx):
    img, coords, vals = _inputs(shape, cplx=cplx)
    _close(tn.nufft2(torch.from_numpy(img), coords, width=width),
           jn.nufft2(jnp.asarray(img), jnp.asarray(coords), width=width))
    _close(tn.nufft1(shape, torch.from_numpy(vals), coords, width=width),
           jn.nufft1(shape, jnp.asarray(vals), jnp.asarray(coords), width=width))


@pytest.fixture
def float32_transforms():
    from nifty_tpu import config as jconfig

    jconfig.update("transform_compute_dtype", "float32")
    tconfig.update("transform_compute_dtype", "float32")
    yield
    jconfig.update("transform_compute_dtype", None)
    tconfig.update("transform_compute_dtype", None)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_float32_transforms_match_jax(float32_transforms, shape):
    img, coords, vals = _inputs(shape, cplx=False)
    got = tn.nufft2(torch.from_numpy(img), coords)
    assert got.dtype == torch.complex128
    _close(got, jn.nufft2(jnp.asarray(img), jnp.asarray(coords)), 1e-5)
    got1 = tn.nufft1(shape, torch.from_numpy(vals), coords)
    assert got1.dtype == torch.complex128
    _close(got1, jn.nufft1(shape, jnp.asarray(vals), jnp.asarray(coords)), 1e-5)


def test_float32_positions_are_floored_in_float32():
    """A coordinate whose float64 and float32 positions floor to different
    cells takes the float32 cell, as the JAX package's cast coordinates do."""
    coords = np.array([[3.0 - 1e-9]])
    t32 = nw.WindowTable((16,), coords, dtype=torch.float32)
    t64 = nw.WindowTable((16,), coords, dtype=torch.float64)
    assert (int(t32.i0[0, 0]), int(t64.i0[0, 0])) == (6, 5)


def _direct_dft(img, coords):
    shape = img.shape
    grids = np.meshgrid(*[np.arange(n) - n // 2 for n in shape], indexing="ij")
    return np.array([np.sum(img * np.exp(-2j * np.pi * sum(
        fj * g / n for fj, g, n in zip(f, grids, shape)))) for f in coords])


@pytest.mark.parametrize("shape,width,tol", [((32,), 8, 1e-3), ((16, 16), 8, 1e-3),
                                             ((16, 16), 16, 1e-6)])
def test_nufft2_matches_the_direct_dft(shape, width, tol):
    img, coords, _ = _inputs(shape, npts=30, cplx=False, seed=3)
    v = tn.nufft2(torch.from_numpy(img), coords, width=width).numpy()
    ve = _direct_dft(img, coords)
    assert np.abs(v - ve).max() / np.abs(ve).max() < tol


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_nufft_pair_is_adjoint(shape):
    img, coords, vals = _inputs(shape, npts=60)
    x, v = torch.from_numpy(img), torch.from_numpy(vals)
    lhs = torch.vdot(tn.nufft2(x, coords), v)
    rhs = torch.vdot(x.flatten(), tn.nufft1(shape, v, coords).flatten())
    assert float((lhs - rhs).abs() / lhs.abs()) < 1e-12


@pytest.mark.parametrize("shape", SHAPES + [(6, 5)], ids=lambda s: "x".join(map(str, s)))
def test_window_aux_equals_jax(shape):
    _, coords, _ = _inputs(shape, npts=50)
    want = jn.nufft_window_aux(shape, coords)
    got = tn.nufft_window_aux(shape, coords)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_window_consts_change_no_value():
    shape = (24, 32)
    img, coords, _ = _inputs(shape, npts=100)
    aux = tn.nufft_window_aux(shape, coords)
    x = torch.from_numpy(img)
    assert torch.equal(tn.nufft2(x, coords, window_consts=aux), tn.nufft2(x, coords))


def test_window_table_shares_its_tables_across_calls_and_batches():
    shape = (16, 16)
    img, coords, _ = _inputs(shape)
    tab = nw.WindowTable(shape, coords)
    x = torch.from_numpy(np.stack([img, 2 * img]))
    out = tn.nufft2(x, table=tab)
    assert out.shape == (2, coords.shape[0])
    _close(out[1], 2 * tn.nufft2(x[0], coords))
    with pytest.raises(ValueError, match="window table for images"):
        tn.nufft2(torch.zeros((8, 8), dtype=torch.complex128), table=tab)


def test_coordinates_that_require_a_gradient_are_refused():
    coords = torch.zeros((3, 2), dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="constants"):
        tn.nufft2(torch.zeros((8, 8), dtype=torch.float64), coords)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("shape", [(32,), (12, 10)], ids=lambda s: f"{len(s)}d")
def test_derivatives_match_jax(shape, cplx):
    img, coords, vals = _inputs(shape, cplx=cplx, seed=5)
    rng = np.random.default_rng(6)
    tan = rng.normal(size=shape) + (1j * rng.normal(size=shape) if cplx else 0)

    def f_j(x):
        return jn.nufft2(x, jnp.asarray(coords))

    def f_t(x):
        return tn.nufft2(x, coords)

    x_j, x_t = jnp.asarray(img), torch.from_numpy(img)
    _, jvp_j = jax.jvp(f_j, (x_j,), (jnp.asarray(tan),))
    _, jvp_t = torch.func.jvp(f_t, (x_t,), (torch.from_numpy(tan),))
    _close(jvp_t, jvp_j)

    _, vjp_j = jax.vjp(f_j, x_j)
    _, vjp_t = torch.func.vjp(f_t, x_t)
    (ct_t,) = vjp_t(torch.from_numpy(vals))
    (ct_j,) = vjp_j(jnp.conj(jnp.asarray(vals)))
    _close(ct_t, np.conj(np.asarray(ct_j)))

    batch = np.stack([img, 0.5 * img, -img])
    _close(torch.func.vmap(f_t)(torch.from_numpy(batch)), jax.vmap(f_j)(jnp.asarray(batch)))
    # the spread's derivatives through nufft1
    _, vjp1_t = torch.func.vjp(lambda v: tn.nufft1(shape, v, coords), torch.from_numpy(vals))
    _, vjp1_j = jax.vjp(lambda v: jn.nufft1(shape, v, jnp.asarray(coords)), jnp.asarray(vals))
    cot = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    _close(vjp1_t(torch.from_numpy(cot))[0], np.conj(np.asarray(vjp1_j(np.conj(cot))[0])))


def test_window_pair_functions_are_each_others_derivatives():
    shape = (10, 12)
    _, coords, vals = _inputs(shape, seed=7)
    tab = nw.WindowTable(shape, coords)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(2, tab.ncells)) + 1j * rng.normal(size=(2, tab.ncells)))
    v = torch.from_numpy(np.stack([vals, 1j * vals]))
    out, jvp = torch.func.jvp(lambda x: nw.WindowInterp.apply(x, tab), (g,), (g,))
    assert torch.equal(out, jvp)
    out, jvp = torch.func.jvp(lambda x: nw.WindowSpread.apply(x, tab), (v,), (v,))
    assert torch.equal(out, jvp)
    _, vjp = torch.func.vjp(lambda x: nw.WindowInterp.apply(x, tab), g)
    assert torch.equal(vjp(v)[0], nw.window_spread_plain(v, tab))
    _, vjp = torch.func.vjp(lambda x: nw.WindowSpread.apply(x, tab), v)
    assert torch.equal(vjp(g)[0], nw.window_interp_plain(g, tab))
    batched = torch.func.vmap(lambda x: nw.WindowInterp.apply(x, tab), in_dims=1)(
        torch.stack([g, 2 * g], dim=1))
    assert torch.equal(batched[1], nw.window_interp_plain(2 * g, tab))


# -- the kernels' algorithm, emulated ---------------------------------------


def _es_weight(x, cell, beta, half):
    s = (x - cell) / half
    return np.exp(beta * (np.sqrt(max(1.0 - s * s, 0.0)) - 1.0)) if abs(s) <= 1.0 else 0.0


def _emulated_spread(tab, v, cells=8, lanes=4, stage_rows=16):
    """The spread kernel's walk in numpy, with blocks of ``cells`` cells
    along the innermost axis and ``lanes`` lanes a cell (32 and 8 on the
    card): per block and stage of ``stage_rows`` leading taps, the CSR
    offsets of the base cells its windows reach; a cell's (leading tap,
    tap) items in row-major order, item i to lane i % lanes, each walking
    its base cell's points in CSR order; the lanes' sums by a butterfly."""
    d, w, n = tab.d, tab.width, tab.os_shape
    xs, off, pts = tab.xs.numpy(), tab.csr_off.numpy(), tab.csr_pts.numpy()
    nl, lo_shift = n[-1], w // 2 - 1
    segs = -(-nl // cells)
    leading = list(itertools.product(range(w), repeat=d - 1))
    out = np.zeros((v.shape[0], tab.ncells), complex)
    for line, seg in itertools.product(range(tab.ncells // nl), range(segs)):
        s0 = seg * cells
        lead = np.unravel_index(line, n[:-1]) if d > 1 else ()
        base_start = s0 - w + w // 2
        acc = np.zeros((cells, lanes, v.shape[0]), complex)
        for first in range(0, len(leading), stage_rows):
            stage = leading[first:first + stage_rows]
            base_lines = []
            for taps in stage:
                base_line = 0
                for a, t in enumerate(taps):
                    base_line = base_line * n[a] + (lead[a] - (t - lo_shift)) % n[a]
                base_lines.append(base_line)
            for th in range(min(cells, nl - s0)):
                for i in range(len(stage) * w):
                    row, t = divmod(i, w)
                    b = base_lines[row] * nl + (base_start + th + w - 1 - t) % nl
                    for k in range(off[b], off[b + 1]):
                        j = pts[k]
                        wt = None
                        for a, ta in enumerate(stage[row] + (t,)):
                            e = _es_weight(xs[j, a], np.floor(xs[j, a]) + ta - lo_shift,
                                           tab.beta, tab.half)
                            wt = e if wt is None else wt * e
                        acc[th, i % lanes] += wt * v[:, j]
        m = lanes // 2
        while m:
            acc = acc + acc[:, np.arange(lanes) ^ m]
            m //= 2
        for th in range(min(cells, nl - s0)):
            out[:, line * nl + s0 + th] = acc[th, 0]
    return out


@pytest.mark.parametrize("shape,width", [((6,), 8), ((12,), 5), ((2,), 8), ((4, 5), 8),
                                         ((8, 6), 16), ((3, 4, 5), 4), ((3, 4, 5), 8)],
                         ids=lambda p: str(p))
def test_spread_kernel_walk_equals_the_plain_spread(shape, width):
    """Windows wider than the grid wrap onto cells more than once; each
    (point, tap) pair still lands once."""
    _, coords, _ = _inputs(shape, npts=13, seed=9)
    tab = nw.WindowTable(shape, coords, width=width)
    rng = np.random.default_rng(10)
    v = rng.normal(size=(2, 13)) + 1j * rng.normal(size=(2, 13))
    want = nw.window_spread_plain(torch.from_numpy(v), tab).numpy()
    np.testing.assert_allclose(_emulated_spread(tab, v), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


# -- RadioResponse -----------------------------------------------------------


def _radio_inputs(n_vis=60, seed=11):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.0, 1.0, size=(n_vis, 2)) * 900.0
    w = rng.uniform(-2000.0, 2000.0, size=n_vis)
    return uv, w, 1.0 / (2.2 * 900.0 * 16)


@pytest.mark.parametrize("stacked", [False, True], ids=["coplanar", "w_stacked"])
def test_radio_response_matches_jax(stacked):
    shape = (16, 16)
    uv, w, pixsize = _radio_inputs()
    kw = dict(pixsize=pixsize, w=w if stacked else None, n_w_planes=4)
    rr_j, rr_t = jn.RadioResponse(shape, uv, **kw), tn.RadioResponse(shape, uv, **kw)
    assert rr_t.target.shape == (uv.shape[0],) and rr_t.target.dtype == torch.complex128
    img = np.random.default_rng(12).normal(size=shape)
    vis_j, vjp_j = jax.vjp(rr_j, jnp.asarray(img))
    _close(rr_t(torch.from_numpy(img)), vis_j)
    ct = np.random.default_rng(13).normal(size=uv.shape[0]) * (1 + 0.5j)
    _, vjp_t = torch.func.vjp(rr_t, torch.from_numpy(img))
    _close(vjp_t(torch.from_numpy(ct))[0], np.real(vjp_j(jnp.conj(jnp.asarray(ct)))[0]))
    batch = torch.from_numpy(np.stack([img, -2 * img]))
    _close(rr_t(batch)[1], -2 * np.asarray(vis_j))


def test_radio_response_planes_are_contiguous_and_sorted_by_cell():
    uv, w, pixsize = _radio_inputs(n_vis=200)
    rr = tn.RadioResponse((16, 16), uv, pixsize=pixsize, w=w, n_w_planes=5,
                          sorted_windows=True)
    assert len(rr.planes) == len(rr.plane_tables(torch.float64)) == 5
    assert sum(t.npts for t in rr.plane_tables(torch.float64)) == 200
    for tab in rr.plane_tables(torch.float64):
        cells = np.floor(tab.xs.numpy()).astype(np.int64)
        keys = cells[:, 0] * 10**6 + cells[:, 1]
        assert np.all(np.diff(keys) >= 0)


@pytest.mark.parametrize("shape,width", [((600,), 8), ((40, 300), 8), ((6, 7, 80), 4)],
                         ids=lambda p: str(p))
def test_spread_blocks_cover_every_nonzero_output(shape, width):
    """A spread block the host marks as unreached (its kernel writes zeros
    without a walk) holds no nonzero output of the plain spread, and the
    table marks no more blocks than the window reach needs."""
    rng = np.random.default_rng(14)
    coords = rng.uniform(-0.1, 0.1, size=(9, len(shape))) * np.array(shape)
    tab = nw.WindowTable(shape, coords, width=width)
    v = torch.from_numpy(rng.normal(size=(1, 9)) + 1j * rng.normal(size=(1, 9)))
    out = nw.window_spread_plain(v, tab).numpy().reshape(-1, tab.os_shape[-1])
    segs = -(-tab.os_shape[-1] // nw.SPREAD_CELLS)
    padded = np.zeros((out.shape[0], segs * nw.SPREAD_CELLS), complex)
    padded[:, :out.shape[1]] = out
    nonzero = (padded.reshape(-1, segs, nw.SPREAD_CELLS) != 0).any(-1).reshape(-1)
    active = np.zeros(nonzero.size, dtype=bool)
    active[tab.sum_blocks.numpy()] = True
    assert not np.any(nonzero & ~active)
    assert 0 < active.sum() < active.size
    np.testing.assert_array_equal(active, nonzero)
