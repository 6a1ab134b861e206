"""Parity of the port's line-of-sight response (``SamplingCartesianGridLOS``,
the ray integral K11 of ``ops/los_interp.py`` in its plain versions) with
``nifty_tpu`` from the same numpy inputs, float64.

Tolerances: the response, its jvp and vjp, the tomography likelihood's
metric and a 128^3 correlated field agree to 1e-12 of the largest entry
(the same terms summed in another order); the host tables' cells are the
JAX package's ``floor`` of the same coordinates exactly; one
``OptimizeVI.update`` with CG budgets of 5 steps and the noise replayed
agrees to 1e-8 in KL energy (CG amplifies rounding step by step).
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402
from nifty_tpu_torch.ops import los_interp as li  # noqa: E402

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

RTOL = 1e-12
SHORT = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _close_tree(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol)


def _rays(dims, n_rays, seed, broadcast=False):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.05, 0.95, size=(1 if broadcast else n_rays, len(dims)))
    end = rng.uniform(0.05, 0.95, size=(n_rays, len(dims)))
    return start, end


def _pair(dims, n_rays=16, n_points=32, order=1, broadcast=False, seed=0):
    start, end = _rays(dims, n_rays, seed, broadcast)
    kw = dict(shape=dims, distances=tuple(1.0 / d for d in dims),
              n_sampling_points=n_points, interpolation_order=order)
    return (jft.SamplingCartesianGridLOS(start, end, **kw),
            jt.SamplingCartesianGridLOS(start, end, **kw))


CASES = {
    "3d_o1": ((12, 12, 12), 1, False), "3d_o0": ((12, 12, 12), 0, False),
    "3d_o1_one_start": ((12, 12, 12), 1, True), "3d_o0_one_start": ((12, 12, 12), 0, True),
    "2d_o1": ((9, 14), 1, False), "2d_o0": ((9, 14), 0, False),
    "2d_o1_one_start": ((9, 14), 1, True),
}


@pytest.mark.parametrize("case", CASES)
def test_forward_jvp_vjp_match(case):
    dims, order, broadcast = CASES[case]
    lj, lt = _pair(dims, order=order, broadcast=broadcast)
    rng = np.random.default_rng(1)
    f, tan, ct = rng.standard_normal(dims), rng.standard_normal(dims), rng.standard_normal(16)
    y = jax.jit(lj)(jnp.asarray(f))
    li.reset_launch_counts()
    _close(lt(torch.from_numpy(f)), y)
    _, tan_j = jax.jvp(lj, (jnp.asarray(f),), (jnp.asarray(tan),))
    cot_j = jax.vjp(lj, jnp.asarray(f))[1](jnp.asarray(ct))[0]
    _, fwd, bwd = linearize(lt, torch.from_numpy(f))
    _close(fwd(torch.from_numpy(tan)), tan_j)
    _close(bwd(torch.from_numpy(ct)), cot_j)
    _, tan_f = torch.func.jvp(lt, (torch.from_numpy(f),), (torch.from_numpy(tan),))
    _close(tan_f, tan_j)
    # on the CPU the plain versions run, never the kernels
    assert li.los_integrate.launches == li.los_integrate_adjoint.launches == 0


def test_batch_axes_are_rows():
    """Fields (B, *shape) give (B, n_rays), row by row as the JAX package's
    vmap does."""
    lj, lt = _pair((8, 8, 8))
    f = np.random.default_rng(2).standard_normal((3, 8, 8, 8))
    _close(lt(torch.from_numpy(f)), jax.jit(jax.vmap(lj))(jnp.asarray(f)))


def test_ray_along_the_far_face_is_nan_in_both_packages():
    """A ray on the plane at world coordinate ``distances * n`` samples
    points whose upper corner is index ``n``, outside the grid: NaN
    (``cval=nan``), though that corner's weight is 0.  Its jvp and vjp are
    finite, as the JAX package's are."""
    dims = (8, 8, 8)
    start = np.array([[1.0, 0.2, 0.3], [0.1, 0.2, 0.3]])
    end = np.array([[1.0, 0.8, 0.6], [0.7, 0.6, 0.5]])
    kw = dict(shape=dims, distances=(0.125,) * 3, n_sampling_points=8)
    lj, lt = jft.SamplingCartesianGridLOS(start, end, **kw), jt.SamplingCartesianGridLOS(
        start, end, **kw)
    f = np.random.default_rng(3).standard_normal(dims)
    yj, yt = np.asarray(lj(jnp.asarray(f))), lt(torch.from_numpy(f)).numpy()
    assert np.isnan(yj[0]) and np.isnan(yt[0])
    _close(yt[1:], yj[1:])
    tab = lt.table(torch.float64)
    assert tab.has_nan and int(torch.isnan(tab.nan_offset).sum()) == 1
    ct = np.ones(2)
    cot_j = jax.vjp(lj, jnp.asarray(f))[1](jnp.asarray(ct))[0]
    _, fwd, bwd = linearize(lt, torch.from_numpy(f))
    _close(bwd(torch.from_numpy(ct)), cot_j)
    tan_t = fwd(torch.from_numpy(f)).numpy()
    assert np.all(np.isfinite(tan_t))
    _close(tan_t, jax.jvp(lj, (jnp.asarray(f),), (jnp.asarray(f),))[1])


@pytest.mark.parametrize("dims", [(12, 12, 12), (9, 14)], ids=["3d", "2d"])
def test_host_cells_are_floor_of_the_reference_coordinates(dims):
    """Corner 0 of every point is the cell ``floor`` of the coordinates that
    ``_ray_integral`` computes (same expressions, same order, same types)."""
    start, end = _rays(dims, 16, 4)
    distances = jnp.asarray(tuple(1.0 / d for d in dims))
    shape_arr = jnp.asarray(dims, dtype=jnp.float64)
    lpw = ((shape_arr - 1) / shape_arr) / distances
    s, e = jnp.asarray(start) * lpw, jnp.asarray(end) * lpw
    step = (e - s) / 32
    t = jnp.arange(32, dtype=jnp.float64) + 0.5
    coords = np.asarray(s[:, :, None] + step[:, :, None] * t[None, None, :])
    mine = li.los_coordinates(start, end, dims, np.asarray(distances), 32)
    np.testing.assert_array_equal(mine, coords)
    idx, _, _, nan_rays = li.los_tables(start, end, dims, np.asarray(distances), 32)
    cells = np.ravel_multi_index(tuple(np.floor(coords).astype(np.int64).transpose(1, 0, 2)),
                                 dims)
    np.testing.assert_array_equal(idx.reshape(16, 32, -1)[..., 0], cells)
    assert not nan_rays.any()


@pytest.mark.parametrize("order", [0, 1])
def test_plain_forward_and_adjoint_are_transposes(order):
    """<A f, y> = <f, A^T y> for the plain versions, at several rows."""
    dims = (10, 11, 12)
    start, end = _rays(dims, 20, 5)
    idx, w, scale, nan_rays = li.los_tables(start, end, dims, tuple(1.0 / d for d in dims), 24,
                                            order)
    tab = li.LosTable(idx, w, scale, dims, nan_rays)
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.standard_normal((3, tab.ncells)))
    y = torch.from_numpy(rng.standard_normal((3, tab.nrays)))
    lhs = (li.los_integrate_plain(f, tab) * y).sum(1)
    rhs = (f * li.los_integrate_adjoint_plain(y, tab)).sum(1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12)
    # every valid entry is in the CSR once, in (ray, entry) order within a cell
    assert tab.n_valid == int((idx >= 0).sum())
    assert tab.n_touched == np.unique(idx[idx >= 0]).size
    mask = tab.mask.numpy().view(np.uint32)
    touched = np.flatnonzero((mask[np.arange(tab.ncells) >> 5] >> (np.arange(tab.ncells) & 31))
                             & 1)
    np.testing.assert_array_equal(touched, tab.cells.numpy())


def _tomography(mod, dims, n_rays, n_points, seed=7):
    """``tests/test_tomography_3d.py``'s likelihood, the field and the
    truth's latents (numpy, from the seed)."""
    xp = jnp if mod is jft else torch
    cfm = mod.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-4.0, 5e-1), flexibility=(1e0, 5e-1),
                         asperity=(5e-1, 5e-2))
    cf = cfm.finalize()
    start, end = _rays(dims, n_rays, seed)
    los = mod.SamplingCartesianGridLOS(start, end, shape=dims,
                                       distances=tuple(1.0 / d for d in dims),
                                       n_sampling_points=n_points)
    fwd = mod.Model(lambda x: los(xp.exp(cf(x))), domain=cf.domain, init=cf.init)
    return cf, fwd


def _latents(domain, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: scale * rng.standard_normal(v.shape) for k, v in domain.items()}


def _likelihoods(dims=(16, 16, 16), n_rays=24, n_points=32):
    cf_j, fwd_j = _tomography(jft, dims, n_rays, n_points)
    _, fwd_t = _tomography(jt, dims, n_rays, n_points)
    truth = np.asarray(jax.jit(fwd_j)({k: jnp.asarray(v)
                                       for k, v in _latents(cf_j.domain, 8).items()}))
    noise_std = 0.05 * float(np.mean(np.abs(truth)))
    data = truth + noise_std * np.random.default_rng(9).standard_normal(truth.shape)
    lh_j = jft.Gaussian(jnp.asarray(data), lambda x: x / noise_std ** 2).amend(fwd_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), lambda x: x / noise_std ** 2).amend(fwd_t)
    return lh_j, lh_t


def test_tomography_metric_matvec_matches():
    lh_j, lh_t = _likelihoods()
    lat, tan = _latents(lh_j.domain, 10, 0.3), _latents(lh_j.domain, 11)
    p_j = {k: jnp.asarray(v) for k, v in lat.items()}
    p_t = jt.from_numpy(lat)
    _close(lh_t(p_t), jax.jit(lh_j)(p_j))
    want = jax.jit(lh_j.metric)(p_j, {k: jnp.asarray(v) for k, v in tan.items()})
    _close_tree(lh_t.metric(p_t, jt.from_numpy(tan)), want)


def _jax_struct(tree):
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float64)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        out = jft.random_like(self.key, _jax_struct(primals))
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device)


@pytest.mark.parametrize("rmap", ["smap", "vmap"])
def test_one_update_matches(rmap):
    lh_j, lh_t = _likelihoods()
    pos = _latents(lh_j.domain, 12, 0.3)
    opt_j = jft.OptimizeVI(lh_j, 10, residual_map=rmap)
    smp_j = jft.Samples(pos={k: jnp.asarray(v) for k, v in pos.items()}, samples=None,
                        keys=None)
    smp_j, st_j = opt_j.update(smp_j, opt_j.init_state(jax.random.PRNGKey(7), **SHORT))
    opt_t = jt.OptimizeVI(lh_t, 10, residual_map=rmap)
    smp_t = jt.Samples(pos=jt.from_numpy(pos), samples=None, keys=None)
    smp_t, st_t = opt_t.update(smp_t, opt_t.init_state(JaxKey(jax.random.PRNGKey(7)), **SHORT))
    assert st_t.minimization_state.nit == int(st_j.minimization_state.nit)
    np.testing.assert_allclose(st_t.minimization_state.fun, float(st_j.minimization_state.fun),
                               rtol=1e-8)
    _close_tree(smp_t.pos, smp_j.pos, 1e-6)


def test_128cubed_binned_field_quarter_route():
    """A 3-D correlated field at 128^3 with ``n_bins``: the port distributes
    on the folded 65^3 quarter map (2^21 modes, above its rule's 2^20);
    forward and vjp against the JAX package."""
    dims = (128, 128, 128)
    makers = []
    for mod in (jft, jt):
        cfm = mod.CorrelatedFieldMaker("cf")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
                             loglogavgslope=(-4.0, 5e-1), flexibility=(1e0, 5e-1),
                             asperity=(5e-1, 5e-2), n_bins=32)
        makers.append(cfm.finalize())
    cf_j, cf_t = makers
    assert cf_t.use_quarter and cf_t.dist.shape == (65, 65, 65)
    lat = _latents(cf_j.domain, 13)
    ct = np.random.default_rng(14).standard_normal(dims)
    p_j = {k: jnp.asarray(v) for k, v in lat.items()}
    y_j, pull = jax.vjp(cf_j, p_j)
    cot_j = pull(jnp.asarray(ct))[0]
    y_t, _, bwd = linearize(cf_t, jt.from_numpy(lat))
    _close(y_t, y_j)
    _close_tree(bwd(torch.from_numpy(ct)), cot_j)
