"""The float32 policy for the line of sight and structured kernel
interpolation: the port with ``enable_x64`` off against the JAX package
with ``jax_enable_x64`` off, and the float32 line of sight on a
field-sharded mesh.

- Line of sight: ``test_torch_los.py``'s 16^3 tomography (the exp of a
  correlated field through 24 rays of 32 points; K11's plain versions on
  the float32 ray table).
- SKI: ``StructuredKernelInterpolation`` on ``test_torch_ski.py``'s 2-D
  grid, and ``HarmonicSKI``'s jitter from float32 points, which must be
  the JAX package's 1e-6.
- The mesh: the 16^3 tomography's geoVI update in float32 under
  ``deterministic_reductions`` on a 2 x 2 gloo world (the field over 2
  ranks, K11 on each rank's float32 slab) gives the bits of the 1 x 1
  world (``tests/torch_mesh_worker.py``'s ``tomography_update_case``).

Each family: forward, jvp and vjp, a Gaussian's energy, metric matvec and
a 5-step CG solve on ``M + 1`` at ``FIELD_RTOL`` / ``METRIC_RTOL``
(``torch_float32_families.py``), and a dispatch mode over one float32
``OptimizeVI.update``: no float64 or complex128 tensor; at float64 no
float32 or complex64 tensor.
"""

import logging

import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from nifty_tpu_torch import config  # noqa: E402
from nifty_tpu_torch.parallel import run_world  # noqa: E402
from test_torch_los import _rays, _tomography  # noqa: E402
from test_torch_ski import _points  # noqa: E402
from torch_float32_families import (  # noqa: E402
    f32,  # noqa: F401
    gaussians,
    hold_likelihood,
    hold_model,
    one_update,
    record,
)

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

DIMS = (16, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def los_model(mod):
    return _tomography(mod, DIMS, 24, 32)[1]


def ski_model(mod):
    shape, bounds, pts = _points("2d", 9)
    return mod.StructuredKernelInterpolation(shape, bounds, pts.astype(np.float32),
                                             lambda k: 1.0 / (1.0 + (k / 3.0) ** 2),
                                             padding=0.5)


MODELS = {"los": los_model, "ski": ski_model}


@pytest.mark.parametrize("family", MODELS)
def test_family_matches_jax_in_float32(f32, family):
    fj, ft = MODELS[family](jft), MODELS[family](jt)
    hold_model(fj, ft, seed=0, scale=0.5)
    hold_likelihood(*gaussians(fj, ft, seed=5), seed=10, scale=0.5)


def test_los_tables_are_float32(f32):
    start, end = _rays(DIMS, 4, 2)
    los = jt.SamplingCartesianGridLOS(start, end, shape=DIMS, distances=(1 / 16,) * 3,
                                      n_sampling_points=8)
    assert list(los.tables) == ["float32"]
    assert los.table(torch.float32).w.dtype == torch.float32


def test_harmonic_ski_jitter_from_float32_points_is_the_jax_packages(f32):
    shape, bounds, pts = _points("2d", 5)
    pts = pts.astype(np.float32)
    kw = dict(padding=0.5, jitter=True)
    sj = jft.HarmonicSKI(shape, bounds, pts, harmonic_kernel=lambda k: jnp.exp(-k ** 2), **kw)
    st = jt.HarmonicSKI(shape, bounds, pts, harmonic_kernel=lambda k: torch.exp(-k ** 2), **kw)
    assert st.jitter == sj.jitter == 1e-6


def _lh(family):
    ft = MODELS[family](jt)
    data = ft(jt.tree.tree_map(lambda x: 0.5 * x, jt.random_like(3, ft.domain))).detach()
    sigma = 0.1 * float(data.pow(2).mean().sqrt())
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / sigma ** 2).amend(ft)


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("family", MODELS)
def test_update_makes_no_tensor_of_the_other_precision(family, x64):
    """One lockstep ``OptimizeVI.update``, its likelihood built outside the
    recorder: no tensor of the other precision."""
    config.update("enable_x64", x64)
    try:
        lh = _lh(family)
    finally:
        config.update("enable_x64", True)
    out = {}
    record(lambda: out.update(zip(("samples", "state"), one_update(lh))), x64)
    own = torch.float64 if x64 else torch.float32
    assert {x.dtype for x in jt.tree.tree_leaves(out["samples"].pos)} == {own}
    assert np.isfinite(float(out["state"].minimization_state.fun))


# -- the mesh ------------------------------------------------------------------------


def test_float32_tomography_update_on_2x2_is_bitwise_1x1():
    """A float32 geoVI update under ``deterministic_reductions`` on a 2 x 2
    gloo world: every rank ends with the 1 x 1 world's bits (samples,
    position, KL energy), its slab 8 of the 16 rows, its samples float32."""
    cf, fwd = _tomography(jt, DIMS, 48, 64)
    rng = np.random.default_rng(30)
    truth = {k: rng.standard_normal(tuple(v.shape)) for k, v in cf.domain.items()}
    pos = {k: 0.3 * rng.standard_normal(tuple(v.shape)) for k, v in cf.domain.items()}
    with torch.no_grad():
        signal = fwd(jt.from_numpy(truth)).numpy()
    noise_std = 0.05 * float(np.abs(signal).mean())
    data = signal + noise_std * rng.standard_normal(signal.shape)
    case = dict(data=data, noise_std=noise_std, pos=pos, key=7, sample_mode="nonlinear_resample",
                nl_maxiter=2, budgets=(20, 10, 3, 10), det=True, n_samples=4, x64=False)
    four = run_world(W.run_cases, 4, args=([("det 2x2", "tomography_update_case",
                                             dict(case, samples=2, field=2))],),
                     timeout=600, threads=1)
    one = W.run_cases([("det 1x1", "tomography_update_case", dict(case, samples=1, field=1))])
    want = one["det 1x1"]
    assert np.isfinite(want["fun"]) and want["samples"]["cfxi"].dtype == np.float32
    for rank in four:
        got = rank["det 2x2"]
        assert got["slab"] == (8, 16, 16)
        assert got["fun"] == want["fun"] and got["nit"] == want["nit"]
        for k in want["samples"]:
            assert np.array_equal(got["samples"][k], want["samples"][k])
            assert np.array_equal(got["pos"][k], want["pos"][k])
