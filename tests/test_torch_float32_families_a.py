"""The float32 policy for radio imaging and ICR: the port with
``enable_x64`` off against the JAX package with ``jax_enable_x64`` off.

- Radio: the exp of a 32^2 correlated field (16 log bins) through a
  w-stacked ``RadioResponse`` (2 w-planes of ``test_torch_radio.py``'s
  coverage, 600 visibilities).  The port evaluates the phase screens in
  float64 on the host and rounds them once; the JAX package evaluates them
  in complex64.  Both hold ``FIELD_RTOL`` / ``METRIC_RTOL``.  A float32
  response with w-planes used to raise (its float32 image met complex128
  screens); that is the regression test here, with its float64 twin bit
  for bit the formula it had.
- ICR: a deformed 8 x 7 chart of depth 2 (``RefinementField``), and
  ``RefinementHPField`` on the sphere (nside 1, depth 2) and on sphere x
  radius.  Both packages build the refinement matrices in float64 and
  round them once.

Each family: forward, jvp and vjp, a Gaussian's energy, metric matvec and
a 5-step CG solve on ``M + 1`` (``torch_float32_families.py``), and a
dispatch mode over one float32 ``OptimizeVI.update``: no float64 or
complex128 tensor outside ``ALLOW``; at float64 no float32 or complex64
tensor at all.
"""

import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import refine as jr  # noqa: E402
from nifty_tpu.ops.nufft import RadioResponse as JRadio  # noqa: E402
from nifty_tpu_torch import config  # noqa: E402
from nifty_tpu_torch import refine as tr  # noqa: E402
from nifty_tpu_torch.ops import nufft_window as nw  # noqa: E402
from nifty_tpu_torch.ops.nufft import RadioResponse as TRadio  # noqa: E402
from nifty_tpu_torch.ops.nufft import nufft2  # noqa: E402
from test_torch_float32 import build  # noqa: E402
from test_torch_radio import _coverage  # noqa: E402
from torch_float32_families import (  # noqa: E402
    FIELD_RTOL,
    _close,
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

#: the functions that may make a float64 or complex128 tensor in a float32
#: update of these families, and why
_K7 = ("a plain version of K7 (the CPU's route): a float32 window's terms widened to "
       "complex128, summed and rounded once, as nufft_interp_f32 / nufft_spread_f32 "
       "sum in double")
ALLOW = {f"nifty_tpu_torch.ops.nufft_window.{fn}": _K7
         for fn in ("_wide", "window_interp_plain", "window_spread_plain")}


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


# -- radio ---------------------------------------------------------------------------


def radio_pair(mod, radio):
    cf = build(mod, (32, 32), 16)
    uv, w, pixsize = _coverage()
    rr = radio((32, 32), uv, pixsize=pixsize, w=w, n_w_planes=2)
    xp = jnp if mod is jft else torch
    return mod.Model(lambda x: rr(xp.exp(cf(x))), domain=cf.domain, init=cf.init), rr


def test_float32_radio_response_with_w_planes_returns_complex64_and_matches_jax(f32):
    """The fault: a float32 image met the complex128 phase screens, and the
    window table raised ``TypeError``.  Now the screens follow the image."""
    uv, w, pixsize = _coverage()
    kw = dict(pixsize=pixsize, w=w, n_w_planes=2)
    rr_j, rr_t = JRadio((32, 32), uv, **kw), TRadio((32, 32), uv, **kw)
    assert len(rr_t.planes) == 2
    img = np.exp(0.3 * np.random.default_rng(3).standard_normal((32, 32))).astype(np.float32)
    got = rr_t(torch.from_numpy(img))
    assert got.dtype == torch.complex64 and rr_t.screens_complex64.dtype == torch.complex64
    _close(got, jax.jit(rr_j)(jnp.asarray(img)), FIELD_RTOL)


def test_float64_radio_response_keeps_its_bits():
    """The float64 response is bit for bit the formula it had: the image
    times the complex128 screens, each plane's NUFFT, unsorted."""
    uv, w, pixsize = _coverage()
    rr = TRadio((32, 32), uv, pixsize=pixsize, w=w, n_w_planes=2)
    img = torch.from_numpy(np.exp(0.3 * np.random.default_rng(4).standard_normal((2, 32, 32))))
    tables = rr.plane_tables(torch.float64)
    want = torch.cat([nufft2(img * rr.screens[i], table=tab)
                      for i, tab in zip(rr.planes, tables)], dim=-1).index_select(-1, rr.unsort)
    got = rr(img)
    assert got.dtype == torch.complex128 and rr.screens.dtype == torch.complex128
    assert torch.equal(got, want)
    assert rr.screens_complex64 is None


def test_radio_matches_jax_in_float32(f32):
    fj, _ = radio_pair(jft, JRadio)
    ft, _ = radio_pair(jt, TRadio)
    hold_model(fj, ft, seed=0, scale=0.3)
    hold_likelihood(*gaussians(fj, ft, seed=5), seed=10, scale=0.3)


# -- ICR -----------------------------------------------------------------------------


def _warp(reg):
    return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)


def _matern(xp, scale=1.0):
    return lambda r: (1.0 + r / scale) * xp.exp(-r / scale)


def icr_field(mod, case):
    """``mod``'s ICR field of ``case``."""
    xp = jnp if mod is jr else torch
    if case == "chart":
        chart = mod.CoordinateChart(shape0=(8, 7), depth=2, distances0=(0.4, 0.4),
                                    nonlinear_map=_warp)
        return mod.RefinementField(chart, _matern(xp))
    radial = case == "sphere_radius"
    rc = (mod.CoordinateChart(5, depth=2, distances0=0.2, nonlinear_map=lambda x: 1.0 + x)
          if radial else None)
    return mod.RefinementHPField(mod.HEALPixChart(1, 2, radial_chart=rc), _matern(xp, 0.5))


ICR = ["chart", "sphere", "sphere_radius"]


@pytest.mark.parametrize("case", ICR)
def test_icr_matches_jax_in_float32(f32, case):
    fj, ft = icr_field(jr, case), icr_field(tr, case)
    for level in ft.levels:
        assert level.olf.dtype == level.ker.dtype == torch.float32
    hold_model(fj, ft, seed=0)
    hold_likelihood(*gaussians(fj, ft, seed=5), seed=10)


# -- one update in each precision ---------------------------------------------------


def _radio_lh():
    ft, _ = radio_pair(jt, TRadio)
    data = ft(jt.random_like(3, ft.domain)).detach()
    sigma = 0.1 * float(data.abs().pow(2).mean().sqrt())
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / sigma ** 2).amend(ft)


def _icr_lh(case):
    ft = icr_field(tr, case)
    data = ft(jt.random_like(3, ft.domain)).detach()
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / 0.01).amend(ft)


LIKELIHOODS = {"radio": _radio_lh, **{f"icr_{c}": (lambda c=c: _icr_lh(c)) for c in ICR}}


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("family", LIKELIHOODS)
def test_update_makes_no_tensor_of_the_other_precision(family, x64):
    """One lockstep ``OptimizeVI.update``, its likelihood built outside the
    recorder: under float32 no float64 or complex128 tensor outside
    ``ALLOW``, under float64 no float32 or complex64 tensor."""
    config.update("enable_x64", x64)
    try:
        lh = LIKELIHOODS[family]()
    finally:
        config.update("enable_x64", True)
    out = {}
    record(lambda: out.update(zip(("samples", "state"), one_update(lh))), x64,
           ALLOW if not x64 else None)
    own = torch.float64 if x64 else torch.float32
    assert {x.dtype for x in jt.tree.tree_leaves(out["samples"].pos)} == {own}
    assert np.isfinite(float(out["state"].minimization_state.fun))


def test_radio_window_tables_follow_the_computation(f32):
    """A float32 radio model builds only float32 window tables."""
    _, rr = radio_pair(jt, TRadio)
    assert list(rr.tables) == ["float32"]
    assert all(isinstance(t, nw.WindowTable) for t in rr.tables["float32"])
