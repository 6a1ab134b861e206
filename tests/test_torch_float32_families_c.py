"""The float32 policy for spherical fields and HMC / NUTS: the port with
``enable_x64`` off against the JAX package with ``jax_enable_x64`` off.

- The sphere: ``test_torch_spherical_cf.py``'s correlated fields on a
  Gauss-Legendre grid (lmax 16) and on HEALPix (lmax 15, nside 8; K10's
  plain versions on the CPU).  Forward, jvp and vjp, a Gaussian's energy,
  metric matvec and a 5-step CG solve on ``M + 1``
  (``torch_float32_families.py``).
- HMC / NUTS on the 16^3 tomography (``test_torch_los.py``'s model): the
  potential ``lh(x) + |x|^2 / 2`` and its gradient within ``FIELD_RTOL``;
  ten leapfrog steps of step 0.02 (positions, momenta, kinetic and total
  energy) within ``FIELD_RTOL`` of the largest |value| after each step.
  The sampler has no metric and no CG solve.

A dispatch mode runs one float32 ``OptimizeVI.update`` of each spherical
field and a float32 NUTS chain of four transitions: no float64 or
complex128 tensor outside ``ALLOW``, none of float32 at float64.
"""

import logging
from functools import partial

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu.hmc as jhmc  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.hmc as thmc  # noqa: E402
from nifty_tpu_torch import config  # noqa: E402
from test_torch_hmc import _torch_grad  # noqa: E402
from test_torch_los import _tomography  # noqa: E402
from test_torch_spherical_cf import build  # noqa: E402
from torch_float32_families import (  # noqa: E402
    FIELD_RTOL,
    _close,
    draw,
    f32,  # noqa: F401
    gaussians,
    hold_likelihood,
    hold_model,
    one_update,
    record,
    to_jax,
)

torch.set_num_threads(1)
jft.logger.setLevel(logging.WARNING)
jt.logger.setLevel(logging.WARNING)

#: the functions that may make a float64 or complex128 tensor in a float32
#: run of these families, and why
ALLOW = {
    "nifty_tpu_torch.ops.hp_longitude._phase_chunk": (
        "a plain version of K10 (the CPU's route): the phases m phi made in float64 and "
        "rounded, as hp_longitude_f32 computes its phases and sums in double"),
    "nifty_tpu_torch.hmc._uniform": (
        "the sampler's uniform, one scalar a leaf or a merge, drawn in float64 from the "
        "chain's host generator and compared on the host in double: the float32 and float64 "
        "chains of a seed see the same uniforms"),
}

SPHERES = {"gl_lmax16": (16, "spherical"), "hp_lmax15_nside8": (15, "healpix")}


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


@pytest.mark.parametrize("name", SPHERES)
def test_sphere_matches_jax_in_float32(f32, name):
    lmax, kind = SPHERES[name]
    fj, ft = build(jft, lmax, kind), build(jt, lmax, kind)
    hold_model(fj, ft, seed=0)
    hold_likelihood(*gaussians(fj, ft, seed=5), seed=10)


def _hamiltonians(lh_j, lh_t):
    return (lambda x: lh_j(x) + 0.5 * jft.vdot(x, x),
            lambda x: lh_t(x) + 0.5 * jt.vdot(x, x))


def test_hmc_potential_and_leapfrog_match_jax_in_float32(f32):
    fj, ft = _tomography(jft, (16, 16, 16), 24, 32)[1], _tomography(jt, (16, 16, 16), 24, 32)[1]
    lh_j, lh_t = gaussians(fj, ft, seed=5)
    pe_j, pe_t = _hamiltonians(lh_j, lh_t)
    pos, mom = draw(lh_j.domain, 20, 0.3), draw(lh_j.domain, 21)
    _close(pe_t(jt.from_numpy(pos)), jax.jit(pe_j)(to_jax(pos)), FIELD_RTOL)
    grad_j = jax.jit(jax.grad(pe_j))
    _close(_torch_grad(pe_t)(jt.from_numpy(pos)), grad_j(to_jax(pos)), FIELD_RTOL)
    inv_j = jax.tree_util.tree_map(lambda x: jnp.ones(x.shape, jnp.float32), lh_j.domain)
    inv_t = jt.tree.tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32), lh_t.domain)
    qp_j = jhmc.QP(position=to_jax(pos), momentum=to_jax(mom))
    qp_t = thmc.QP(position=jt.from_numpy(pos), momentum=jt.from_numpy(mom))
    ke_j, ke_t = partial(jhmc._kinetic_energy, inv_j), partial(thmc._kinetic_energy, inv_t)
    step_j = jax.jit(lambda qp: jhmc.leapfrog_step(grad_j, jhmc._kinetic_energy_gradient, 0.02,
                                                   inv_j, qp))
    for _ in range(10):
        qp_j = step_j(qp_j)
        qp_t = thmc.leapfrog_step(_torch_grad(pe_t), thmc._kinetic_energy_gradient, 0.02, inv_t,
                                  qp_t)
        _close(qp_t.position, qp_j.position, FIELD_RTOL)
        _close(qp_t.momentum, qp_j.momentum, FIELD_RTOL)
        _close(ke_t(qp_t.momentum), ke_j(qp_j.momentum), FIELD_RTOL)
        _close(thmc.total_energy_of_qp(qp_t, pe_t, ke_t),
               jhmc.total_energy_of_qp(qp_j, pe_j, ke_j), FIELD_RTOL)
    assert bool(thmc.is_euclidean_uturn(thmc.QP(qp_t.position, qp_t.momentum), qp_t)) is False


# -- one float32 run of each family -------------------------------------------------


def _sphere_lh(name):
    lmax, kind = SPHERES[name]
    ft = build(jt, lmax, kind)
    data = ft(jt.random_like(3, ft.domain)).detach()
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / 0.01).amend(ft)


def _nuts_run():
    ft = _tomography(jt, (16, 16, 16), 24, 32)[1]
    data = ft(jt.tree.tree_map(lambda x: 0.3 * x, jt.random_like(3, ft.domain))).detach()
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / (0.05 * float(data.abs().mean())) ** 2
                     ).amend(ft)
    pos = jt.tree.tree_map(lambda x: 0.3 * x, jt.random_like(4, lh.domain))
    chain = jt.NUTSChain(potential_energy=lambda x: lh(x) + 0.5 * jt.vdot(x, x),
                         inverse_mass_matrix=1.0, position_proto=pos, step_size=0.02,
                         max_tree_depth=3)
    return lambda: chain.generate_n_samples(42, pos, 4)


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("family", [*SPHERES, "nuts"])
def test_run_makes_no_tensor_of_the_other_precision(family, x64):
    """One lockstep ``OptimizeVI.update`` (a spherical field) or a NUTS
    chain of four transitions (depth at most 3) on the 16^3 tomography,
    built outside the recorder: no tensor of the other precision outside
    ``ALLOW`` (at float64: none at all)."""
    config.update("enable_x64", x64)
    try:
        run = _nuts_run() if family == "nuts" else None
        lh = None if family == "nuts" else _sphere_lh(family)
    finally:
        config.update("enable_x64", True)
    out = {}
    if family == "nuts":
        record(lambda: out.update(chain=run()[0]), x64, ALLOW if not x64 else None)
        own = torch.float64 if x64 else torch.float32
        assert {x.dtype for x in jt.tree.tree_leaves(out["chain"].samples)} == {own}
        assert out["chain"].acceptance.dtype == own
        return
    record(lambda: out.update(zip(("samples", "state"), one_update(lh))), x64,
           ALLOW if not x64 else None)
    assert np.isfinite(float(out["state"].minimization_state.fun))
