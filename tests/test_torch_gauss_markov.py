"""Parity of the port's Gauss-Markov processes with ``nifty_tpu``: the
Wiener, integrated Wiener and Ornstein-Uhlenbeck functions and the
``GaussMarkovProcess`` models with their wrappers, unbatched and with a
leading batch axis (against the JAX function vmapped over it).

Tolerance 1e-12 relative to the largest entry: a few pointwise operations
and prefix sums over at most 40 steps, summed in another order by the two
libraries.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.models import gauss_markov as jgm  # noqa: E402
from nifty_tpu_torch.models import gauss_markov as tgm  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12
N = 40
S = 3


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.max(np.abs(want)))


def _args(process, rng, lead):
    """Excitations and per-sample parameters (leading axes ``lead``)."""
    xi_shape = lead + ((N, 2) if process == "iwp" else (N,))
    x0 = rng.standard_normal(lead + ((2,) if process == "iwp" else ()))
    kw = dict(sigma=rng.uniform(0.5, 2.0, lead))
    if process == "iwp":
        kw["asperity"] = rng.uniform(0.1, 1.0, lead)
    if process == "ou":
        kw["gamma"] = rng.uniform(0.1, 3.0, lead)
    return rng.standard_normal(xi_shape), x0, kw


FUNCTIONS = {"wiener": "wiener_process", "iwp": "integrated_wiener_process",
             "ou": "ornstein_uhlenbeck_process"}


@pytest.mark.parametrize("process", FUNCTIONS)
@pytest.mark.parametrize("scalar_dt", [False, True], ids=["dt_array", "dt_scalar"])
@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
def test_process_functions_match(process, scalar_dt, batched):
    rng = np.random.default_rng(len(process))
    xi, x0, kw = _args(process, rng, (S,) if batched else ())
    dt = 0.3 if scalar_dt else rng.uniform(0.05, 0.5, N)
    fn_j, fn_t = getattr(jgm, FUNCTIONS[process]), getattr(tgm, FUNCTIONS[process])

    def jax_fn(xi, x0, **kw):
        return fn_j(xi, x0, dt=jnp.asarray(dt), **kw)

    jax_fn = jax.vmap(jax_fn) if batched else jax_fn
    want = jax_fn(jnp.asarray(xi), jnp.asarray(x0), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = fn_t(torch.from_numpy(xi), torch.from_numpy(x0),
               dt=dt if scalar_dt else torch.from_numpy(dt),
               **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    _close(got, want)


DT = np.random.default_rng(7).uniform(0.05, 0.5, N)
# name -> (builder, its arguments): the wrappers with priors for tuples,
# constants, and the generic model with a process function and constants
MODELS = {
    "wiener_priors": ("WienerProcess", ((0.0, 1.0), (1.0, 0.5), DT), dict(name="w")),
    "wiener_constants": ("WienerProcess", (0.3, 0.7, 0.2), dict(name="w", N_steps=N)),
    "iwp_priors": ("IntegratedWienerProcess", ((0.0, 1.0), (1.0, 0.5), DT),
                   dict(name="i", asperity=(0.5, 0.1))),
    "iwp_constant_start": ("IntegratedWienerProcess", (np.array([0.1, -0.2]), (1.0, 0.5), DT),
                           dict(name="i")),
    "ou_steady_state": ("OrnsteinUhlenbeckProcess", ((1.0, 0.5), (0.5, 0.2), DT), dict(name="o")),
    "ou_steady_state_constants": ("OrnsteinUhlenbeckProcess", (0.8, 1.5, DT), dict(name="o")),
    "ou_prior_start": ("OrnsteinUhlenbeckProcess", ((1.0, 0.5), (0.5, 0.2), DT),
                       dict(name="o", x0=(0.0, 2.0))),
}


def _build(mod, case):
    builder, args, kw = MODELS[case]
    args = tuple(jnp.asarray(a) if mod is jgm and isinstance(a, np.ndarray) else a for a in args)
    return getattr(mod, builder)(*args, **kw)


@pytest.mark.parametrize("case", MODELS)
def test_wrappers_match(case):
    m_j, m_t = _build(jgm, case), _build(tgm, case)
    assert isinstance(m_t, tgm.GaussMarkovProcess)
    assert list(m_t.domain) == list(m_j.domain)
    for k, v in m_j.domain.items():
        assert m_t.domain[k].shape == tuple(v.shape)
    assert sorted(m_t.init(0)) == sorted(m_j.domain)
    rng = np.random.default_rng(len(case))
    lat = {k: rng.standard_normal(tuple(v.shape)) for k, v in m_j.domain.items()}
    _close(m_t(jt.from_numpy(lat)), m_j({k: jnp.asarray(v) for k, v in lat.items()}))
    stacked = {k: rng.standard_normal((S,) + tuple(v.shape)) for k, v in m_j.domain.items()}
    _close(m_t(jt.from_numpy(stacked)),
           jax.vmap(m_j)({k: jnp.asarray(v) for k, v in stacked.items()}))


def test_generic_process_with_a_function_and_constants():
    def drifted_wiener(xi, x0, sigma, dt, drift):
        return tgm.wiener_process(xi, x0, sigma, dt) + drift

    m = tgm.GaussMarkovProcess(drifted_wiener, 0.5, DT, name="g", sigma=0.7, drift=np.float64(2.0))
    assert list(m.domain) == ["g"] and {n for n, _ in m.named_buffers()} == {
        "dt", "x0.value", "params.sigma.value", "params.drift.value"}
    xi = np.random.default_rng(8).standard_normal((S, N))
    want = jgm.wiener_process(jnp.asarray(xi[1]), 0.5, 0.7, jnp.asarray(DT)) + 2.0
    _close(m(jt.from_numpy({"g": xi}))[1], want)
    with pytest.raises(ValueError, match="N_steps"):
        tgm.GaussMarkovProcess(tgm.wiener_process, 0.0, 0.1, sigma=1.0)


def test_ornstein_uhlenbeck_overflow_is_the_references():
    """The parallel form divides by exp(-gamma * cumsum(dt)), which
    overflows once gamma * sum(dt) passes about 709: neither package's
    result is finite there, and they agree where it is."""
    xi = np.random.default_rng(9).standard_normal(N)
    dt = DT * (10.0 / DT.sum())
    for gamma, finite in ((30.0, True), (100.0, False)):
        want = jgm.ornstein_uhlenbeck_process(jnp.asarray(xi), 0.1, 1.0, gamma, jnp.asarray(dt))
        got = tgm.ornstein_uhlenbeck_process(torch.from_numpy(xi), 0.1, 1.0, gamma,
                                             torch.from_numpy(dt))
        assert bool(torch.isfinite(got).all()) == bool(jnp.isfinite(want).all()) == finite
        if finite:
            _close(got, want)
