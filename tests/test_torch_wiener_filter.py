"""The port's Wiener filter (``wiener_filter.py``) against
``nifty_tpu.wiener_filter`` on the same inputs, float64 on the CPU.

A 32^2 masked problem with ``demos/5_wiener_filter.py``'s prior: the
posterior means agree to 1e-8 relative (norm of the difference over the
reference's), with and without the ``S`` preconditioner, and so do
posterior samples drawn from the reference's noise (a provider that
splits the key with ``jax.random.split`` and draws with
``nifty_tpu.tree.random_like``).  On a 6-dof problem the sample covariance
of 1000 port samples matches the dense posterior covariance within
Monte-Carlo error.
"""

import importlib

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu.ops.harmonic import hartley as jhartley  # noqa: E402
from nifty_tpu_torch.ops.harmonic import fourier_mode_lengths  # noqa: E402
from nifty_tpu_torch.ops.harmonic import hartley as thartley  # noqa: E402

# the packages export a function of the module's name
jw = importlib.import_module("nifty_tpu.wiener_filter")
tw = importlib.import_module("nifty_tpu_torch.wiener_filter")

torch.set_num_threads(1)

DIMS = (32, 32)
NOISE_STD = 0.1


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


class JaxKey:
    """Noise provider replaying ``nifty_tpu``'s PRNG."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        out = jtree.random_like(self.key, jax.ShapeDtypeStruct(tuple(primals.shape), jnp.float64))
        return torch.from_numpy(np.array(out))


def _operators(xp, hartley, mask, amp):
    npix = float(np.prod(DIMS))
    amp = xp.asarray(amp)
    mask = xp.asarray(mask)
    ops = dict(
        R=lambda s: s * mask,
        N_inv=lambda d: d / NOISE_STD ** 2,
        N_inv_sqrt=lambda xi: xi / NOISE_STD,
        S_sqrt=lambda xi: hartley(amp * xi) / np.sqrt(npix),
        S_inv=lambda s: hartley(hartley(s) / np.sqrt(npix) / amp ** 2) / np.sqrt(npix),
        S_inv_sqrt=lambda xi: hartley(xi / amp) / np.sqrt(npix),
        S_apply=lambda x: hartley(hartley(x) / np.sqrt(npix) * amp ** 2) / np.sqrt(npix),
    )
    return ops


@pytest.fixture(scope="module")
def problem():
    """demos/5_wiener_filter.py's prior at 32^2, a 70 % mask, data from a
    prior draw plus noise (numpy, seed 4)."""
    rng = np.random.default_rng(4)
    k = fourier_mode_lengths(DIMS, 1.0 / DIMS[0])
    amp = np.where(k == 0.0, 1.0, (1.0 + (k / 4.0) ** 2) ** (-1.5))
    amp = np.maximum(amp, 1e-3 * amp.max())
    amp = amp / np.sqrt(np.sum(amp ** 2)) * np.prod(DIMS)
    mask = (rng.uniform(size=DIMS) > 0.3).astype(np.float64)
    jops = _operators(jnp, jhartley, mask, amp)
    truth = np.asarray(jops["S_sqrt"](jnp.asarray(rng.standard_normal(DIMS))))
    data = (truth + NOISE_STD * rng.standard_normal(DIMS)) * mask
    return jops, _operators(torch, thartley, mask, amp), data


# The plain solve stops on the demo's resnorm (84 steps); the solve
# preconditioned by S runs 20: on this curvature it amplifies rounding by
# orders of magnitude every ten steps past that (measured between the two
# packages: 7e-12 after 20 steps, 1e-5 after 40).
@pytest.mark.parametrize("cg", [
    dict(resnorm=1e-4, maxiter=500), dict(resnorm=1e-4, maxiter=20, precondition=True)],
    ids=["plain", "preconditioned"])
def test_wiener_filter_mean(problem, cg):
    jops, tops, data = problem
    cg = dict(cg)
    pre = cg.pop("precondition", False)
    m_j, info_j = jw.wiener_filter(
        jnp.asarray(data), jops["R"], jops["N_inv"], jops["S_inv"], domain_proto=jnp.zeros(DIMS),
        cg_kwargs=dict(cg, preconditioner=jops["S_apply"]) if pre else cg)
    m_t, info_t = tw.wiener_filter(
        torch.from_numpy(data), tops["R"], tops["N_inv"], tops["S_inv"],
        domain_proto=torch.zeros(DIMS, dtype=torch.float64),
        cg_kwargs=dict(cg, preconditioner=tops["S_apply"]) if pre else cg)
    assert info_t == (20 if pre else 0) and int(info_j) in ((20,) if pre else (0, -1))
    assert _rel(m_t, m_j) < 1e-8


def test_wiener_filter_with_an_explicit_adjoint(problem):
    """``R_adj`` given: the same mean as the autograd transpose."""
    _, tops, data = problem
    d = torch.from_numpy(data)
    proto = torch.zeros(DIMS, dtype=torch.float64)
    m_auto, _ = tw.wiener_filter(d, tops["R"], tops["N_inv"], tops["S_inv"], domain_proto=proto)
    m_adj, _ = tw.wiener_filter(d, tops["R"], tops["N_inv"], tops["S_inv"], domain_proto=proto,
                                R_adj=tops["R"])
    assert _rel(m_adj, m_auto) < 1e-12


@pytest.mark.parametrize("closed_form", [False, True])
def test_draw_posterior_sample(problem, closed_form):
    """30 CG steps for both the mean and the sample (see above)."""
    jops, tops, data = problem
    cg = dict(resnorm=1e-4, maxiter=30)
    key = jax.random.PRNGKey(8)
    m_j, _ = jw.wiener_filter(jnp.asarray(data), jops["R"], jops["N_inv"], jops["S_inv"],
                              domain_proto=jnp.zeros(DIMS), cg_kwargs=cg)
    s_j, info_j = jw.draw_posterior_sample(
        key, jops["R"], jops["N_inv"], jops["S_inv"], jops["S_sqrt"], jops["N_inv_sqrt"],
        domain_proto=jnp.zeros(DIMS), data_proto=jnp.zeros(DIMS), mean=m_j,
        S_inv_sqrt=jops["S_inv_sqrt"] if closed_form else None, cg_kwargs=cg)
    proto = torch.zeros(DIMS, dtype=torch.float64)
    m_t, _ = tw.wiener_filter(torch.from_numpy(data), tops["R"], tops["N_inv"], tops["S_inv"],
                              domain_proto=proto, cg_kwargs=cg)
    s_t, info_t = tw.draw_posterior_sample(
        JaxKey(key), tops["R"], tops["N_inv"], tops["S_inv"], tops["S_sqrt"],
        tops["N_inv_sqrt"], domain_proto=proto, data_proto=proto, mean=m_t,
        S_inv_sqrt=tops["S_inv_sqrt"] if closed_form else None, cg_kwargs=cg)
    assert info_t == int(info_j) == 30
    assert _rel(s_t - m_t, np.asarray(s_j) - np.asarray(m_j)) < 1e-8


def test_posterior_sample_covariance():
    """6 dof, 4 data: the covariance of 1000 samples (int seeds) against
    (R^T N^-1 R + S^-1)^-1, Frobenius norm within 0.15 relative (the
    Monte-Carlo error is about 0.05)."""
    rng = np.random.default_rng(2)
    R = torch.from_numpy(rng.standard_normal((4, 6)))
    s_diag = torch.from_numpy(np.linspace(0.5, 2.0, 6))
    n_std = 0.3
    cov = np.linalg.inv(R.numpy().T @ R.numpy() / n_std ** 2 + np.diag(1.0 / s_diag.numpy()))
    proto = torch.zeros(6, dtype=torch.float64)
    draws = torch.stack([tw.draw_posterior_sample(
        seed, lambda s: R @ s, lambda d: d / n_std ** 2, lambda s: s / s_diag,
        lambda xi: xi * s_diag.sqrt(), lambda xi: xi / n_std, domain_proto=proto,
        data_proto=torch.zeros(4, dtype=torch.float64),
        cg_kwargs=dict(resnorm=1e-12, maxiter=50))[0] for seed in range(1000)])
    assert abs(float(draws.mean(0).abs().max())) < 4 * np.sqrt(np.diag(cov).max() / 1000)
    assert _rel(np.cov(draws.numpy().T), cov) < 0.15
