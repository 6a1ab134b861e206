"""Parity of the port's Hartley transform and Fourier-mode helpers
(``nifty_tpu_torch.ops.harmonic``) with ``nifty_tpu.ops.harmonic``.

Tolerance 1e-12 relative to the largest output: the two FFT libraries
(pocketfft in XLA's CPU backend, PyTorch's) add in different orders.
The mode helpers are host numpy code and must agree exactly.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.config as jconfig  # noqa: E402
import nifty_tpu_torch.config as tconfig  # noqa: E402
from nifty_tpu.ops import harmonic as jh  # noqa: E402
from nifty_tpu_torch.likelihood import vjp  # noqa: E402
from nifty_tpu_torch.ops import harmonic as th  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(params=["non_canonical_hartley", "canonical_hartley"])
def convention(request):
    old_j, old_t = jconfig.get("hartley_convention"), tconfig.get("hartley_convention")
    jconfig.update("hartley_convention", request.param)
    tconfig.update("hartley_convention", request.param)
    yield request.param
    jconfig.update("hartley_convention", old_j)
    tconfig.update("hartley_convention", old_t)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=RTOL * np.max(np.abs(want))
    )


@pytest.mark.parametrize("shape,axes", [
    ((32, 32), None), ((12, 9), None), ((17,), None), ((6, 8, 5), None),
    ((4, 10, 12), (1, 2)),
])
def test_hartley_matches_jax(convention, shape, axes):
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    _close(th.hartley(torch.from_numpy(x), axes=axes).numpy(), jh.hartley(jnp.asarray(x), axes=axes))


def test_hartley_complex_input_matches_jax(convention):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6))
    _close(th.hartley(torch.from_numpy(x)).numpy(), jh.hartley(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(16, 16), (9, 14)])
def test_hartley_adjoint_matches_jax(convention, shape):
    """The autograd adjoint equals JAX's transpose, and on the full grid the
    Hartley matrix is symmetric (adjoint == forward)."""
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal(shape), rng.standard_normal(shape)
    _, adj_t = vjp(th.hartley, torch.from_numpy(x))
    got = adj_t(torch.from_numpy(y)).numpy()
    _, adj_j = jax.vjp(jh.hartley, jnp.asarray(x))
    _close(got, adj_j(jnp.asarray(y))[0])
    _close(got, th.hartley(torch.from_numpy(y)).numpy())
    lhs = np.sum(th.hartley(torch.from_numpy(x)).numpy() * y)
    assert abs(lhs - np.sum(x * got)) <= RTOL * np.sum(np.abs(x)) * np.max(np.abs(got))


@pytest.mark.parametrize("shape,distances", [((32, 32), 1 / 32), ((12, 7), (0.5, 2.0))])
def test_mode_helpers_are_the_jax_packages(shape, distances):
    for a, b in zip(th.fourier_mode_distributor(shape, distances),
                    jh.fourier_mode_distributor(shape, distances)):
        np.testing.assert_array_equal(a, b)
    _, um, _ = th.fourier_mode_distributor(shape, distances)
    np.testing.assert_array_equal(
        th.fourier_mode_index_quarter(shape, distances, um),
        jh.fourier_mode_index_quarter(shape, distances, um),
    )
    np.testing.assert_array_equal(
        th.fourier_mode_lengths(shape, distances), jh.fourier_mode_lengths(shape, distances)
    )
