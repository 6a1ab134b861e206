"""The port's self-checks (``nifty_tpu_torch.extra``): they pass on every
likelihood of the port, on linear and nonlinear models and on the
correlated field, and each fails on a deliberately wrong adjoint, Jacobian,
inverse, dtype or impure model.  Both packages' checks agree on the same
likelihoods."""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from test_torch_driver import build  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


RNG = np.random.default_rng(0)
DATA = torch.from_numpy(RNG.standard_normal(6))


def _positive(shape):
    """A model onto positive values, for likelihoods of rates."""
    return jt.Model(lambda x: torch.exp(0.3 * x), domain=jt.ShapeWithDtype(shape))


def _unit_interval(shape):
    return jt.Model(lambda x: 0.05 + 0.9 * torch.sigmoid(x), domain=jt.ShapeWithDtype(shape))


def _mean_and_scale(shape):
    return jt.Model(lambda x: (x[0], torch.exp(0.3 * x[1])),
                    domain=(jt.ShapeWithDtype(shape), jt.ShapeWithDtype(shape)))


LIKELIHOODS = {
    "gaussian": lambda: jt.Gaussian(DATA, noise_cov_inv=lambda x: 4.0 * x),
    "gaussian_dict": lambda: jt.Gaussian(
        {"a": DATA, "b": DATA[:3]}, noise_std_inv={"a": torch.full((6,), 2.0),
                                                   "b": torch.full((3,), 0.5)}),
    "studentt": lambda: jt.StudentT(DATA, dof=3.0, noise_std_inv=lambda x: 2.0 * x),
    "poissonian": lambda: jt.Poissonian(torch.from_numpy(RNG.poisson(5.0, 6))).amend(
        _positive((6,))),
    "bernoulli": lambda: jt.Bernoulli(torch.from_numpy(RNG.integers(0, 2, 6))).amend(
        _unit_interval((6,))),
    "inverse_gamma": lambda: jt.InverseGamma(torch.full((6,), 1.5), alpha=2.0).amend(
        _positive((6,))),
    "vc_gaussian": lambda: jt.VariableCovarianceGaussian(DATA).amend(_mean_and_scale((6,))),
    "vc_studentt": lambda: jt.VariableCovarianceStudentT(DATA, dof=3.0).amend(
        _mean_and_scale((6,))),
    "categorical": lambda: jt.Categorical(torch.from_numpy(RNG.integers(0, 3, (4, 1)))),
    "sum": lambda: jt.Poissonian(torch.from_numpy(RNG.poisson(5.0, 6))).amend(
        jt.Model(lambda x: torch.exp(0.3 * x["a"]), domain={"a": jt.ShapeWithDtype((6,))}))
    + jt.Gaussian(DATA[:4]).amend(
        jt.Model(lambda x: x["b"] ** 3, domain={"b": jt.ShapeWithDtype((4,))})),
}


@pytest.mark.parametrize("name", LIKELIHOODS)
def test_check_likelihood_passes_on_every_likelihood(name):
    lh = LIKELIHOODS[name]()
    # the categorical left square root is not the metric's exact root (the
    # JAX package's tests skip that leg for it too)
    assert jt.check_likelihood(lh, jt.HostKey(3), check_metric_root=name != "categorical")


def test_check_likelihood_agrees_with_jax_on_a_wrong_root():
    """Both packages' checks reject a likelihood whose left square root is
    not the metric's root, and accept the right one."""

    class Wrong(jt.Poissonian):
        def metric(self, primals, tangents):
            return jt.tree.tree_map(lambda t, p: 2.0 * t / p, tangents, primals)

    class WrongJ(jft.Poissonian):
        def metric(self, primals, tangents):
            return jax.tree_util.tree_map(lambda t, p: 2.0 * t / p, tangents, primals)

    counts = RNG.poisson(5.0, 6)
    with pytest.raises(AssertionError, match="metric"):
        jt.check_likelihood(Wrong(torch.from_numpy(counts)).amend(_positive((6,))), 1)
    f_j = jft.Model(lambda x: jnp.exp(0.3 * x), domain=jax.ShapeDtypeStruct((6,), jnp.float64))
    with pytest.raises(AssertionError, match="metric"):
        jft.check_likelihood(WrongJ(jnp.asarray(counts)).amend(f_j), jax.random.PRNGKey(1))
    assert jft.check_likelihood(jft.Poissonian(jnp.asarray(counts)).amend(f_j),
                                jax.random.PRNGKey(1))


class _WrongBackward(torch.autograd.Function):
    """``x -> A x`` whose backward applies ``B^T`` with ``B != A`` (and whose
    forward-mode derivative is the true ``A``)."""

    @staticmethod
    def forward(x, a, b):
        return a @ x

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.a, ctx.b = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return ctx.b.T @ g, None, None

    @staticmethod
    def jvp(ctx, x_dot, _a_dot, _b_dot):
        return ctx.a @ x_dot


A = torch.from_numpy(RNG.standard_normal((5, 4)))
B = A + 0.1 * torch.from_numpy(RNG.standard_normal((5, 4)))
DOM4 = jt.ShapeWithDtype((4,))


def test_check_linear_model_passes_and_catches_a_wrong_adjoint():
    assert jt.check_linear_model(lambda x: A @ x, DOM4, 0)
    assert jt.check_linear_model(lambda x: 3.0 * x.flip(0) + x.cumsum(0), DOM4, 0,
                                 dtypes=("float32", "float64"), rtol=1e-5, atol=1e-6,
                                 assert_purity=True)
    assert jt.check_linear_model(lambda x: _WrongBackward.apply(x, A, A), DOM4, 0)
    with pytest.raises(AssertionError, match="adjoint"):
        jt.check_linear_model(lambda x: _WrongBackward.apply(x, A, B), DOM4, 0)
    with pytest.raises(AssertionError, match="linearity"):
        jt.check_linear_model(lambda x: A @ x + 1.0, DOM4, 0)


def test_check_linear_model_on_complex_and_tree_maps():
    c = torch.from_numpy(RNG.standard_normal(4) + 1j * RNG.standard_normal(4))
    dom_c = jt.ShapeWithDtype((4,), torch.complex128)
    assert jt.check_linear_model(lambda x: c * torch.fft.fft(x), dom_c, 1)
    dom_t = {"a": jt.ShapeWithDtype((3,)), "b": jt.ShapeWithDtype((2, 2))}
    assert jt.check_linear_model(lambda x: {"s": x["a"].sum() + x["b"].sum(), "a": 2 * x["a"]},
                                 dom_t, 2)


def test_check_linear_model_inverse_leg():
    q = torch.linalg.qr(torch.from_numpy(RNG.standard_normal((4, 4))))[0]
    assert jt.check_linear_model(lambda x: q @ x, DOM4, 3, inverse=lambda y: q.T @ y)
    with pytest.raises(AssertionError, match="inverse"):
        jt.check_linear_model(lambda x: q @ x, DOM4, 3, inverse=lambda y: 1.01 * q.T @ y)


def test_check_model_passes_and_catches_a_wrong_jacobian():
    def f(x):
        return {"u": torch.sin(x["a"]) * x["b"][0], "v": torch.exp(x["b"])}

    dom = {"a": jt.ShapeWithDtype((5,)), "b": jt.ShapeWithDtype((3,))}
    assert jt.check_model(f, dom, 4, assert_purity=True)

    def wrong_jacobian(x):  # forward-mode derivative 1.2 times too large
        return torch.sin(x) + 0.2 * (x - x.detach())

    with pytest.raises(AssertionError, match="FD"):
        jt.check_model(wrong_jacobian, jt.ShapeWithDtype((5,)), 4)
    with pytest.raises(AssertionError, match="adjoint"):
        jt.check_model(lambda x: torch.tanh(_WrongBackward.apply(x, A, B)), DOM4, 4)


def test_check_model_on_the_correlated_field():
    cf = build(jt, dims=(16, 16))
    assert jt.check_model(cf, cf.domain, jt.HostKey(5), assert_purity=True)


def test_check_inverse_on_the_distribution_transforms():
    dom = jt.ShapeWithDtype((50,))
    # in log space, so that both round trips start from standard normal draws
    to_ig = jt.invgamma_prior(3.0, 2.0, step=1e-3)
    from_ig = jt.invgamma_invprior(3.0, 2.0, step=1e-3)
    assert jt.check_inverse(lambda x: torch.log(to_ig(x)), lambda y: from_ig(torch.exp(y)),
                            dom, 6, rtol=1e-5, atol=1e-6)
    assert jt.check_inverse(jt.normal_prior(1.0, 2.0), jt.normal_invprior(1.0, 2.0), dom, 6)
    with pytest.raises(AssertionError, match="inverse"):
        jt.check_inverse(jt.normal_prior(1.0, 2.0), jt.normal_invprior(1.0, 2.1), dom, 6)


def test_check_dtype_purity_and_purity():
    assert jt.check_dtype_purity(lambda x: 2.0 * x, DOM4, 0)
    with pytest.raises(AssertionError, match="dtype purity"):
        jt.check_dtype_purity(lambda x: x.double(), DOM4, 0)
    assert jt.check_dtype_purity(lambda x: x.double(), DOM4, 0, expected="float64")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(AssertionError, match="impure"):
        jt.check_purity(lambda x: x + torch.randn(4, generator=gen, dtype=x.dtype), torch.ones(4))
    with pytest.raises(AssertionError, match="differ"):
        jt.assert_equal_tree({"a": torch.ones(2)}, {"a": torch.tensor([1.0, 1.0 + 1e-6])})
    jt.assert_equal_tree({"a": torch.ones(2)}, {"a": torch.ones(2)})
