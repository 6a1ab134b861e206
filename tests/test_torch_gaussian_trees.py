"""Parity of the port's ``Gaussian`` with ``nifty_tpu``'s for data that is a
dict of tensors and for complex data: energy, metric, normalized residual,
the square roots of the metric and one linearization of the
transformation.  Tolerance 1e-12 relative to the largest entry (a few
pointwise products and one sum).

The JAX package multiplies by a diagonal given as an array and cannot
multiply a dict of arrays (``Partial(operator.mul, tree)``), so there the
dict-valued noise is given as callables that do the same leaf by leaf; the
port takes the dicts themselves as well.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu_torch.likelihood import linearize  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _close(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.max(np.abs(want)))


def _close_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    else:
        _close(got, want)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jt.from_numpy(tree) if isinstance(tree, dict) else torch.from_numpy(tree)


RNG = np.random.default_rng(0)
DICT_DATA = {"a": RNG.standard_normal((4, 5)), "b": RNG.standard_normal(7)}
DICT_STD_INV = {"a": RNG.uniform(0.5, 2.0, (4, 5)), "b": RNG.uniform(0.5, 2.0, 7)}
COMPLEX_DATA = RNG.standard_normal(9) + 1j * RNG.standard_normal(9)
COMPLEX_COV_INV = RNG.uniform(0.5, 2.0, 9)


def _leafwise(diag):
    return lambda x: jax.tree_util.tree_map(lambda v, d: v * d, x, _to_jax(diag))


def _square(tree):
    return {k: v ** 2 for k, v in tree.items()}


# name -> (data, the port's keyword arguments, the JAX package's)
CASES = {
    "dict_std_inv_tree": (DICT_DATA, dict(noise_std_inv=DICT_STD_INV),
                          dict(noise_std_inv=_leafwise(DICT_STD_INV),
                               noise_cov_inv=_leafwise(_square(DICT_STD_INV)))),
    "dict_cov_inv_tree": (DICT_DATA, dict(noise_cov_inv=_square(DICT_STD_INV)),
                          dict(noise_std_inv=_leafwise(DICT_STD_INV),
                               noise_cov_inv=_leafwise(_square(DICT_STD_INV)))),
    "dict_callables": (DICT_DATA, dict(noise_std_inv=lambda x: {k: 2.0 * v for k, v in x.items()},
                                       noise_cov_inv=lambda x: {k: 4.0 * v for k, v in x.items()}),
                       dict(noise_std_inv=_leafwise({"a": 2.0, "b": 2.0}),
                            noise_cov_inv=_leafwise({"a": 4.0, "b": 4.0}))),
    "dict_identity": (DICT_DATA, {}, {}),
    "complex_cov_inv": (COMPLEX_DATA, dict(noise_cov_inv=COMPLEX_COV_INV),
                        dict(noise_cov_inv=jnp.asarray(COMPLEX_COV_INV))),
    "complex_std_inv": (COMPLEX_DATA, dict(noise_std_inv=np.sqrt(COMPLEX_COV_INV)),
                        dict(noise_std_inv=jnp.asarray(np.sqrt(COMPLEX_COV_INV)))),
}


def _like(data, seed):
    rng = np.random.default_rng(seed)
    if isinstance(data, dict):
        return {k: rng.standard_normal(v.shape) for k, v in data.items()}
    return rng.standard_normal(data.shape) + 1j * rng.standard_normal(data.shape)


@pytest.mark.parametrize("case", CASES)
def test_gaussian_matches_for_trees_and_complex_data(case):
    data, kw_t, kw_j = CASES[case]
    kw_t = {k: _to_torch(v) if isinstance(v, (dict, np.ndarray)) else v for k, v in kw_t.items()}
    lh_t = jt.Gaussian(_to_torch(data), **kw_t)
    lh_j = jft.Gaussian(_to_jax(data), **kw_j)
    x, t = _like(data, 1), _like(data, 2)
    x_t, x_j, t_t, t_j = _to_torch(x), _to_jax(x), _to_torch(t), _to_jax(t)
    _close(lh_t.energy(x_t), lh_j.energy(x_j))
    _close_tree(lh_t.normalized_residual(x_t), lh_j.normalized_residual(x_j))
    _close_tree(lh_t.metric(x_t, t_t), lh_j.metric(x_j, t_j))
    _close_tree(lh_t.left_sqrt_metric(x_t, t_t), lh_j.left_sqrt_metric(x_j, t_j))
    y_j, jvp_j = jax.linearize(lh_j.transformation, x_j)
    _, vjp_j = jax.vjp(lh_j.transformation, x_j)
    y_t, jvp_t, vjp_t = linearize(lh_t.transformation, x_t)
    _close_tree(y_t, y_j)
    _close_tree(jvp_t(t_t), jvp_j(t_j))
    _close_tree(vjp_t(t_t), vjp_j(t_j)[0])
    if not isinstance(data, dict):
        # a real tangent stays real: the inferred diagonal is that of real(d)
        r = np.random.default_rng(3).standard_normal(data.shape)
        _close(lh_t.left_sqrt_metric(x_t, torch.from_numpy(r)),
               lh_j.left_sqrt_metric(x_j, jnp.asarray(r)))


def test_gaussian_keeps_each_leaf_as_a_buffer():
    lh = jt.Gaussian(jt.from_numpy(DICT_DATA), noise_std_inv=jt.from_numpy(DICT_STD_INV))
    names = {n for n, _ in lh.named_buffers()}
    assert names == {"_data.0", "_data.1", "_diags.std_inv.0", "_diags.std_inv.1",
                     "_diags.cov_inv.0", "_diags.cov_inv.1"}
    moved = lh.to(torch.float32)
    assert moved.data["a"].dtype == torch.float32 and sorted(moved.data) == ["a", "b"]
    assert tuple(lh.domain["a"].shape) == (4, 5)
    # the inferred diagonal of complex data is real: the ones of real(d)
    lh_c = jt.Gaussian(torch.from_numpy(COMPLEX_DATA), noise_cov_inv=torch.from_numpy(COMPLEX_COV_INV))
    assert not lh_c.noise_std_inv(torch.ones(9, dtype=torch.float64)).is_complex()
