"""The port's Lanczos tridiagonalization and stochastic Lanczos quadrature
(``num/lanczos.py``) against ``nifty_tpu.num.lanczos`` on the same inputs,
float64 on the CPU.

Tolerances are relative, of the Frobenius norm of the difference to the
reference's: the tridiagonal matrix and the Krylov vectors 1e-10, the
SLQ estimate from a given stack 1e-12, and a whole SLQ estimate 1e-10 when
the port is fed the reference's Rademacher probes (a noise provider that
splits its key as ``stochastic_lq_logdet`` does and draws with
``nifty_tpu.tree.random_like``).
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.num.lanczos as jl  # noqa: E402
import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.num.lanczos as tl  # noqa: E402
from nifty_tpu_torch import tree as tt  # noqa: E402

torch.set_num_threads(1)


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


def _spd(rng, n, cond):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _struct(tree):
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float64)


class JaxProbeKey:
    """Noise provider replaying the reference's probes: split with
    ``jax.random.split``, draw with ``nifty_tpu.tree.random_like``
    (Rademacher where the port asks for :func:`tree.rademacher`)."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return [JaxProbeKey(k) for k in jax.random.split(self.key, num)]

    def normal(self, primals, device=None):
        return self.draw(primals, tt.normal, device)

    def draw(self, primals, rng, device=None):
        jrng = jax.random.rademacher if rng is tt.rademacher else jax.random.normal
        out = jtree.random_like(self.key, _struct(primals), rng=jrng)
        return jt.from_numpy(jax.tree_util.tree_map(np.asarray, out), device=device or "cpu")


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(5)
    return _spd(rng, 64, 50.0), rng.standard_normal(64)


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(6)
    return _spd(rng, 40, 20.0), _spd(rng, 24, 10.0)


def _tree_ops(blocks):
    A, B = blocks
    jA, jB = jnp.asarray(A), jnp.asarray(B)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)

    def jop(t):
        return {"a": jA @ t["a"], "b": jB @ t["b"]}

    def top(t):
        return {"a": tA @ t["a"], "b": tB @ t["b"]}

    return jop, top


@pytest.mark.parametrize("order", [1, 12, 24])
def test_lanczos_tridiag_dense(dense, order):
    A, v = dense
    tri_j, vecs_j = jl.lanczos_tridiag(lambda x: jnp.asarray(A) @ x, jnp.asarray(v), order)
    tA = torch.from_numpy(A)
    tri_t, vecs_t = tl.lanczos_tridiag(lambda x: tA @ x, torch.from_numpy(v), order)
    assert tri_t.shape == (order, order) and vecs_t.shape == (order, 64)
    assert _rel(tri_t, tri_j) < 1e-10
    assert _rel(vecs_t, vecs_j) < 1e-10


def test_lanczos_tridiag_tree(blocks):
    jop, top = _tree_ops(blocks)
    rng = np.random.default_rng(7)
    v = {"a": rng.standard_normal(40), "b": rng.standard_normal(24)}
    tri_j, vecs_j = jl.lanczos_tridiag(jop, {k: jnp.asarray(x) for k, x in v.items()}, 20)
    tri_t, vecs_t = tl.lanczos_tridiag(top, jt.from_numpy(v), 20)
    assert _rel(tri_t, tri_j) < 1e-10
    for k in v:
        assert vecs_t[k].shape == (20,) + v[k].shape
        assert _rel(vecs_t[k], vecs_j[k]) < 1e-10


def test_lanczos_rows_match_one_at_a_time(blocks):
    """The lockstep rows give each row's single-probe decomposition."""
    _, top = _tree_ops(blocks)
    rng = np.random.default_rng(8)
    vs = [jt.from_numpy({"a": rng.standard_normal(40), "b": rng.standard_normal(24)})
          for _ in range(3)]
    tri_rows, vecs_rows = tl._lanczos_rows(jt.vmap(top), tt.stack(vs), 16)
    for i, v in enumerate(vs):
        tri, vecs = tl.lanczos_tridiag(top, v, 16)
        assert _rel(tri_rows[i], tri) < 1e-12
        assert _rel(vecs_rows["a"][i], vecs["a"]) < 1e-12


def test_stochastic_logdet_from_lanczos(dense):
    A, _ = dense
    rng = np.random.default_rng(9)
    tA = torch.from_numpy(A)
    stack = np.stack([
        np.asarray(tl.lanczos_tridiag(lambda x: tA @ x, torch.from_numpy(rng.standard_normal(64)),
                                      16)[0]) for _ in range(5)])
    want = float(jl.stochastic_logdet_from_lanczos(jnp.asarray(stack), 64))
    got = float(tl.stochastic_logdet_from_lanczos(torch.from_numpy(stack), 64))
    assert abs(got - want) / abs(want) < 1e-12


@pytest.mark.parametrize("cmap", ["vmap", "smap"])
def test_stochastic_lq_logdet_on_the_reference_probes(blocks, cmap):
    jop, top = _tree_ops(blocks)
    key = jax.random.PRNGKey(42)
    like_j = {"a": jnp.zeros(40), "b": jnp.zeros(24)}
    want = float(jl.stochastic_lq_logdet(jop, order=25, n_samples=6, key=key, probe_like=like_j))
    like_t = {"a": torch.zeros(40, dtype=torch.float64), "b": torch.zeros(24, dtype=torch.float64)}
    got = float(tl.stochastic_lq_logdet(top, 25, 6, JaxProbeKey(key), probe_like=like_t, cmap=cmap))
    assert abs(got - want) / abs(want) < 1e-10


def test_stochastic_lq_logdet_of_a_matrix(dense):
    """Array mode: a matrix and an int seed; the estimate is within the
    JAX package's own 15 % of the exact log-determinant."""
    A, _ = dense
    got = float(tl.stochastic_lq_logdet(torch.from_numpy(A), 30, 40, 3))
    want = np.linalg.slogdet(A)[1]
    assert abs(got - want) / abs(want) < 0.15


def test_stochastic_lq_logdet_rejects_unknown_maps(dense):
    A, _ = dense
    with pytest.raises(ValueError, match="unknown map"):
        tl.stochastic_lq_logdet(torch.from_numpy(A), 4, 2, 0, cmap="pmap")
