"""The port's probing (``probing.py``) against ``nifty_tpu.probing`` on the
same inputs, float64 on the CPU.

``StatCalculator``'s mean and variance agree to 1e-12 relative;
``probe_diagonal`` and ``probe_trace``, fed the reference's Rademacher
probes (a noise provider that splits the key as the reference does and
draws with ``nifty_tpu.tree.random_like``), to 1e-12; the eigenvalues of
``operator_spectrum`` (ARPACK on both sides) to 1e-8.
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.probing as jp  # noqa: E402
import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.probing as tp  # noqa: E402
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


def _struct(tree):
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float64)


class JaxProbeKey:
    """Noise provider replaying the reference's probes."""

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
def operator():
    """A symmetric operator on a dict tree: dense blocks coupled across
    leaves."""
    rng = np.random.default_rng(11)
    m = rng.standard_normal((30, 30))
    M = m @ m.T / 30 + np.diag(np.linspace(1.0, 5.0, 30))

    def split_vec(x, xp):
        return {"u": x[:18].reshape(3, 6), "w": x[18:]}

    def jop(t):
        x = jnp.concatenate([t["u"].ravel(), t["w"]])
        return split_vec(jnp.asarray(M) @ x, jnp)

    tM = torch.from_numpy(M)

    def top(t):
        x = torch.cat([t["u"].reshape(-1), t["w"]])
        return split_vec(tM @ x, torch)

    proto_j = {"u": jnp.zeros((3, 6)), "w": jnp.zeros(12)}
    proto_t = {"u": torch.zeros((3, 6), dtype=torch.float64),
               "w": torch.zeros(12, dtype=torch.float64)}
    return M, jop, top, proto_j, proto_t


def test_stat_calculator():
    rng = np.random.default_rng(1)
    values = [{"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))} for _ in range(7)]
    sj, st = jp.StatCalculator(), tp.StatCalculator()
    for v in values:
        sj.add({k: jnp.asarray(x) for k, x in v.items()})
        st.add(jt.from_numpy(v))
    for k in values[0]:
        assert _rel(st.mean[k], sj.mean[k]) < 1e-12
        assert _rel(st.var[k], sj.var[k]) < 1e-12
        assert _rel(st.var[k], np.var([v[k] for v in values], axis=0, ddof=1)) < 1e-12


def test_stat_calculator_needs_values():
    st = tp.StatCalculator()
    with pytest.raises(RuntimeError):
        st.mean
    st.add(torch.ones(3))
    with pytest.raises(RuntimeError):
        st.var


@pytest.mark.parametrize("n_probes", [1, 16])
def test_probe_diagonal_on_the_reference_probes(operator, n_probes):
    _, jop, top, proto_j, proto_t = operator
    key = jax.random.PRNGKey(3)
    want = jp.probe_diagonal(jop, proto_j, key, n_probes=n_probes)
    got = tp.probe_diagonal(top, proto_t, JaxProbeKey(key), n_probes=n_probes)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-12


def test_probe_trace_on_the_reference_probes(operator):
    _, jop, top, proto_j, proto_t = operator
    key = jax.random.PRNGKey(4)
    want = float(jp.probe_trace(jop, proto_j, key, n_probes=32))
    got = float(tp.probe_trace(top, proto_t, JaxProbeKey(key), n_probes=32))
    assert abs(got - want) / abs(want) < 1e-12


def test_probe_trace_converges(operator):
    """With an int seed the estimate is within Monte-Carlo error of the
    trace."""
    M, _, top, _, proto_t = operator
    got = float(tp.probe_trace(top, proto_t, 0, n_probes=400))
    assert abs(got - np.trace(M)) < 0.1 * np.trace(M)


@pytest.mark.parametrize("k", [1, 6])
def test_operator_spectrum(operator, k):
    M, jop, top, proto_j, proto_t = operator
    want = jp.operator_spectrum(jop, proto_j, k=k)
    got = tp.operator_spectrum(top, proto_t, k=k)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(got, np.sort(np.linalg.eigvalsh(M))[::-1][:k], rtol=1e-8)


def test_operator_spectrum_of_shapes(operator):
    """A prototype of shapes: the matvec runs on the configured device."""
    M, _, top, _, proto_t = operator
    got = tp.operator_spectrum(top, tt.shape_dtype_like(proto_t), k=2)
    np.testing.assert_allclose(got, np.sort(np.linalg.eigvalsh(M))[::-1][:2], rtol=1e-8)


def test_approximation2endo_unchanged():
    s = torch.tensor([[1.0, 0.0], [3.0, 0.0]], dtype=torch.float64)
    np.testing.assert_array_equal(tp.approximation2endo(s, eps=1e-6), [5.0, 1e-6])
