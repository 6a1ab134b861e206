"""Parity of the port's domains and fields (``nifty_tpu_torch.domains``,
``nifty_tpu_torch.field``) with ``nifty_tpu.domains`` and
``nifty_tpu.field`` on the same numpy inputs, float64.

Domains are host metadata and must agree exactly; field values, volume
factors, dot products, power spectra and the DOF distributor agree to
1e-12 of the largest entry (the power spectrum's per-bin sums run through
the distributor's segment sum in another order than ``segment_sum``).
"""

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import domains as jd  # noqa: E402
from nifty_tpu import field as jf  # noqa: E402
from nifty_tpu_torch import domains as td  # noqa: E402
from nifty_tpu_torch import field as tf  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    from nifty_tpu_torch import config

    old = config.get("device")
    config.update("device", "cpu")
    yield
    config.update("device", old)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


DOMAINS = {
    "rg": lambda m: m.RGSpace((8, 6), distances=(0.25, 0.5)),
    "rg_harmonic": lambda m: m.RGSpace((8, 8), distances=0.125, harmonic=True),
    "unstructured": lambda m: m.UnstructuredDomain(5),
    "lm": lambda m: m.LMSpace(8),
    "lm_mmax": lambda m: m.LMSpace(8, mmax=3),
    "gl": lambda m: m.GLSpace(8),
    "gl_nlon": lambda m: m.GLSpace(6, 13),
    "hp": lambda m: m.HPSpace(4),
    "dof": lambda m: m.DOFSpace([1.0, 2.5, 3.0]),
}


@pytest.mark.parametrize("name", DOMAINS)
def test_domain_metadata_matches(name):
    a, b = DOMAINS[name](td), DOMAINS[name](jd)
    assert a.shape == b.shape and a.size == b.size
    assert a.harmonic == b.harmonic
    assert a.scalar_dvol == b.scalar_dvol
    if a.scalar_dvol is None:
        np.testing.assert_array_equal(a.dvol, b.dvol)
    np.testing.assert_allclose(a.total_volume, b.total_volume, rtol=1e-15)
    assert a == DOMAINS[name](td) and hash(a) == hash(DOMAINS[name](td))
    if hasattr(b, "get_default_codomain"):
        ca, cb = a.get_default_codomain(), b.get_default_codomain()
        assert type(ca).__name__ == type(cb).__name__ and ca.shape == cb.shape
        assert ca._key() == cb._key()
    if a.harmonic and hasattr(b, "get_k_length_array"):
        _close(a.get_k_length_array(), b.get_k_length_array())
        k = a.get_k_length_array()
        _close(a.get_fft_smoothing_kernel_function(0.3)(k),
               b.get_fft_smoothing_kernel_function(0.3)(jnp.asarray(_np(k))))


@pytest.mark.parametrize("binbounds", [None, "log"], ids=["unique", "log"])
def test_power_space_matches(binbounds):
    h_t = td.RGSpace((16, 16), 1.0 / 16).get_default_codomain()
    h_j = jd.RGSpace((16, 16), 1.0 / 16).get_default_codomain()
    bb = None
    if binbounds == "log":
        bb = td.PowerSpace.useful_binbounds(h_t, logarithmic=True)
        np.testing.assert_array_equal(bb, jd.PowerSpace.useful_binbounds(h_j, logarithmic=True))
    p_t, p_j = td.PowerSpace(h_t, bb), jd.PowerSpace(h_j, bb)
    np.testing.assert_array_equal(p_t.pindex, p_j.pindex)
    np.testing.assert_array_equal(p_t.k_lengths, p_j.k_lengths)
    np.testing.assert_array_equal(p_t.dvol, p_j.dvol)
    assert p_t.shape == p_j.shape and p_t.binbounds == p_j.binbounds
    with pytest.raises(ValueError):
        td.PowerSpace(td.RGSpace(8))


def test_domain_tuple_is_cached_and_ordered():
    s, u = td.RGSpace((4, 3)), td.UnstructuredDomain(2)
    dt = td.DomainTuple.make((s, u))
    assert td.DomainTuple.make((s, u)) is dt and td.DomainTuple.make(dt) is dt
    assert dt.shape == (4, 3, 2) and dt.size == 24 and len(dt) == 2
    assert dt.axes == jd.DomainTuple.make((jd.RGSpace((4, 3)), jd.UnstructuredDomain(2))).axes
    assert list(dt) == [s, u] and dt[1] is u


@pytest.mark.parametrize("name", ["rg", "gl", "hp", "lm"])
def test_field_volume_calculus_matches(name):
    dom_t, dom_j = DOMAINS[name](td), DOMAINS[name](jd)
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(dom_t.shape), rng.standard_normal(dom_t.shape)
    f_t, g_t = tf.makeField(dom_t, a), tf.makeField(dom_t, b)
    f_j, g_j = jf.makeField(dom_j, a), jf.makeField(dom_j, b)
    for power in (1, 2, -1):
        _close(f_t.weight(power).val, f_j.weight(power).val)
    _close(f_t.vdot(g_t), f_j.vdot(g_j))
    _close(f_t.integrate(), f_j.integrate())
    _close(tf.full(dom_t, 2.0).integrate(), jf.full(dom_j, 2.0).integrate())
    for stat in ("s_sum", "s_mean", "s_var", "s_std", "norm"):
        _close(getattr(f_t, stat)(), getattr(f_j, stat)())
    with pytest.raises(ValueError):
        f_t.vdot(tf.makeField(td.UnstructuredDomain(f_t.shape), b))


def test_field_arithmetic_matches():
    dom_t, dom_j = td.UnstructuredDomain(7), jd.UnstructuredDomain(7)
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0.5, 2.0, 7), rng.uniform(0.5, 2.0, 7)
    f_t, g_t = tf.makeField(dom_t, a), tf.makeField(dom_t, b)
    f_j, g_j = jf.makeField(dom_j, a), jf.makeField(dom_j, b)
    ops = [lambda f, g: f + g, lambda f, g: f - 2.0, lambda f, g: 3.0 - f,
           lambda f, g: f * g, lambda f, g: 2.0 * f, lambda f, g: f / g, lambda f, g: 1.0 / f,
           lambda f, g: f ** 2, lambda f, g: -f, lambda f, g: abs(f - g),
           lambda f, g: (2.0 * f + 1.0).exp(), lambda f, g: f.log(), lambda f, g: f.sqrt(),
           lambda f, g: f.ptw("tanh")]
    for op in ops:
        out_t, out_j = op(f_t, g_t), op(f_j, g_j)
        assert isinstance(out_t, tf.Field) and out_t.domain == f_t.domain
        _close(out_t.val, out_j.val)
    with pytest.raises(ValueError):
        f_t + tf.makeField(td.UnstructuredDomain(7 * (1,) + (7,)), a)


def test_from_random_takes_generators_and_host_keys():
    dom = td.RGSpace((5, 4))
    f = tf.from_random(dom, jt.HostKey(3))
    g = tf.from_random(dom, jt.HostKey(3))
    assert torch.equal(f.val, g.val) and f.val.shape == (5, 4)
    h1 = tf.from_random(dom, torch.Generator().manual_seed(1))
    h2 = tf.Field.from_random(dom, 1)
    assert h1.val.dtype == torch.float64 and torch.equal(h1.val, h2.val)
    # the same standard normals as numpy's, for a host key
    want = jt.random_like(jt.HostKey(3), jt.ShapeWithDtype((5, 4)), device="cpu")
    assert torch.equal(f.val, want)


@pytest.mark.parametrize("shape", [(32, 32), (12, 10)])
def test_power_analyze_matches(shape):
    h_t = td.RGSpace(shape, distances=1.0 / shape[0], harmonic=True)
    h_j = jd.RGSpace(shape, distances=1.0 / shape[0], harmonic=True)
    vals = np.random.default_rng(3).standard_normal(shape)
    got = tf.power_analyze(tf.makeField(h_t, vals))
    want = jf.power_analyze(jf.makeField(h_j, vals))
    assert isinstance(got.domain[0], td.PowerSpace)
    _close(got.val, want.val)
    with pytest.raises(ValueError):
        tf.power_analyze(tf.makeField(td.RGSpace(shape), vals))


def test_power_analyze_recovers_a_known_spectrum():
    h = td.RGSpace((32, 32), distances=1.0 / 32, harmonic=True)
    p = td.PowerSpace(h)
    spec = 1.0 / (1.0 + np.asarray(p.k_lengths)) ** 2
    f = tf.Field(td.DomainTuple.make(h), torch.from_numpy(np.sqrt(spec[p.pindex])))
    np.testing.assert_allclose(tf.power_analyze(f).val.numpy(), spec, rtol=1e-12)


def test_dof_distributor_matches():
    rng = np.random.default_rng(42)
    dofdex = rng.integers(0, 5, size=(6, 7))
    dofdex.ravel()[:5] = np.arange(5)
    times_t, space_t = tf.dof_distributor(dofdex)
    times_j, space_j = jf.dof_distributor(dofdex)
    assert space_t.shape == space_j.shape == (5,)
    np.testing.assert_array_equal(space_t.dvol, space_j.dvol)
    assert space_t == td.DOFSpace(np.bincount(dofdex.ravel()))
    x = rng.standard_normal(5)
    _close(times_t(torch.from_numpy(x)), times_j(jnp.asarray(x)))
    y = rng.standard_normal(dofdex.shape)
    _, vjp = torch.func.vjp(times_t, torch.from_numpy(x))
    (adj_j,) = jax.linear_transpose(times_j, jnp.asarray(x))(jnp.asarray(y))
    _close(vjp(torch.from_numpy(y))[0], adj_j)
    # leading axes batch the tables
    xb = rng.standard_normal((3, 5))
    _close(times_t(torch.from_numpy(xb))[2], times_j(jnp.asarray(xb[2])))
    # a partner with non-scalar pixel volumes weights the DOFs
    h_t = td.RGSpace((8, 8), distances=1.0 / 8, harmonic=True)
    h_j = jd.RGSpace((8, 8), distances=1.0 / 8, harmonic=True)
    groups = np.arange(td.PowerSpace(h_t).shape[0]) // 2
    _, d_t = tf.dof_distributor(groups, partner=td.PowerSpace(h_t))
    _, d_j = jf.dof_distributor(groups, partner=jd.PowerSpace(h_j))
    np.testing.assert_array_equal(d_t.dvol, d_j.dvol)
    _, s_t = tf.dof_distributor(np.zeros(h_t.shape, dtype=np.int64), partner=h_t)
    np.testing.assert_allclose(s_t.dvol, [h_t.size * h_t.scalar_dvol])
    with pytest.raises(ValueError):
        tf.dof_distributor(np.array([0, 0, 2]))
    with pytest.raises(TypeError):
        tf.dof_distributor(np.array([0.0, 1.0]))


def test_create_power_operator_matches():
    h_t = td.RGSpace((16,), distances=1.0, harmonic=True)
    h_j = jd.RGSpace((16,), distances=1.0, harmonic=True)
    x = np.random.default_rng(5).standard_normal(16)
    op_t = tf.create_power_operator(h_t, lambda k: 1.0 / (1.0 + k ** 2))
    op_j = jf.create_power_operator(h_j, lambda k: 1.0 / (1.0 + k ** 2))
    _close(op_t(torch.from_numpy(x)), op_j(jnp.asarray(x)))
    spec = np.linspace(1.0, 2.0, 16)
    _close(tf.create_power_operator(h_t, spec)(torch.from_numpy(x)),
           jf.create_power_operator(h_j, spec)(jnp.asarray(x)))


def test_exports_match_the_jax_package():
    for name in ("DOFSpace", "DomainTuple", "Domain", "GLSpace", "HPSpace", "LMSpace",
                 "PowerSpace", "RGSpace", "UnstructuredDomain", "Field", "create_power_operator",
                 "dof_distributor", "from_random", "full", "makeField", "power_analyze",
                 "SphericalHarmonicTransform", "SphericalHarmonicTransformOnTheFly"):
        assert hasattr(jft, name) and hasattr(jt, name), name
    assert hasattr(jt.ops, "HEALPixSHT")
