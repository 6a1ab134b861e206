"""Parity of the port's small helpers with ``nifty_tpu``'s on the same
numpy inputs in float64: ``num.unique`` / ``amend_unique`` (identical
outputs), ``PyTreeString`` and ``hide_strings`` (the same behaviour, and
the solvers print the same line for a ``PyTreeString`` name as for a
``str``), ``hvp``, ``interpolate`` and ``ops.harmonic.fftn`` / ``ifftn``
(1e-12 of the largest entry), ``config.default_complex_dtype``, and the
instrumentation: ``exec_time`` returns the JAX function's keys on the same
likelihood and ``CountingModel`` the same counts and report after the same
calls."""

import importlib
import logging

import jax
import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu as jft  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
from nifty_tpu import config as jconfig  # noqa: E402
from nifty_tpu.ops import harmonic as jharm  # noqa: E402
from nifty_tpu_torch.ops import harmonic as tharm  # noqa: E402
from nifty_tpu_torch.solvers.newton_cg import _newton_cg  # noqa: E402

# the packages' `num` export a function of the module's name
jnum = importlib.import_module("nifty_tpu.num.unique")
tnum = importlib.import_module("nifty_tpu_torch.num.unique")

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _close(got, want, tol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


# -- num.unique ----------------------------------------------------------------


def _near_duplicates(seed, n=40, width=6, distinct=5):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(distinct, width))
    pick = rng.integers(0, distinct, size=n)
    return (base[pick] + 1e-12 * rng.normal(size=(n, width))).T


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_unique_matches_jax(seed, axis):
    ar = _near_duplicates(seed)
    ar = ar if axis == -1 else ar.T
    u_j, inv_j = jnum.unique(ar, return_inverse=True, axis=axis)
    u_t, inv_t = tnum.unique(ar, return_inverse=True, axis=axis)
    assert np.array_equal(u_t, u_j) and np.array_equal(inv_t, inv_j)
    assert np.array_equal(tnum.unique(ar, axis=axis), jnum.unique(ar, axis=axis))


@pytest.mark.parametrize("new", [False, True])
def test_amend_unique_matches_jax(new):
    ar = jnum.unique(_near_duplicates(2))
    el = np.full(ar.shape[0], 7.0) if new else ar[:, 2] + 1e-13
    a_j, i_j = jnum.amend_unique(ar, el)
    a_t, i_t = tnum.amend_unique(ar, el)
    assert np.array_equal(a_t, a_j) and i_t == i_j
    assert (i_t == ar.shape[1]) == new


def test_unique_rejects_a_non_int_axis():
    with pytest.raises(TypeError):
        tnum.unique(np.zeros((2, 2)), axis=(0,))


# -- PyTreeString ----------------------------------------------------------------


def test_pytree_string_behaves_as_the_jax_class():
    for mod in (jft, jt):
        s = mod.PyTreeString("cg_name")
        assert s == "cg_name" and s == mod.PyTreeString("cg_name") and s != "other"
        assert hash(s) == hash("cg_name") and str(s) == "cg_name" and s.str == "cg_name"
        assert repr(s) == "PyTreeString('cg_name')"
        assert s + "!" == "cg_name!" and "<" + s == "<cg_name"
        assert isinstance(s + "!", mod.PyTreeString) and isinstance("<" + s, mod.PyTreeString)
        with pytest.raises(AttributeError):
            s._str = "x"
        with pytest.raises(AttributeError):
            s.anything = 1


def test_hide_and_unhide_strings():
    tree = {"name": "solver-A", "sub": ("x", 3), "x": torch.ones(3)}
    hidden = jt.hide_strings(tree)
    assert isinstance(hidden["name"], jt.PyTreeString)
    assert isinstance(hidden["sub"][0], jt.PyTreeString) and hidden["sub"][1] == 3
    back = jt.unhide_strings(hidden)
    assert back["name"] == "solver-A" and type(back["name"]) is str
    assert back["sub"] == ("x", 3) and back["x"] is tree["x"]
    want = jax.tree_util.tree_map(str, jft.unhide_strings(jft.hide_strings(
        {"name": "solver-A", "sub": ("x", 3)})))
    assert {"name": back["name"], "sub": tuple(map(str, back["sub"]))} == want


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(fn):
    h = _Lines()
    old = jt.logger.level
    jt.logger.addHandler(h)
    jt.logger.setLevel(logging.INFO)
    try:
        fn()
    finally:
        jt.logger.removeHandler(h)
        jt.logger.setLevel(old)
    return h.lines


def _quadratic(n=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return torch.from_numpy(a @ a.T + n * np.eye(n)), torch.from_numpy(rng.normal(size=n))


@pytest.mark.parametrize("solver", ["cg", "newton_cg"])
def test_solvers_print_a_pytree_string_name_as_its_string(solver):
    A, j = _quadratic()

    def run(name):
        if solver == "cg":
            return lambda: jt.static_cg(lambda t: A @ t, j, name=name, maxiter=8, miniter=8,
                                        resnorm=1e-30)

        def rosen(x):
            return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

        return lambda: _newton_cg(rosen, torch.zeros(5, dtype=torch.float64), name=name,
                                  maxiter=5)

    plain, wrapped = _logged(run("TAG")), _logged(run(jt.PyTreeString("TAG")))
    assert plain == wrapped
    assert sum("TAG: CG it" in ln for ln in plain) >= (8 if solver == "cg" else 0)
    if solver == "newton_cg":
        assert any("TAG: NCG it" in ln for ln in plain)
        assert any("TAGCG: CG it" in ln for ln in plain)  # the inner CG inherits the tag


# -- misc, config, harmonic ------------------------------------------------------------


def test_hvp_matches_jax():
    rng = np.random.default_rng(3)
    x, t, w = rng.normal(size=7), rng.normal(size=7), rng.normal(size=7)

    def f_j(v):
        return jnp.sum(jnp.sin(v) * v ** 2 * w) + jnp.sum(v[1:] * v[:-1]) ** 2

    def f_t(v):
        return torch.sum(torch.sin(v) * v ** 2 * torch.from_numpy(w)) + torch.sum(v[1:] * v[:-1]) ** 2

    want = jft.hvp(f_j, (jnp.asarray(x),), (jnp.asarray(t),))
    _close(jt.hvp(f_t, (torch.from_numpy(x),), (torch.from_numpy(t),)), want)
    # a tree of primals
    want = jft.hvp(lambda p: f_j(p["a"]) * jnp.sum(p["b"] ** 3),
                   ({"a": jnp.asarray(x), "b": jnp.asarray(w)},),
                   ({"a": jnp.asarray(t), "b": jnp.asarray(x)},))
    got = jt.hvp(lambda p: f_t(p["a"]) * torch.sum(p["b"] ** 3),
                 ({"a": torch.from_numpy(x), "b": torch.from_numpy(w)},),
                 ({"a": torch.from_numpy(t), "b": torch.from_numpy(x)},))
    for k in ("a", "b"):
        _close(got[k], want[k])


@pytest.mark.parametrize("fn", ["exp", "tanh"])
def test_interpolate_matches_jax_and_clamps_at_the_ends(fn):
    lo, hi, n = -3.0, 2.0, 517
    f_j = jft.interpolate(lo, hi, n)(getattr(jnp, fn))
    f_t = jt.interpolate(lo, hi, n)(getattr(torch, fn))
    t = np.concatenate([np.linspace(-5.0, 4.0, 301), [lo, hi, -1e9, 1e9]])
    got = f_t(torch.from_numpy(t))
    _close(got, f_j(jnp.asarray(t)))
    assert float(got[-2]) == float(got[-4]) and float(got[-1]) == float(got[-3])


def test_default_complex_dtype():
    assert jt.config.default_complex_dtype() == torch.complex128
    assert np.dtype(jconfig.default_complex_dtype()) == np.complex128


@pytest.mark.parametrize("axes", [None, (0,), (1, 2), (-1,)])
def test_fftn_ifftn_match_jax(axes):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 8, 5)) + 1j * rng.normal(size=(6, 8, 5))
    _close(tharm.fftn(torch.from_numpy(x), axes=axes), jharm.fftn(jnp.asarray(x), axes=axes))
    _close(tharm.ifftn(torch.from_numpy(x), axes=axes), jharm.ifftn(jnp.asarray(x), axes=axes))


# -- instrumentation -----------------------------------------------------------


def _gaussian(mod, arr, data):
    fwd = mod.Model(lambda p: p["x"] * 2.0, domain={"x": mod.ShapeWithDtype((16,))})
    return mod.Gaussian(arr(data)).amend(fwd), fwd


def test_exec_time_has_the_jax_keys():
    data = np.random.default_rng(1).normal(size=16)
    lh_j, fwd_j = _gaussian(jft, jnp.asarray, data)
    lh_t, fwd_t = _gaussian(jt, torch.from_numpy, data)
    for j_obj, t_obj in ((lh_j, lh_t), (fwd_j, fwd_t)):
        want = jft.exec_time(j_obj, verbose=False, n=1)
        got = jt.exec_time(t_obj, verbose=False, n=1)
        assert list(got) == list(want)
        assert all(v > 0 for v in got.values())
    assert list(jt.exec_time(lh_t, verbose=False, n=1, want_metric=False)) == [
        "forward", "jvp", "value_and_grad"]
    pos = {"x": torch.from_numpy(data)}
    lines = _logged(lambda: jt.exec_time(lh_t, pos, key=3, n=2))
    assert [ln.split()[1] for ln in lines] == ["forward", "jvp", "value_and_grad", "metric"]


def test_counting_model_matches_jax():
    rng = np.random.default_rng(2)
    x, t = rng.normal(size=4), rng.normal(size=4)
    cm_j = jft.CountingModel(lambda v: jnp.sin(v) * 2.0, name="sky")
    cm_t = jt.CountingModel(lambda v: torch.sin(v) * 2.0, name="sky")
    for cm, arr in ((cm_j, jnp.asarray), (cm_t, torch.from_numpy)):
        cm(arr(x))
        cm(arr(x))
        cm.jvp(arr(x), arr(t))
        cm.vjp(arr(x), arr(t))
    assert cm_t.counts == cm_j.counts == {"forward": 2, "jvp": 1, "vjp": 1}
    assert cm_t.report() == cm_j.report()
    _close(cm_t.jvp(torch.from_numpy(x), torch.from_numpy(t)),
           cm_j.jvp(jnp.asarray(x), jnp.asarray(t)))
    _close(cm_t.vjp(torch.from_numpy(x), torch.from_numpy(t)),
           cm_j.vjp(jnp.asarray(x), jnp.asarray(t)))
    cm_t.reset()
    cm_j.reset()
    assert cm_t.counts == cm_j.counts and cm_t.report() == cm_j.report()
