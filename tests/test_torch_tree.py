"""Parity of the port's tree math (``nifty_tpu_torch.tree``) with
``nifty_tpu.tree``, and the port's explicit-key random numbers.

Tolerances: with ``deterministic_reductions`` the fold-halving order is a
function of the shape alone, so 1-D leaves reduce bitwise alike in both
packages; leaves of more dimensions first sum their trailing axes per
row, which XLA and PyTorch may associate differently (1e-15 relative).
The default mode leaves the order to each library (1e-13 relative).
"""

import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.config as jconfig  # noqa: E402
import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch.config as tconfig  # noqa: E402
import nifty_tpu_torch.tree as ttree  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(params=[False, True], ids=["default", "deterministic"])
def det_mode(request):
    old_j = jconfig.get("deterministic_reductions")
    old_t = tconfig.get("deterministic_reductions")
    jconfig.update("deterministic_reductions", request.param)
    tconfig.update("deterministic_reductions", request.param)
    yield request.param
    jconfig.update("deterministic_reductions", old_j)
    tconfig.update("deterministic_reductions", old_t)


def _trees(seed, shapes):
    rng = np.random.default_rng(seed)
    a = {k: rng.standard_normal(s) for k, s in shapes.items()}
    b = {k: rng.standard_normal(s) for k, s in shapes.items()}
    return a, b


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("ord", [1, 2, np.inf], ids=["l1", "l2", "linf"])
def test_vdot_and_norm_match_jax(det_mode, ord):
    shapes = {"xi": (37, 5), "slope": (), "spectrum": (13, 2), "w": (1001,)}
    a, b = _trees(0, shapes)
    rtol = 1e-15 if det_mode else 1e-13
    got = float(ttree.vdot(ttree.from_numpy(a), ttree.from_numpy(b)))
    want = float(jtree.vdot(_jax(a), _jax(b)))
    np.testing.assert_allclose(got, want, rtol=rtol)
    got_n = float(ttree.norm(ttree.from_numpy(a), ord=ord))
    want_n = float(jtree.norm(_jax(a), ord=ord))
    np.testing.assert_allclose(got_n, want_n, rtol=rtol)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1023])
def test_fold_halving_sum_is_bitwise_the_jax_order(n):
    z = 1e3 * np.random.default_rng(n).standard_normal(n)
    got = ttree._fold_halving_sum(torch.from_numpy(z)).item()
    want = float(jtree._fold_halving_sum(jnp.asarray(z)))
    assert got == want


def test_vector_arithmetic_matches_jax():
    a, b = _trees(1, {"x": (4, 3), "y": (5,)})
    va, vb = ttree.Vector(ttree.from_numpy(a)), ttree.Vector(ttree.from_numpy(b))
    ja, jb = jtree.Vector(_jax(a)), jtree.Vector(_jax(b))
    cases = [
        (va + vb, ja + jb), (va - vb, ja - jb), (va * vb, ja * jb),
        (va / vb, ja / jb), (2.0 - va, 2.0 - ja), (3.0 * va, 3.0 * ja),
        (1.0 / vb, 1.0 / jb), (-va, -ja), (abs(va), abs(ja)), (va ** 2, ja ** 2),
    ]
    for got, want in cases:
        assert isinstance(got, ttree.Vector)
        for k in a:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert va.size == 17
    assert ttree.size({**ttree.from_numpy(a), "z": ttree.ShapeWithDtype((2, 2))}) == 21


def test_tree_helpers():
    a, b = _trees(2, {"x": (3, 2), "y": ()})
    ta, tb = ttree.from_numpy(a), ttree.from_numpy(b)
    np.testing.assert_array_equal(
        ttree.tree_axpy(0.5, ta, tb)["x"].numpy(), np.asarray(jtree.tree_axpy(0.5, _jax(a), _jax(b))["x"])
    )
    assert ttree.where(True, ta, tb) is ta and ttree.where(False, ta, tb) is tb
    sel = ttree.where(torch.tensor(False), ta, tb)
    assert torch.equal(sel["x"], tb["x"]) and torch.equal(sel["y"], tb["y"])
    mask = {"x": ta["x"] > 0, "y": torch.tensor(True)}
    picked = ttree.where(mask, ta, tb)
    assert torch.equal(picked["x"], torch.where(mask["x"], ta["x"], tb["x"]))
    stacked = ttree.stack([ta, tb])
    assert stacked["x"].shape == (2, 3, 2) and stacked["y"].shape == (2,)
    back = ttree.unstack(stacked)
    assert len(back) == 2 and torch.equal(back[1]["x"], tb["x"])
    zeros = ttree.zeros_like({"x": ttree.ShapeWithDtype((2,)), "y": ta["y"]})
    assert zeros["x"].dtype == torch.float64 and float(zeros["y"]) == 0.0
    assert ttree.tree_leaves({"b": 1, "a": [2, None, 3]}) == [2, 3, 1]  # sorted keys


def test_random_keys_are_explicit_and_reproducible():
    like = {"xi": ttree.ShapeWithDtype((4, 3)), "c": ttree.ShapeWithDtype((2,), torch.complex128)}
    first, again = ttree.random_like(5, like), ttree.random_like(5, like)
    assert torch.equal(first["xi"], again["xi"]) and torch.equal(first["c"], again["c"])
    assert first["c"].dtype == torch.complex128 and first["xi"].shape == (4, 3)
    gen = torch.Generator().manual_seed(5)
    d1, d2 = ttree.random_like(gen, like), ttree.random_like(gen, like)
    assert not torch.equal(d1["xi"], d2["xi"])  # a generator is drawn from in place
    k1, k2 = ttree.split(3, 2)
    assert k1 != k2 and ttree.split(3, 2) == [k1, k2]
    host = ttree.HostKey(9)
    h1, h2 = host.split(2)
    assert torch.equal(h1.normal(like)["xi"], ttree.random_like(h1, like)["xi"])
    assert not torch.equal(h1.normal(like)["xi"], h2.normal(like)["xi"])


def test_get_map_names():
    from nifty_tpu_torch.custom_map import lmap, smap

    for name in ("vmap", "v", "smap", "s"):
        assert ttree.get_map(name) is smap
    assert ttree.get_map("lmap") is lmap and ttree.get_map(len) is len
    with pytest.raises(ValueError):
        ttree.get_map("pmap")
    doubled = ttree.get_map("smap")(lambda x, c: {"a": 2 * x["a"] + c}, in_axes=(0, None))(
        {"a": torch.arange(3.0)}, 1.0
    )
    assert torch.equal(doubled["a"], torch.tensor([1.0, 3.0, 5.0]))
