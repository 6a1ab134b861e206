"""The port's tree norms of any order and its ``random_like(..., rng=)``.

``tree.norm`` / ``norm_rows`` against ``nifty_tpu.tree.norm`` on float64
trees made with numpy, within 1e-12 relative (the same sums, each package
in its own order): orders 1, 2, 3, 0.5, -1 and inf, ``ravel`` False and
True, two and three leaves, one row and several.  CG's ``norm_ord`` takes
those orders too (against the JAX package's CG at 1e-10, as in
``test_torch_solvers.py``).

``random_like`` with :func:`~nifty_tpu_torch.tree.rademacher` by moments,
since the two packages' generators differ: values in {-1, +1}, the mean
within 4 standard errors of 0, the second moment exactly 1 (complex
leaves: ``(re + i im) / sqrt(2)`` of two draws, so ``|z|^2`` is exactly 1
and the real and imaginary parts are uncorrelated); a ``HostKey`` draws
the same numbers whatever the target device; the default ``rng`` gives
the bits of ``torch.randn`` on the key's generator, as it did before
``rng`` was added.
"""

import numpy as np
import pytest
from jax import numpy as jnp

torch = pytest.importorskip("torch")

import nifty_tpu.tree as jtree  # noqa: E402
import nifty_tpu_torch as jt  # noqa: E402
import nifty_tpu_torch.tree as tt  # noqa: E402
from nifty_tpu.solvers.cg import _static_cg as j_cg  # noqa: E402
from nifty_tpu_torch.solvers.cg import _static_cg as t_cg  # noqa: E402

ORDS = [1, 2, 3, 0.5, -1, np.inf]


@pytest.fixture(scope="module", autouse=True)
def _on_cpu():
    """These tests run on the CPU; the port's default device is the card."""
    old = jt.config.get("device")
    jt.config.update("device", "cpu")
    yield
    jt.config.update("device", old)


def _tree(nleaves, nrows, seed):
    """``nrows`` rows of a tree of ``nleaves`` leaves of assorted shapes."""
    rng = np.random.default_rng(seed)
    shapes = [(7,), (3, 4), (2, 3, 2)][:nleaves]
    return {f"x{k}": rng.standard_normal((nrows,) + s) + 0.1 for k, s in enumerate(shapes)}


def test_the_reference_values():
    tree = {"a": torch.tensor([1.0, 2, 3, 4], dtype=torch.float64),
            "b": torch.tensor([2.0, 3], dtype=torch.float64)}
    for ord_, ravel, want in [(3, False, 5.12992784003009), (0.5, False, 86.35109038156911),
                              (-1, False, 0.3428571428571429), (2, True, 6.557438524302),
                              (3, True, 5.12992784003009), (np.inf, True, 1.0)]:
        np.testing.assert_allclose(float(tt.norm(tree, ord_, ravel=ravel)), want, rtol=1e-12)


@pytest.mark.parametrize("ord_", ORDS, ids=[str(o) for o in ORDS])
@pytest.mark.parametrize("ravel", [False, True], ids=["tree", "ravel"])
@pytest.mark.parametrize("nleaves", [2, 3])
def test_norm_matches_the_reference(ord_, ravel, nleaves):
    tree = {k: v[0] for k, v in _tree(nleaves, 1, seed=nleaves).items()}
    want = float(jtree.norm({k: jnp.asarray(v) for k, v in tree.items()}, ord_, ravel=ravel))
    got = float(tt.norm({k: torch.from_numpy(v) for k, v in tree.items()}, ord_, ravel=ravel))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("ord_", ORDS, ids=[str(o) for o in ORDS])
@pytest.mark.parametrize("ravel", [False, True], ids=["tree", "ravel"])
@pytest.mark.parametrize("nrows", [1, 4])
def test_norm_rows_match_the_reference_row_by_row(ord_, ravel, nrows):
    tree = _tree(3, nrows, seed=10 + nrows)
    got = tt.norm_rows({k: torch.from_numpy(v) for k, v in tree.items()}, ord_, ravel=ravel)
    assert got.shape == (nrows,)
    for b in range(nrows):
        want = float(jtree.norm({k: jnp.asarray(v[b]) for k, v in tree.items()}, ord_,
                                ravel=ravel))
        np.testing.assert_allclose(float(got[b]), want, rtol=1e-12)


def test_deterministic_reductions_keep_their_routes():
    tree = {k: torch.from_numpy(v) for k, v in _tree(2, 3, seed=5).items()}
    old = jt.config.get("deterministic_reductions")
    try:
        for det in (False, True):
            jt.config.update("deterministic_reductions", det)
            for ord_ in (1, 2):
                got = tt.norm_rows(tree, ord_)
                ravelled = tt.norm_rows(tree, ord_, ravel=True)
                torch.testing.assert_close(got, ravelled, rtol=1e-12, atol=0)
    finally:
        jt.config.update("deterministic_reductions", old)


@pytest.mark.parametrize("norm_ord", [3, 0.5])
def test_cg_takes_any_norm_order(norm_ord):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((30, 30))
    a = a @ a.T / 30 + np.eye(30)
    b = rng.standard_normal(30)
    rj = j_cg(lambda x: jnp.asarray(a) @ x, jnp.asarray(b), norm_ord=norm_ord, tol=1e-6)
    rt = t_cg(lambda x: torch.from_numpy(a) @ x, torch.from_numpy(b), norm_ord=norm_ord, tol=1e-6)
    assert (rt.nit, rt.info) == (int(rj.nit), int(rj.info))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())


SHAPES = {"r": tt.ShapeWithDtype((4000,), torch.float64),
          "s": tt.ShapeWithDtype((50, 40), torch.float32),
          "z": tt.ShapeWithDtype((3000,), torch.complex128)}


@pytest.mark.parametrize("key", [3, "generator", "host"])
def test_rademacher_draws_by_moments(key):
    key = {"generator": torch.Generator().manual_seed(3), "host": jt.HostKey(3)}.get(key, key)
    draws = tt.random_like(key, SHAPES, tt.rademacher, device="cpu")
    for name, x in draws.items():
        assert x.dtype == SHAPES[name].dtype and tuple(x.shape) == SHAPES[name].shape
        if x.dtype.is_complex:
            parts = (x.real * np.sqrt(2.0), x.imag * np.sqrt(2.0))
            torch.testing.assert_close(x.abs() ** 2, torch.ones_like(x.real), rtol=1e-15, atol=0)
            corr = float((parts[0] * parts[1]).mean())
            assert abs(corr) < 4 / np.sqrt(x.numel())
        else:
            parts = (x,)
        for p in parts:
            assert set(torch.unique(p.round()).tolist()) == {-1.0, 1.0}
            torch.testing.assert_close(p.round(), p, rtol=0, atol=1e-12)
            assert abs(float(p.double().mean())) < 4 / np.sqrt(p.numel())
            assert float((p.double() ** 2).mean()) == pytest.approx(1.0, abs=1e-12)


def test_host_key_draws_on_the_host_whatever_the_target():
    """A HostKey's draws are its host generator's, copied: the card's path
    (a move after the draw) sees the numbers the CPU's does."""
    shape = {"a": tt.ShapeWithDtype((64,), torch.float64),
             "b": tt.ShapeWithDtype((8, 8), torch.complex128)}
    host = tt.random_like(jt.HostKey(11), shape, tt.rademacher, device="cpu")
    gen = torch.Generator().manual_seed(11)
    want = tt.random_like(gen, shape, tt.rademacher, device="cpu")
    again = jt.HostKey(11).draw(shape, tt.rademacher, device=torch.device("cpu"))
    for k in shape:
        assert torch.equal(host[k], want[k]) and torch.equal(again[k], want[k])
    with pytest.raises(TypeError, match="draw"):
        class Provider:
            def split(self, num):
                return [self] * num

            def normal(self, primals, device=None):
                return primals

        tt.random_like(Provider(), shape, tt.rademacher)


def test_the_default_draws_keep_their_bits():
    shape = {"a": tt.ShapeWithDtype((33,), torch.float64),
             "z": tt.ShapeWithDtype((5, 3), torch.complex128)}
    for key in (7, jt.HostKey(7)):
        got = tt.random_like(key, shape, device="cpu")
        gen = torch.Generator().manual_seed(7)
        a = torch.randn((33,), dtype=torch.float64, generator=gen)
        re = torch.randn((5, 3), dtype=torch.float64, generator=gen)
        im = torch.randn((5, 3), dtype=torch.float64, generator=gen)
        assert torch.equal(got["a"], a)
        assert torch.equal(got["z"], torch.complex(re, im) / np.sqrt(2.0))
        assert all(torch.equal(got[k], v) for k, v in
                   tt.random_like(key, shape, tt.normal, device="cpu").items())
