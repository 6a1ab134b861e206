"""Self-checking consistency machinery (counterpart of
:mod:`nifty_tpu.extra`): linearity, adjointness, Jacobians against finite
differences, inverses, dtype purity and the calculus of a likelihood, for
callables and models on trees of tensors.

Keys are what :func:`nifty_tpu_torch.tree.random_like` takes: int seeds,
``torch.Generator``s or noise providers such as
:class:`~nifty_tpu_torch.tree.HostKey`.  Jacobian-vector products are
forward-mode (``torch.func.jvp``); transposes are vjps (reverse mode),
which for a complex-linear map give its adjoint, so adjointness is tested
with the conjugating inner product :func:`~nifty_tpu_torch.tree.vdot`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .likelihood import Likelihood, vjp
from .tree import (
    ShapeWithDtype,
    random_like,
    split,
    tree_add,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_unflatten,
    vdot,
)


def _shapes(proto):
    return tree_map(
        lambda x: x if isinstance(x, ShapeWithDtype) else ShapeWithDtype.from_leave(x), proto)


def _rand(key, proto):
    return random_like(key, _shapes(proto))


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


def _with_dtype(proto, dtype):
    """The shapes of ``proto`` with every leaf's dtype replaced; complex
    leaves stay complex at the requested precision."""
    want = _dtype(dtype)

    def leaf(sd):
        dt = want
        if sd.dtype.is_complex and not want.is_complex:
            dt = torch.promote_types(want, torch.complex64)
        return ShapeWithDtype(sd.shape, dt)

    return tree_map(leaf, _shapes(proto))


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _allclose(got, want, rtol, atol, err_msg):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(_numpy(a), _numpy(b), rtol=rtol, atol=atol, err_msg=err_msg)


def _jvp(f, x, t):
    """``(f(x), J t)`` by forward-mode AD over the leaves of ``x``."""
    like = {}

    def flat(*leaves):
        out = f(tree_unflatten(x, leaves))
        like["out"] = out
        return tuple(tree_leaves(out))

    y, jt = torch.func.jvp(flat, tuple(tree_leaves(x)), tuple(tree_leaves(t)))
    return tree_unflatten(like["out"], list(y)), tree_unflatten(like["out"], list(jt))


def assert_equal_tree(a, b, err_msg="trees differ"):
    """Bitwise equality of two trees."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), f"{err_msg}: different structures"
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(_numpy(u), _numpy(v), err_msg=err_msg)


def check_purity(f: Callable, x, *, err_msg="operator is impure"):
    """Applying ``f`` twice to the same input gives bitwise equal results
    (no hidden state, caches or random numbers inside a model)."""
    assert_equal_tree(f(x), f(x), err_msg=err_msg)
    return True


def check_dtype_purity(f: Callable, domain, key, *, dtypes=("float32", "float64"),
                       expected=None):
    """For each input dtype every output leaf has the expected dtype
    (default: the input's, no silent up- or down-casting).  ``expected`` is
    a dtype, a function of the input dtype, or ``None``."""
    for dt in dtypes:
        x = _rand(key, _with_dtype(domain, dt))
        out = f(x)
        want = _dtype(expected(dt) if callable(expected) else (expected or dt))
        for leaf in tree_leaves(out):
            assert leaf.dtype == want, (
                f"dtype purity violated: input {dt} -> output {leaf.dtype}, expected {want}")
    return True


def check_inverse(f: Callable, inverse: Callable, domain, key, *, target=None,
                  rtol: float = 1e-9, atol: float = 1e-11):
    """Round trips ``inverse(f(x)) == x`` and ``f(inverse(y)) == y``."""
    k1, k2 = split(key, 2)
    x = _rand(k1, domain)
    fx = f(x)
    _allclose(inverse(fx), x, rtol, atol, "inverse(f(x)) != x")
    y = _rand(k2, fx if target is None else target)
    _allclose(f(inverse(y)), y, rtol, atol, "f(inverse(y)) != y")
    return True


def check_linear_model(f: Callable, domain, key, *, target=None, rtol: float = 1e-9,
                       atol: float = 1e-11, assert_adjoint: bool = True,
                       inverse: "Callable | None" = None, dtypes=None,
                       assert_purity: bool = False):
    """``f`` is linear: additive and homogeneous, equal to its own jvp, and
    its transpose (the vjp) is its adjoint, ``<f x, y> == <x, f^T y>``.

    ``inverse`` adds the round trips, ``dtypes`` reruns the checks for each
    input dtype and asserts the outputs keep it, ``assert_purity`` asserts
    that two applications are bitwise equal.
    """
    if dtypes is not None:
        for dt in dtypes:
            check_linear_model(
                f, _with_dtype(domain, dt), key, target=target, rtol=rtol, atol=atol,
                assert_adjoint=assert_adjoint, inverse=inverse, dtypes=None,
                assert_purity=assert_purity,
            )
        check_dtype_purity(f, domain, key, dtypes=dtypes)
        return True

    k1, k2, k3 = split(key, 3)
    x = _rand(k1, domain)
    y = _rand(k2, domain)
    if assert_purity:
        check_purity(f, x)
    if inverse is not None:
        check_inverse(f, inverse, domain, key, target=target, rtol=10 * rtol, atol=10 * atol)

    fx, fy = f(x), f(y)
    lhs = f(tree_add(tree_scale(x, 2.0), y))
    rhs = tree_map(lambda a, b: 2.0 * a + b, fx, fy)
    _allclose(lhs, rhs, rtol, atol, "linearity violated")
    _, jx = _jvp(f, x, x)
    _allclose(fx, jx, rtol, atol, "f != jvp(f) for linear f")
    if assert_adjoint:
        cot = _rand(k3, fx)
        _, f_t = vjp(f, x)
        np.testing.assert_allclose(
            _numpy(vdot(fx, cot)), _numpy(vdot(x, f_t(cot))), rtol=10 * rtol,
            err_msg="adjointness (transposition) violated",
        )
    return True


def check_model(f: Callable, domain, key, *, step: float = 1e-6, rtol: float = 1e-4,
                atol: float = 1e-6, adjoint_rtol: float = 1e-8, assert_purity: bool = False):
    """The Jacobian of a (nonlinear) ``f`` against central finite
    differences along a random direction, and its jvp against its vjp."""
    k1, k2 = split(key, 2)
    x = _rand(k1, domain)
    t = _rand(k2, domain)
    if assert_purity:
        check_purity(f, x)
    _, jt = _jvp(f, x, t)
    fp = f(tree_add(x, tree_scale(t, step)))
    fm = f(tree_add(x, tree_scale(t, -step)))
    fd = tree_map(lambda a, b: (a - b) / (2 * step), fp, fm)
    _allclose(jt, fd, rtol, atol, "Jacobian vs FD mismatch")
    y, f_t = vjp(f, x)
    cot = _rand(key, y)
    np.testing.assert_allclose(
        _numpy(vdot(jt, cot)), _numpy(vdot(t, f_t(cot))), rtol=adjoint_rtol,
        err_msg="jvp/vjp adjointness violated",
    )
    return True


def check_likelihood(lh: Likelihood, key, *, rtol: float = 1e-8, atol: float = 1e-10,
                     check_metric_root: bool = True):
    """A likelihood's calculus: ``metric == lsm o rsm`` (with
    ``check_metric_root``), ``lsm`` and ``rsm`` adjoint, the metric
    symmetric and positive semi-definite."""
    k1, k2, k3 = split(key, 3)
    p = _rand(k1, lh.domain)
    t = _rand(k2, lh.domain)
    u = random_like(k3, lh.lsm_tangents_shape)

    if check_metric_root:
        m1 = lh.metric(p, t)
        m2 = lh.left_sqrt_metric(p, lh.right_sqrt_metric(p, t))
        _allclose(m1, m2, rtol, atol, "metric != lsm o rsm")
    lhs = vdot(lh.left_sqrt_metric(p, u), t)
    rhs = vdot(u, lh.right_sqrt_metric(p, t))
    np.testing.assert_allclose(_numpy(lhs.real), _numpy(rhs.real), rtol=1e-7,
                               err_msg="lsm/rsm not adjoint")
    s = _rand(key, lh.domain)
    sym1 = vdot(s, lh.metric(p, t))
    sym2 = vdot(t, lh.metric(p, s))
    np.testing.assert_allclose(_numpy(sym1.real), _numpy(sym2.real), rtol=1e-7,
                               err_msg="metric not symmetric")
    quad = vdot(t, lh.metric(p, t)).real
    assert float(quad) >= -atol, "metric not PSD"
    return True


__all__ = [
    "assert_equal_tree", "check_dtype_purity", "check_inverse", "check_likelihood",
    "check_linear_model", "check_model", "check_purity",
]
