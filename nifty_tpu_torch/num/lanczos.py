"""Lanczos tridiagonalization and stochastic Lanczos quadrature (SLQ)
(counterpart of :mod:`nifty_tpu.num.lanczos`).

The operator may act on any tree; the Krylov block is a stacked tree
(a leading ``order`` axis on every leaf) and the full reorthogonalization
is one contraction against the whole block a step, a matrix-vector
product per leaf and row on the flattened leaves.  The block starts as
zeros and is written row by row, so projecting against all of it is safe
(unwritten rows contribute nothing).

:func:`_lanczos_rows` is the one loop: it runs several probes in lockstep,
each a row of every leaf (the JAX package's ``jax.vmap`` of one probe);
:func:`lanczos_tridiag` is its row 0 on a batch of one.
"""

from __future__ import annotations

from typing import Callable, Optional, TypeVar, Union

import torch

from .. import config
from ..custom_map import vmap
from ..tree import (
    ShapeWithDtype,
    add_row,
    axpy_rows,
    first_row,
    norm_rows,
    rademacher,
    random_like,
    rows,
    scale_rows,
    size as tree_size,
    split,
    stack,
    tree_leaves,
    tree_map,
    vdot_rows,
)

V = TypeVar("V")

_BATCHED_MAPS = ("vmap", "v", vmap)


def _matvec_stack_rows(stacked, w):
    """``coeff[b, k] = <V_bk, w_b>`` summed over the leaves: a (B, order)
    tensor.  Each row is its own matrix-vector product, so a row's bits do
    not depend on how many rows run beside it (a batched product's
    blocking does)."""
    out = None
    for vs, x in zip(tree_leaves(stacked), tree_leaves(w)):
        part = torch.stack([
            torch.mv(v.reshape(v.shape[0], -1).conj(), xb.reshape(-1)) for v, xb in zip(vs, x)])
        out = part if out is None else out + part
    return out


def _block_comb_rows(stacked, coeff):
    """``sum_k coeff[b, k] V_bk`` for every row ``b``, a row at a time."""
    return tree_map(
        lambda vs: torch.stack([
            (c.to(v.dtype) @ v.reshape(v.shape[0], -1)).reshape(v.shape[1:])
            for v, c in zip(vs, coeff)]),
        stacked,
    )


def _real_dtype(tree):
    dt = None
    for leaf in tree_leaves(tree):
        r = leaf.real.dtype if leaf.is_complex() else leaf.dtype
        dt = r if dt is None else torch.promote_types(dt, r)
    return dt


def _lanczos_rows(mat: Callable, v, order: int):
    """Lanczos decompositions of ``B`` start vectors in lockstep: ``v`` is a
    batched tree (every leaf (B, ...)) and ``mat`` maps a batched tree to a
    batched tree row by row.  Returns ``(tridiag (B, order, order), vecs)``
    with ``vecs`` (B, order, ...) a leaf.

    The steps are the JAX package's, in its order: ``beta v_{j-1}`` is
    subtracted before ``alpha`` is taken (at ``j = 0`` row ``-1`` of the
    block is still zero), the last step writes no row past the end, and
    the next vector is divided by a safe ``beta``.
    """
    leaves = tree_leaves(v)
    nrows, device = leaves[0].shape[0], leaves[0].device
    rdt = _real_dtype(v)
    tridiag = torch.zeros((nrows, order, order), dtype=rdt, device=device)
    vecs = tree_map(lambda x: x.new_zeros((x.shape[0], order) + tuple(x.shape[1:])), v)
    v0 = scale_rows(1.0 / norm_rows(v), v)
    for vs, x in zip(tree_leaves(vecs), tree_leaves(v0)):
        vs[:, 0] = x
    beta = torch.zeros(nrows, dtype=rdt, device=device)
    for j in range(order):
        vj = tree_map(lambda vs: vs[:, j], vecs)
        v_prev = tree_map(lambda vs: vs[:, j - 1], vecs)
        w = axpy_rows(-beta, v_prev, mat(vj))
        alpha = vdot_rows(vj, w).real.to(rdt)
        tridiag[:, j, j] = alpha
        w = axpy_rows(-alpha, vj, w)
        coeff = _matvec_stack_rows(vecs, w)
        w = tree_map(torch.sub, w, _block_comb_rows(vecs, coeff))
        beta = norm_rows(w).to(rdt)
        if j == order - 1:
            break
        safe = torch.where(beta == 0.0, torch.ones_like(beta), beta)
        tridiag[:, j, j + 1] = beta
        tridiag[:, j + 1, j] = beta
        for vs, x in zip(tree_leaves(vecs), tree_leaves(w)):
            vs[:, j + 1] = x / rows(safe, x)
    return tridiag, vecs


def lanczos_tridiag(mat: Callable[[V], V], v: V, order: int):
    """Lanczos decomposition ``mat ≈ V^T T V`` with ``T`` tridiagonal.

    ``v`` may be a tensor or any tree; ``mat`` must be a symmetric
    (self-adjoint) operator on that tree.  Returns ``(tridiag (order,
    order), vecs)`` where ``vecs`` carries a leading Krylov axis on every
    leaf.
    """
    tridiag, vecs = _lanczos_rows(lambda t: add_row(mat(first_row(t))), add_row(v), order)
    return tridiag[0], first_row(vecs)


def stochastic_logdet_from_lanczos(tridiag_stack, matrix_shape0: int, func: Callable = torch.log):
    """SLQ estimate of ``tr func(M)`` from stacked tridiagonal matrices."""
    eig_vals, eig_vecs = torch.linalg.eigh(tridiag_stack)
    num_probes = tridiag_stack.shape[0]
    first_components = eig_vecs[..., 0, :]
    dots = torch.sum(first_components ** 2 * func(eig_vals))
    return matrix_shape0 / num_probes * dots


def stochastic_lq_tridiags(
    mat: Union[torch.Tensor, Callable],
    order: int,
    n_samples: int,
    key,
    *,
    shape0: Optional[int] = None,
    dtype=None,
    probe_like: Optional[V] = None,
    cmap="vmap",
):
    """The Lanczos tridiagonal matrices of :func:`stochastic_lq_logdet`'s
    probes, stacked (n_samples, order, order), and the operator's size."""
    if callable(mat):
        mat_fn = mat
        device = None
    else:
        mat_fn = lambda x: mat @ x  # noqa: E731
        shape0 = mat.shape[0] if shape0 is None else shape0
        dtype = mat.dtype if dtype is None else dtype
        device = mat.device
    if probe_like is None:
        if shape0 is None:
            raise ValueError("need `shape0` (array mode) or `probe_like` (tree mode)")
        probe_like = ShapeWithDtype((shape0,), dtype or config.default_float_dtype())
        device = device if device is not None else config.default_device()
    keys = split(key, n_samples)

    def probe(k):
        return random_like(k, probe_like, rng=rademacher, device=device)

    if cmap in _BATCHED_MAPS:
        tridiags, _ = _lanczos_rows(vmap(mat_fn), stack([probe(k) for k in keys]), order)
    elif cmap in ("smap", "s", "lmap", "l"):
        # each probe drawn just before its run: one Krylov block at a time
        tridiags = torch.stack([lanczos_tridiag(mat_fn, probe(k), order)[0] for k in keys])
    else:
        raise ValueError(f"unknown map {cmap!r}")
    return tridiags, tree_size(probe_like)


def stochastic_lq_logdet(mat, order: int, n_samples: int, key, **kwargs):
    """Stochastic Lanczos quadrature log-determinant of an implicit SPD
    operator (Rademacher probes, ``n_samples × order`` matvecs).

    The operator may act on tensors (give ``shape0``/``dtype``, or pass a
    matrix) or on any tree (give ``probe_like``, a tree prototype such as a
    position; probes are drawn ``random_like`` it from the sub-keys of
    ``key``).  ``cmap="vmap"`` runs the probes in lockstep, stacked as rows
    (``mat`` batched with :func:`~nifty_tpu_torch.custom_map.vmap`, so a
    linearized operator is linearized once for all of them);
    ``"smap"``/``"lmap"`` run them one after the other, for Krylov blocks
    too large to hold ``n_samples`` times.  Keywords as
    :func:`stochastic_lq_tridiags`.
    """
    return stochastic_logdet_from_lanczos(*stochastic_lq_tridiags(mat, order, n_samples, key,
                                                                  **kwargs))


__all__ = [
    "lanczos_tridiag", "stochastic_logdet_from_lanczos", "stochastic_lq_logdet",
    "stochastic_lq_tridiags",
]
