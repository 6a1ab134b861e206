"""Posterior-residual sanity report (counterpart of
:mod:`nifty_tpu.minisanity`, with its output format).

For every leaf of a (possibly transformed) latent tree this computes the
reduced chi-squared and the entry average of the residuals: the quick "is
the fit statistically sane" readout printed each VI iteration.  When
posterior samples are given, the per-sample statistics are summarized by
their sample mean and spread.  The report is one aligned, path-labelled
table.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import tree
from .evi import Samples
from .tree import Vector, get_map, tree_leaves, tree_map, tree_unflatten


class ChiSqStats(NamedTuple):
    """Summary statistics of one residual leaf.

    ``mean`` and ``reduced_chisq`` are length-2 tensors holding the average
    and the standard deviation over posterior samples (the latter is zero
    when only a single position was supplied); ``ndof`` counts real degrees
    of freedom (complex entries count twice).
    """

    mean: Any
    reduced_chisq: Any
    ndof: Any


def _leaf_stats(batched_leaf):
    """Per-sample (mean, reduced chi^2, dof) of one leaf along its leading
    sample axis."""
    n = batched_leaf[0].numel()
    dof = n * (2 if batched_leaf.is_complex() else 1)
    flat = batched_leaf.reshape(batched_leaf.shape[0], -1)
    avg = flat.sum(dim=1) / n
    chisq = (flat.abs() ** 2).sum(dim=1) / dof
    return avg, chisq, dof


def _as_stacked_tree(position_or_samples, func, map):
    """``func`` applied over a leading sample axis (size >= 1)."""
    if isinstance(position_or_samples, Samples) and len(position_or_samples):
        batch = position_or_samples.samples
    else:
        pos = position_or_samples
        if isinstance(pos, Samples):
            pos = pos.pos
        batch = tree_map(lambda x: x[None], pos)
    return map(func)(batch) if func is not None else batch


def reduced_residual_stats(position_or_samples, func=None, *, map="vmap"):
    """Per-leaf :class:`ChiSqStats` of ``func(x)``, averaged over samples.

    ``position_or_samples`` is a latent tree or a :class:`Samples`
    container; ``func`` (e.g. ``likelihood.normalized_residual``) is applied
    to each sample before the statistics are taken.
    """
    map = get_map(map)
    with torch.no_grad():
        batch = _as_stacked_tree(position_or_samples, func, map)
        if tree._MESH[0] is not None:
            return _mesh_stats(batch, tree._MESH[0])

        def summarize(batched_leaf):
            avg, chisq, dof = _leaf_stats(batched_leaf)

            def over_samples(v):
                return torch.stack([v.mean(), v.std(correction=0)])

            return ChiSqStats(over_samples(avg), over_samples(chisq), dof)

        return tree_map(summarize, batch)


def _mesh_stats(batch, mesh):
    """:func:`reduced_residual_stats` of a rank's stacked rows on a mesh:
    the entry sums of field-sharded leaves reduce over the field group,
    the per-sample statistics are gathered over the samples group, so
    every rank holds the global table."""
    from .parallel import collectives as coll

    leaves = tree_leaves(batch)
    flags = mesh.field_flags(batch, len(leaves))
    fg, sg = mesh.group(mesh.field_axis), mesh.group(mesh.sample_axis)
    out = []
    for leaf, sharded in zip(leaves, flags):
        n = leaf[0].numel() * (mesh.size(mesh.field_axis) if sharded else 1)
        dof = n * (2 if leaf.is_complex() else 1)
        flat = leaf.reshape(leaf.shape[0], -1)
        sums, squares = flat.sum(dim=1), (flat.abs() ** 2).sum(dim=1)
        if sharded:
            sums, squares = coll.all_reduce(sums, fg), coll.all_reduce(squares, fg)
        avg = coll.all_gather(sums / n, sg)
        chisq = coll.all_gather(squares / dof, sg)
        out.append(ChiSqStats(*(torch.stack([v.mean(), v.std(correction=0)])
                                for v in (avg, chisq)), dof))
    return tree_unflatten(batch, out)


def _flatten_with_labels(node, prefix=""):
    """``(label, ChiSqStats)`` pairs; a label joins the dict keys and
    sequence indices on the way to the leaf."""
    if isinstance(node, ChiSqStats):
        return [(prefix, node)]
    if isinstance(node, Vector):
        return _flatten_with_labels(node.tree, prefix)
    if isinstance(node, dict):
        items = [(str(k), node[k]) for k in sorted(node)]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), c) for i, c in enumerate(node)]
    elif node is None:
        return []
    else:
        raise TypeError(f"unexpected node {type(node)!r} in a tree of statistics")
    return [pair for k, c in items for pair in _flatten_with_labels(c, prefix + k)]


def _label(txt: str) -> str:
    for ch in "[]'\"":
        txt = txt.replace(ch, "")
    return txt.lstrip(".") or "<root>"


def _render_table(rows) -> str:
    header = ("", "reduced χ²", "mean", "# dof")
    cells = [header]
    for label, st in rows:
        rc, mn = st.reduced_chisq, st.mean
        cells.append((
            label,
            f"{float(rc[0]):.2g} ± {float(rc[1]):.2g}",
            f"{float(mn[0].real):+.2g} ± {float(mn[1]):.2g}",
            f"{int(st.ndof)}",
        ))
    widths = [max(len(r[i]) for r in cells) for i in range(4)]
    lines = []
    for r in cells:
        lines.append(
            f"  {r[0]:<{widths[0]}}  {r[1]:>{widths[1]}}"
            f"  {r[2]:>{widths[2]}}  {r[3]:>{widths[3]}}"
        )
    return "\n".join(lines)


def minisanity(position_or_samples, func=None, *, map="vmap"):
    """Return ``(stats_tree, table_string)`` for the iteration log."""
    stats = reduced_residual_stats(position_or_samples, func=func, map=map)
    rows = sorted(
        ((_label(lbl), st) for lbl, st in _flatten_with_labels(stats)),
        key=lambda r: r[0],
    )
    return stats, _render_table(rows)


__all__ = ["ChiSqStats", "minisanity", "reduced_residual_stats"]
