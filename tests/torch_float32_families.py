"""What ``tests/test_torch_float32_families_*.py`` share: holding a family's
forward, jvp, vjp, Gaussian metric matvec and a 5-step CG solve against
the JAX package with x64 off, and a dispatch mode that names the function
of the port that made each tensor of the other precision.

Every family is held at ``test_torch_float32.py``'s tolerances (PR 19's
policy): the forward, its jvp and vjp and the likelihood's energy within
``FIELD_RTOL`` (1e-5) of the largest |value|, the metric matvec and the
CG solve within ``METRIC_RTOL`` (1e-4), both packages given the same
float32 numpy inputs from a seed.
"""

from __future__ import annotations

import sys
from collections import Counter

import jax
import numpy as np
import torch
from jax import numpy as jnp

import nifty_tpu as jft
import nifty_tpu_torch as jt
from nifty_tpu.solvers.cg import _static_cg as j_cg
from nifty_tpu_torch import config
from nifty_tpu_torch.likelihood import linearize
from nifty_tpu_torch.solvers.cg import _static_cg as t_cg
from test_torch_float32 import FIELD_RTOL, METRIC_RTOL, _close, _Dtypes, f32  # noqa: F401

#: one update's budgets: 2 pairs, CG of 5 steps (as ``test_torch_float32.py``)
SHORT = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)

OTHER = {False: (torch.float64, torch.complex128), True: (torch.float32, torch.complex64)}


def draw(shapes, seed, scale=1.0):
    """float32 standard normals shaped like a JAX domain (a tree of
    ``ShapeDtypeStruct``), complex64 where a leaf is complex."""
    rng = np.random.default_rng(seed)

    def one(s):
        x = scale * rng.standard_normal(tuple(s.shape))
        if jnp.issubdtype(s.dtype, jnp.complexfloating):
            x = x + 1j * scale * rng.standard_normal(tuple(s.shape))
            return x.astype(np.complex64)
        return x.astype(np.float32)

    return jax.tree_util.tree_map(one, shapes)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def target_of(model_j, lat):
    return jax.eval_shape(model_j, to_jax(lat))


def hold_model(model_j, model_t, seed=0, scale=1.0):
    """The port's forward, jvp and vjp of ``model_t`` against ``model_j``'s
    (jitted) at one float32 point; returns the point."""
    lat, tan = draw(model_j.domain, seed, scale), draw(model_j.domain, seed + 1)
    cot = draw(target_of(model_j, lat), seed + 2)
    pj, tj, cj = to_jax(lat), to_jax(tan), to_jax(cot)
    pt = jt.from_numpy(lat)
    assert all(x.dtype == torch.float32 for x in jt.tree.tree_leaves(pt))
    _close(model_t(pt), jax.jit(model_j)(pj), FIELD_RTOL)
    tan_j = jax.jit(lambda p, t: jax.jvp(model_j, (p,), (t,))[1])(pj, tj)
    cot_j = jax.jit(lambda p, c: jax.vjp(model_j, p)[1](c)[0])(pj, cj)
    _, fwd, bwd = linearize(model_t, pt)
    _close(fwd(jt.from_numpy(tan)), tan_j, FIELD_RTOL)
    # a complex output's pull-back: PyTorch's takes the conjugate of the
    # cotangent JAX's vjp takes
    _close(bwd(jt.tree.tree_map(lambda c: c.conj() if c.is_complex() else c,
                                jt.from_numpy(cot))), cot_j, FIELD_RTOL)
    return lat


def gaussians(model_j, model_t, seed, noise=0.1):
    """Gaussian likelihoods of both packages on data of the JAX model at a
    float32 point from ``seed``, with noise ``noise`` times the data's rms
    (numpy, from the seed)."""
    truth = np.asarray(jax.jit(model_j)(to_jax(draw(model_j.domain, seed))))
    sigma = noise * float(np.sqrt(np.mean(np.abs(truth) ** 2)))
    rng = np.random.default_rng(seed + 1)
    n = rng.standard_normal(truth.shape)
    if np.iscomplexobj(truth):
        n = n + 1j * rng.standard_normal(truth.shape)
    data = (truth + sigma * n).astype(truth.dtype)
    lh_j = jft.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / sigma ** 2).amend(model_j)
    lh_t = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / sigma ** 2
                       ).amend(model_t)
    return lh_j, lh_t


def hold_likelihood(lh_j, lh_t, seed=10, scale=1.0):
    """The energy within ``FIELD_RTOL``, a metric matvec and five CG steps
    on the geoVI draw's curvature ``M + 1`` within ``METRIC_RTOL``, with
    the same step count and stop flag."""
    lat, tan = draw(lh_j.domain, seed, scale), draw(lh_j.domain, seed + 1)
    pj, tj, pt = to_jax(lat), to_jax(tan), jt.from_numpy(lat)
    _close(lh_t(pt), jax.jit(lh_j)(pj), FIELD_RTOL)
    met_j = jax.jit(lh_j.metric)
    _close(lh_t.metric(pt, jt.from_numpy(tan)), met_j(pj, tj), METRIC_RTOL)
    met_t = lh_t.metric_at(pt)
    rj = j_cg(lambda x: jax.tree_util.tree_map(jnp.add, met_j(pj, x), x), tj, maxiter=5)
    rt = t_cg(lambda x: jt.tree.tree_add(met_t(x), x), jt.from_numpy(tan), maxiter=5)
    assert (rt.nit, rt.info) == (int(rj.nit), int(rj.info))
    _close(rt.x, rj.x, METRIC_RTOL)


def _owner():
    """``module.function`` of the innermost frame of the port on the
    stack, or ``"outside the port"``."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_globals.get("__name__", "")
        if name.startswith("nifty_tpu_torch"):
            return f"{name}.{frame.f_code.co_qualname}"
        frame = frame.f_back
    return "outside the port"


class Owners(_Dtypes):
    """``_Dtypes`` that also counts, by the port's function that made it,
    every tensor of the dtypes ``other``."""

    def __init__(self, other):
        super().__init__()
        self.other, self.owners = tuple(other), Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for o in torch.utils._pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor) and o.dtype in self.other:
                self.owners[_owner()] += 1
        return out


def record(run, x64, allow=None):
    """Run ``run()`` with ``enable_x64`` at ``x64`` under :class:`Owners`;
    fails if a tensor of the other precision was made by a function that is
    not in ``allow`` (``{"module.function": why}``), or if no tensor of the
    run's own precision was.  Returns the recorder."""
    rec = Owners(OTHER[x64])
    config.update("enable_x64", x64)
    try:
        with rec:
            run()
    finally:
        config.update("enable_x64", True)
    bad = {k: n for k, n in rec.owners.items() if k not in (allow or {})}
    assert not bad, f"tensors of the other precision by the function that made them: {bad}"
    assert rec.seen[torch.float64 if x64 else torch.float32] > 0
    return rec


def one_update(lh, pos=None, rmap="vmap"):
    """One ``OptimizeVI.update`` of ``lh`` with the short budgets; returns
    the samples and the state."""
    opt = jt.OptimizeVI(lh, 1, residual_map=rmap)
    pos = jt.random_like(1, lh.domain) if pos is None else pos
    return opt.update(jt.Samples(pos=pos), opt.init_state(jt.HostKey(0), **SHORT))
