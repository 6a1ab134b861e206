"""MGVI/geoVI variational inference (counterpart of
:mod:`nifty_tpu.optimize_kl`).

``OptimizeVI.update`` runs one iteration in three stages: an antithetic
linear (MGVI) draw per sample key, the geoVI nonlinear update of every
residual, and a Newton-CG minimization of the sample-averaged KL.  The
per-sample stages are a loop over samples whatever ``residual_map`` says
(``"vmap"`` included), because the solvers' stopping rules are
data-dependent.  The KL energy, gradient and metric have no control flow:
with ``kl_map="vmap"`` the samples are stacked along a leading axis and
the model runs once for all of them (the distributor kernels then see one
table row per sample); with ``"smap"`` they are a loop.  Either way each
Newton step linearizes the metric once.  The JAX package's fused/staged
program split, orbax checkpoints and program-size thresholds are XLA
decisions with no counterpart here.
"""

from __future__ import annotations

import dataclasses
import inspect
from functools import partial
from typing import Any, Callable, Literal, NamedTuple, Optional

import torch

from . import config
from .evi import Samples, draw_linear_residual, nonlinearly_update_residual
from .likelihood import Likelihood, value_and_grad
from .logger import logger
from .model import LazyModel
from .solvers.newton_cg import OptimizeResults, _newton_cg
from .tree import get_map, split, stack, tree_add, tree_map, vdot
from .tree import size as tree_size


def _pairwise_mean(x):
    """Fixed-order binary-tree mean along axis 0 (mesh-free analog of the
    JAX package's ``pairwise_mean``)."""
    n0 = x.shape[0]
    n = n0
    while n > 1:
        m = n // 2
        x = torch.cat([x[0:2 * m:2] + x[1:2 * m:2], x[2 * m:]], dim=0)
        n = x.shape[0]
    return x[0] / n0


def _reduce(tree):
    """Sample mean of a stacked tree; a fixed pairwise tree under
    ``deterministic_reductions``."""
    if config.get("deterministic_reductions"):
        return tree_map(_pairwise_mean, tree)
    return tree_map(lambda x: x.mean(dim=0), tree)


class _StandardHamiltonian(LazyModel):
    """Likelihood + standard-normal prior energy (the standardized
    posterior negative log-density)."""

    def __init__(self, likelihood: Likelihood, /):
        super().__init__()
        self.likelihood = likelihood

    def forward(self, primals):
        return self.energy(primals)

    def energy(self, primals):
        return self.likelihood(primals) + 0.5 * vdot(primals, primals).real

    def metric_at(self, primals):
        met = self.likelihood.metric_at(primals)
        return lambda tangents: tree_add(met(tangents), tangents)


#: Map names under which the KL stage batches its samples along a leading
#: axis (one model evaluation for all samples); any other map loops.
_BATCHED_MAPS = ("vmap", "v")


def _broadcast(tree, n):
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)), tree)


def _mean_energy_and_grad(likelihood, primals, primals_samples, *, map="smap"):
    """KL estimate: Hamiltonian value and gradient averaged over the
    samples centred at ``primals`` (the MAP energy when there are none)."""
    vg = partial(value_and_grad, _StandardHamiltonian(likelihood).energy)
    if not len(primals_samples):
        return vg(primals)
    batch = primals_samples.at(primals).samples
    if map in _BATCHED_MAPS:
        # the energy of the stacked samples is the sum of theirs
        total, grads = vg(batch)
        return total / len(primals_samples), _reduce(grads)
    return _reduce(get_map(map)(vg)(batch))


def _mean_metric_at(likelihood, primals, primals_samples, *, map="smap"):
    """Sample-averaged metric matvec at ``primals``, linearized once: for
    a batched map one linearization of all samples stacked, else one per
    sample."""
    ham = _StandardHamiltonian(likelihood)
    if not len(primals_samples):
        return ham.metric_at(primals)
    if map in _BATCHED_MAPS:
        n = len(primals_samples)
        lh_met = likelihood.metric_at(primals_samples.at(primals).samples)
        return lambda tangents: tree_add(_reduce(lh_met(_broadcast(tangents, n))), tangents)
    mets = [ham.metric_at(s) for s in primals_samples.at(primals)]
    return lambda tangents: _reduce(stack([m(tangents) for m in mets]))


def _mean_metric(likelihood, primals, tangents, primals_samples, *, map="smap"):
    """Sample-averaged metric applied to ``tangents`` (one linearization
    per call; the solvers' inner loops use :func:`_mean_metric_at`)."""
    return _mean_metric_at(likelihood, primals, primals_samples, map=map)(tangents)


def interleave(*trees):
    """Round-robin merge of equally shaped stacked trees along axis 0:
    ``interleave(p, m)`` gives ``(p0, m0, p1, m1, ...)``."""

    def leaf(*xs):
        widened = torch.stack(xs, dim=1)
        return widened.reshape((len(xs) * xs[0].shape[0],) + tuple(xs[0].shape[1:]))

    return tree_map(leaf, *trees)


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """What the sampling stage of one iteration does: ``draw`` the linear
    residuals, ``curve`` them (geoVI), with ``fresh_keys`` or the stored
    ones.  ``None`` in place of a plan means MAP."""

    draw: bool
    curve: bool
    fresh_keys: bool


_SAMPLING_PLANS = {
    "linear_sample": SamplingPlan(draw=True, curve=False, fresh_keys=False),
    "linear_resample": SamplingPlan(draw=True, curve=False, fresh_keys=True),
    "nonlinear_sample": SamplingPlan(draw=True, curve=True, fresh_keys=False),
    "nonlinear_resample": SamplingPlan(draw=True, curve=True, fresh_keys=True),
    "nonlinear_update": SamplingPlan(draw=False, curve=True, fresh_keys=False),
}


def _recenter_and_slim(samples, res: OptimizeResults):
    """Move the expansion point to the KL minimizer and drop the bulky
    result fields."""
    samples = samples.at(res.x)
    return samples, res._replace(x=None, jac=None, hess=None, hess_inv=None)


def _mirror_tags(keys):
    """Per-sample (key, sign) tags of an antithetic batch, in the order
    :func:`interleave` stores the residual pairs."""
    tag_keys = [k for k in keys for _ in range(2)]
    tag_signs = [s for _ in keys for s in (1.0, -1.0)]
    return tag_keys, tag_signs


SMPL_MODE_TYP = Literal[
    "linear_sample", "linear_resample", "nonlinear_sample",
    "nonlinear_resample", "nonlinear_update",
]


def plan_sampling(sample_mode, n_samples: int, n_stored: int):
    """Resolve a sample mode into a :class:`SamplingPlan` (``None`` for
    MAP); a stored key set is reused only for the same sample count."""
    if n_samples == 0:
        return None
    plan = _SAMPLING_PLANS.get(str(sample_mode).lower())
    if plan is None:
        raise ValueError(
            f"invalid sample mode {sample_mode!r}; known modes: {tuple(_SAMPLING_PLANS)}"
        )
    if n_samples != n_stored:
        plan = SamplingPlan(draw=True, curve=plan.curve, fresh_keys=True)
    return plan


def at_iteration(setting, nit: int):
    """Unary callables are evaluated at the iteration index; anything else
    passes through."""
    if callable(setting):
        try:
            n_par = len(inspect.signature(setting).parameters)
        except (TypeError, ValueError):
            n_par = -1
        if n_par == 1:
            return setting(nit)
    return setting


@dataclasses.dataclass(frozen=True)
class VISchedule:
    """Per-iteration configuration; every field is a value or a unary
    callable of the global iteration index."""

    n_samples: Any = None
    sample_mode: Any = "nonlinear_resample"
    point_estimates: Any = ()
    constants: Any = ()
    draw_linear_kwargs: Any = dataclasses.field(
        default_factory=lambda: dict(cg_name=None, cg_kwargs=dict())
    )
    nonlinearly_update_kwargs: Any = dataclasses.field(
        default_factory=lambda: dict(minimize_kwargs=dict())
    )
    kl_kwargs: Any = dataclasses.field(
        default_factory=lambda: dict(minimize_kwargs=dict())
    )

    def resolve(self, nit: int) -> dict:
        return {
            f.name: at_iteration(getattr(self, f.name), nit)
            for f in dataclasses.fields(self)
        }


class OptimizeVIState(NamedTuple):
    nit: int
    key: Any
    sample_state: Optional[Any] = None
    minimization_state: Optional[OptimizeResults] = None
    config: Any = None


def get_status_message(samples, state, *, name="") -> str:
    """End-of-iteration report: KL energy and solver step counts."""
    opt = state.minimization_state
    lines = [
        f"{name}: iter {state.nit:04d}  KL energy {float(opt.fun):+.4e}"
        f"  ({int(opt.nit)} Newton-CG step(s))"
    ]
    st = state.sample_state
    if isinstance(st, OptimizeResults) and st.nit is not None:
        counts = [int(c) for c in torch.as_tensor(st.nit).reshape(-1).tolist()]
        lines.append(f"{name}: geoVI curve steps per sample {counts}")
    return "\n".join(lines) + "\n"


class OptimizeVI:
    """Stateless assembly of MGVI/geoVI steps: draw or update samples, then
    minimize the sample-estimated KL.

    ``residual_map`` and ``kl_map`` accept the JAX package's names.  The
    residual stages loop over samples whatever the map (see
    :func:`~nifty_tpu_torch.tree.get_map`).  The KL stage stacks the samples
    along a leading axis for ``kl_map="vmap"`` and loops for ``"smap"``;
    ``"auto"`` stacks below ``AUTO_SMAP_MIN_SIZE`` latent dof.
    """

    #: Latent sizes at or above which ``kl_map="auto"`` loops over samples.
    #: The port's rule: the stacked KL stage holds every sample's
    #: linearization and every temporary of a matvec for all samples at
    #: once, about 30 arrays of n_samples x size float64 values; at 2^22
    #: dof and 8 samples that is some 8 GB of an 80 GB card, and 4096^2
    #: (2^24 dof) would need several times more.  The loop keeps one
    #: sample's temporaries alive at a time.
    AUTO_SMAP_MIN_SIZE = 2**22

    def __init__(self, likelihood: Likelihood, n_total_iterations: int, *,
                 kl_map="auto", residual_map="auto", mirror_samples=True):
        if mirror_samples is False:
            raise NotImplementedError("non-antithetic sampling not supported")
        if kl_map == "auto":
            small = tree_size(likelihood.domain) < self.AUTO_SMAP_MIN_SIZE
            kl_map = "vmap" if small else "smap"
        residual_map = "smap" if residual_map == "auto" else residual_map
        self.likelihood = likelihood
        self.n_total_iterations = n_total_iterations
        self.kl_map = kl_map
        self.residual_map = get_map(residual_map)
        self.kl_value_and_grad = partial(_mean_energy_and_grad, map=kl_map)
        self.kl_metric = partial(_mean_metric, map=kl_map)
        self.kl_metric_at = partial(_mean_metric_at, map=kl_map)

    # -- sampling ---------------------------------------------------------

    def draw_linear_samples(self, primals, keys, **kwargs):
        mapped = self.residual_map(
            partial(draw_linear_residual, self.likelihood, primals, **kwargs)
        )
        smpls, smpls_states = mapped(list(keys))
        neg = tree_map(torch.neg, smpls)
        return Samples(pos=primals, samples=interleave(smpls, neg), keys=keys), smpls_states

    def nonlinearly_update_samples(self, samples: Samples, **kwargs):
        if len(samples.keys) != len(samples) // 2:
            raise ValueError("every stored key must have an antithetic pair")
        tag_keys, tag_signs = _mirror_tags(samples.keys)

        def curve(residual, key, sign):
            return nonlinearly_update_residual(
                self.likelihood, samples.pos, residual, key, sign, **kwargs
            )

        smpls, smpls_states = self.residual_map(curve)(
            samples._samples, tag_keys, tag_signs
        )
        return Samples(pos=samples.pos, samples=smpls, keys=samples.keys), smpls_states

    def draw_samples(self, samples: Samples, *, key, sample_mode: SMPL_MODE_TYP,
                     n_samples: int, point_estimates, draw_linear_kwargs={},
                     nonlinearly_update_kwargs={}, **kwargs):
        n_stored = 0 if samples.keys is None else len(samples.keys)
        plan = plan_sampling(sample_mode, n_samples, n_stored)
        if plan is None:
            return samples, 0  # MAP: nothing to draw
        st_smpls = None
        if plan.draw:
            keys = samples.keys
            if plan.fresh_keys:
                keys = split(key, n_samples)
            samples, st_smpls = self.draw_linear_samples(
                samples.pos, keys, point_estimates=point_estimates,
                **draw_linear_kwargs, **kwargs,
            )
        if plan.curve:
            samples, st_smpls = self.nonlinearly_update_samples(
                samples, point_estimates=point_estimates,
                **nonlinearly_update_kwargs, **kwargs,
            )
        return samples, st_smpls

    # -- KL minimization --------------------------------------------------

    def kl_minimize(self, samples: Samples,
                    minimize: Callable[..., OptimizeResults] = _newton_cg,
                    minimize_kwargs={}, **kwargs) -> OptimizeResults:
        """Newton-CG (or ``minimize``) on the sample-averaged KL; extra
        keyword arguments are accepted and ignored, as in the JAX package."""
        lh = self.likelihood
        return minimize(
            None,
            x0=samples.pos,
            fun_and_grad=partial(self.kl_value_and_grad, lh, primals_samples=samples),
            hessp=partial(self.kl_metric, lh, primals_samples=samples),
            hessp_at=partial(self.kl_metric_at, lh, primals_samples=samples),
            **minimize_kwargs,
        )

    # -- iteration --------------------------------------------------------

    def init_state(self, key, *, nit=0, n_samples,
                   draw_linear_kwargs=dict(cg_name=None, cg_kwargs=dict()),
                   nonlinearly_update_kwargs=dict(minimize_kwargs=dict()),
                   kl_kwargs=dict(minimize_kwargs=dict()),
                   sample_mode="nonlinear_resample",
                   point_estimates=(), constants=()) -> OptimizeVIState:
        """``key``: an int seed, a ``torch.Generator`` or a noise provider
        (see :mod:`nifty_tpu_torch.tree`)."""
        if constants not in ((), None):
            raise NotImplementedError("`constants` is not implemented")
        schedule = VISchedule(
            n_samples=n_samples, sample_mode=sample_mode,
            point_estimates=point_estimates, constants=constants,
            draw_linear_kwargs=draw_linear_kwargs,
            nonlinearly_update_kwargs=nonlinearly_update_kwargs,
            kl_kwargs=kl_kwargs,
        )
        return OptimizeVIState(nit, key, config=schedule)

    def update(self, samples: Samples, state: OptimizeVIState, /, **kwargs):
        """One VI iteration: draw/update samples, then minimize the KL."""
        if not isinstance(samples, Samples) or not isinstance(state, OptimizeVIState):
            raise TypeError("expected (Samples, OptimizeVIState)")
        nit, key = state.nit, state.key
        cfg = state.config.resolve(nit)
        key, sk = split(key, 2)
        samples, st_smpls = self.draw_samples(
            samples, key=sk,
            sample_mode=cfg["sample_mode"],
            point_estimates=cfg["point_estimates"],
            n_samples=cfg["n_samples"],
            draw_linear_kwargs=cfg["draw_linear_kwargs"],
            nonlinearly_update_kwargs=cfg["nonlinearly_update_kwargs"],
            **kwargs,
        )
        kl_opt_state = self.kl_minimize(samples, **dict(cfg["kl_kwargs"]), **kwargs)
        samples, kl_opt_state = _recenter_and_slim(samples, kl_opt_state)
        return samples, state._replace(
            nit=nit + 1, key=key, sample_state=st_smpls,
            minimization_state=kl_opt_state,
        )


def optimize_kl(likelihood: Likelihood, position_or_samples, *, key,
                n_total_iterations: int, n_samples, point_estimates=(),
                kl_map="auto", residual_map="auto",
                draw_linear_kwargs=dict(cg_name=None, cg_kwargs=dict()),
                nonlinearly_update_kwargs=dict(minimize_kwargs=dict()),
                kl_kwargs=dict(minimize_kwargs=dict()),
                sample_mode="nonlinear_resample",
                callback: Optional[Callable] = None):
    """Thin loop: ``n_total_iterations`` calls of ``OptimizeVI.update``
    (no checkpoints), with an optional ``callback(samples, state)``."""
    opt = OptimizeVI(likelihood, n_total_iterations, kl_map=kl_map,
                     residual_map=residual_map)
    samples = (
        position_or_samples if isinstance(position_or_samples, Samples)
        else Samples(pos=position_or_samples, samples=None, keys=None)
    )
    state = opt.init_state(
        key, n_samples=n_samples, point_estimates=point_estimates,
        draw_linear_kwargs=draw_linear_kwargs,
        nonlinearly_update_kwargs=nonlinearly_update_kwargs,
        kl_kwargs=kl_kwargs, sample_mode=sample_mode,
    )
    for i in range(state.nit, n_total_iterations):
        logger.info(f"OPTIMIZE_KL: Starting {i + 1:04d}")
        samples, state = opt.update(samples, state)
        logger.info(get_status_message(samples, state, name="OPTIMIZE_KL"))
        if callback is not None:
            callback(samples, state)
    return samples, state
