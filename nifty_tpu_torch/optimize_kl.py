"""MGVI/geoVI variational inference (counterpart of
:mod:`nifty_tpu.optimize_kl`).

``OptimizeVI.update`` runs one iteration in three stages: an antithetic
linear (MGVI) draw per sample key, the geoVI nonlinear update of every
residual, and a Newton-CG minimization of the sample-averaged KL.  With
``residual_map="vmap"`` the per-sample stages run their solvers in
lockstep over all samples stacked on a leading axis
(:func:`~nifty_tpu_torch.evi.draw_linear_residuals`,
:func:`~nifty_tpu_torch.evi.nonlinearly_update_residuals`); with
``"smap"``/``"lmap"`` they are a loop over samples.  The KL energy,
gradient and metric have no control flow: with ``kl_map="vmap"`` the
samples are stacked along a leading axis and the model runs once for all
of them (the distributor kernels then see one table row per sample); with
``"smap"`` they are a loop.  Either way each Newton step linearizes the
metric once.

:func:`optimize_kl` runs the whole loop: schedules by iteration, a status report
with minisanity tables after every iteration, and, with ``odir``, a
checkpoint after every iteration from which ``resume=True`` continues with
the bits an uninterrupted run has.  On an active mesh
(:mod:`nifty_tpu_torch.parallel`) each rank of the samples axis draws and
curves its block of the samples, and the KL value, gradient and metric
reduce over the samples group (``kl_reduce``); the checkpoint is then the
sharded one (``checkpoint_format="orbax"``).  The JAX package's
fused/staged program split and program-size thresholds are XLA decisions
with no counterpart here.  ``optimize_kl``'s hooks (``transitions``,
``inspect_callback``, ``terminate_callback``, the HDF5 export of operator
outputs and the energy-history figure) run where the JAX package runs
them.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from functools import partial
from typing import Any, Callable, Literal, NamedTuple, Optional, Union

import torch

from . import config
from .custom_map import vmap
from .evi import (
    Samples,
    draw_linear_residual,
    draw_linear_residuals,
    nonlinearly_update_residual,
    nonlinearly_update_residuals,
)
from .likelihood import Likelihood, value_and_grad
from .logger import logger
from .minisanity import minisanity
from .model import LazyModel, module_device
from .parallel.mesh import active_mesh, sample_rows, tree_mean, tree_pairwise_mean
from .sample_io import (
    load_checkpoint,
    load_sharded_checkpoint,
    save_checkpoint,
    save_samples_to_hdf5,
    save_sharded_checkpoint,
)
from .solvers.newton_cg import OptimizeResults, _newton_cg
from .tree import broadcast_rows, get_map, split, stack, tree_add, tree_leaves, tree_map, vdot
from .tree import size as tree_size


def _reduce(tree):
    """Sample mean of a stacked tree (the default ``kl_reduce``); a fixed
    pairwise tree under ``deterministic_reductions``.  On an active mesh
    the rows are this rank's block of the samples and the mean is the
    global one, reduced over the samples group (in the pairwise tree's
    global order under ``deterministic_reductions``)."""
    mesh = active_mesh()
    if config.get("deterministic_reductions"):
        return tree_pairwise_mean(tree, mesh=mesh)
    if mesh is None:
        return tree_map(lambda x: x.mean(dim=0), tree)
    return tree_mean(tree, mesh=mesh)


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


def _lockstep_depends_on_world(device) -> bool:
    """Whether a lockstep (batched) stage would give a sample bits that
    depend on the world: on a card, under ``deterministic_reductions``,
    with a mesh active.  A lockstep call stacks one samples rank's share
    of the rows, and on the card a reduction along each row (``torch.sum``,
    the sums of a broadcast's gradient) picks its threads by the number of
    rows, so a row's sum changes bits with the share (card test
    ``test_row_sums_on_the_card_depend_on_the_row_count``)."""
    return (torch.device(device).type == "cuda" and bool(config.get("deterministic_reductions"))
            and active_mesh() is not None)


def _refuse_lockstep(tree):
    """Raise where a lockstep stage on ``tree``'s device would part the
    worlds (:func:`_lockstep_depends_on_world`) on a samples axis of more
    than one rank."""
    mesh = active_mesh()
    if (_lockstep_depends_on_world(tree_leaves(tree)[0].device)
            and mesh.size(mesh.sample_axis) > 1):
        raise ValueError(
            "the lockstep maps ('vmap') on a samples axis of several ranks give a sample "
            "bits that depend on the world under deterministic_reductions on the card; "
            "use the sample loop ('smap', which 'auto' picks there)")


def _mean_energy_and_grad(likelihood, primals, primals_samples, *, map="smap",
                          reduce=_reduce):
    """KL estimate: Hamiltonian value and gradient averaged over the
    samples centred at ``primals`` (the MAP energy when there are none).
    On an active mesh each sample's value is its own (a loop), so that
    ``reduce`` can order the sum over samples globally."""
    vg = partial(value_and_grad, _StandardHamiltonian(likelihood).energy)
    if not len(primals_samples):
        return vg(primals)
    batch = primals_samples.at(primals).samples
    if map in _BATCHED_MAPS and active_mesh() is None:
        # the energy of the stacked samples is the sum of theirs
        total, grads = vg(batch)
        return total / len(primals_samples), reduce(grads)
    mapped = get_map("smap" if map in _BATCHED_MAPS else map)
    return reduce(mapped(vg)(batch))


def _mean_metric_at(likelihood, primals, primals_samples, *, map="smap", reduce=_reduce):
    """Sample-averaged metric matvec at ``primals``, linearized once: for
    a batched map one linearization of all samples stacked, else one per
    sample."""
    ham = _StandardHamiltonian(likelihood)
    if not len(primals_samples):
        return ham.metric_at(primals)
    if map in _BATCHED_MAPS:
        _refuse_lockstep(primals)
        n = len(primals_samples)
        lh_met = likelihood.metric_at(primals_samples.at(primals).samples)
        return lambda tangents: tree_add(reduce(lh_met(broadcast_rows(tangents, n))), tangents)
    mets = [ham.metric_at(s) for s in primals_samples.at(primals)]
    return lambda tangents: reduce(stack([m(tangents) for m in mets]))


def _mean_metric(likelihood, primals, tangents, primals_samples, *, map="smap",
                 reduce=_reduce):
    """Sample-averaged metric applied to ``tangents`` (one linearization
    per call; the solvers' inner loops use :func:`_mean_metric_at`)."""
    return _mean_metric_at(likelihood, primals, primals_samples, map=map,
                           reduce=reduce)(tangents)


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


def get_status_message(samples, state, residual=None, *, name="", map="vmap") -> str:
    """End-of-iteration report: KL energy, solver step counts and status,
    and minisanity residual tables (data space and latent space)."""
    opt = state.minimization_state
    lines = [
        f"{name}: iter {state.nit:04d}  KL energy {float(opt.fun):+.4e}"
        f"  ({int(opt.nit)} Newton-CG step(s))"
    ]
    st = state.sample_state
    if isinstance(st, OptimizeResults):
        if st.nit is not None:
            counts = _all_samples([int(c) for c in torch.as_tensor(st.nit).reshape(-1).tolist()])
            lines.append(f"{name}: geoVI curve steps per sample {counts}")
    elif torch.is_tensor(st):
        codes = _all_samples([int(c) for c in st.reshape(-1).tolist()])
        lines.append(f"{name}: linear-draw CG status per sample {codes}")
        if min(codes) < 0:
            lines.append(
                f"{name}: WARNING metric CG reported failure (negative "
                "status: non-positive-definite metric or NaN energy)"
            )
    if residual is not None:
        _, tbl = minisanity(samples, residual, map=map)
        lines.append(f"{name}: data-space residuals\n{tbl}")
    _, tbl = minisanity(samples, map=map)
    lines.append(f"{name}: latent-space residuals\n{tbl}")
    return "\n".join(lines) + "\n"


def _all_samples(values: list) -> list:
    """Per-sample values of every rank of the samples axis, in global
    order (this rank's alone without a mesh)."""
    mesh = active_mesh()
    if mesh is None:
        return values
    from .parallel.collectives import all_gather_object

    return [v for part in all_gather_object(values, mesh.group(mesh.sample_axis)) for v in part]


def _log_once(msg: str) -> None:
    """Log ``msg`` from rank 0 of the active mesh only."""
    mesh = active_mesh()
    if mesh is None or mesh.is_root:
        logger.info(msg)


def _check_sampling_status(sample_state, draw_linear_kwargs) -> None:
    """When the caller asked for ``_raise_nonposdef``, turn a negative
    sampling status into an exception at the end of the sampling stage."""
    if not (draw_linear_kwargs or {}).get("_raise_nonposdef", False):
        return
    status = sample_state
    if isinstance(status, OptimizeResults):
        status = status.status
    if status is None:
        return
    status = torch.as_tensor(status)
    if bool((status < 0).any()):
        raise FloatingPointError(
            f"metric CG failed during sample drawing (status={status.tolist()}): "
            "non-positive-definite metric or NaN energy"
        )


class OptimizeVI:
    """Stateless assembly of MGVI/geoVI steps: draw or update samples, then
    minimize the sample-estimated KL.

    ``residual_map`` and ``kl_map`` accept the JAX package's names.  The
    residual stages run the lockstep batched solvers for ``"vmap"`` and loop
    over samples for ``"smap"``/``"lmap"``.  The KL stage stacks the samples
    along a leading axis for ``kl_map="vmap"`` and loops for ``"smap"``.
    ``"auto"`` batches below ``AUTO_SMAP_MIN_SIZE`` latent dof and loops
    from there on, for both maps; it loops at any size on a card under
    ``deterministic_reductions`` with a mesh active, where the lockstep
    maps would give the worlds other bits (and raise on a samples axis of
    several ranks).
    """

    #: Latent sizes at or above which the ``"auto"`` maps loop over samples.
    #: The port's rule: the stacked KL stage holds every sample's
    #: linearization and every temporary of a matvec for all samples at
    #: once, about 30 arrays of n_samples x size float64 values; at 2^22
    #: dof and 8 samples that is some 8 GB of an 80 GB card, and 4096^2
    #: (2^24 dof) would need several times more.  The loop keeps one
    #: sample's temporaries alive at a time.
    AUTO_SMAP_MIN_SIZE = 2**22

    def __init__(self, likelihood: Likelihood, n_total_iterations: int, *,
                 kl_map="auto", residual_map="auto", kl_reduce=_reduce, mirror_samples=True,
                 _get_status_message: Optional[Callable] = None):
        if mirror_samples is False:
            raise NotImplementedError("non-antithetic sampling not supported")
        small = tree_size(likelihood.domain) < self.AUTO_SMAP_MIN_SIZE
        batch = small and not _lockstep_depends_on_world(module_device(likelihood))
        if isinstance(kl_map, str) and kl_map == "auto":
            kl_map = "vmap" if batch else "smap"
        if isinstance(residual_map, str) and residual_map == "auto":
            residual_map = "vmap" if batch else "smap"
        self.likelihood = likelihood
        self.n_total_iterations = n_total_iterations
        self.kl_map = kl_map
        #: Whether the residual stages run the batched lockstep solvers:
        #: decided by the map's name (or the batching map itself); any other
        #: callable maps the per-sample stage functions, as the loops do.
        self.lockstep = residual_map is vmap or (
            isinstance(residual_map, str) and residual_map in _BATCHED_MAPS)
        self.residual_map = get_map(residual_map)
        self.kl_reduce = kl_reduce
        self.kl_value_and_grad = partial(_mean_energy_and_grad, map=kl_map, reduce=kl_reduce)
        self.kl_metric = partial(_mean_metric, map=kl_map, reduce=kl_reduce)
        self.kl_metric_at = partial(_mean_metric_at, map=kl_map, reduce=kl_reduce)
        if _get_status_message is None:
            _get_status_message = partial(
                get_status_message,
                residual=likelihood.normalized_residual,
                name=self.__class__.__name__,
                map="vmap" if kl_map in _BATCHED_MAPS else "smap",
            )
        self.get_status_message = _get_status_message

    # -- sampling ---------------------------------------------------------

    def draw_linear_samples(self, primals, keys, **kwargs):
        if self.lockstep:
            _refuse_lockstep(primals)
            smpls, smpls_states = draw_linear_residuals(
                self.likelihood, primals, list(keys), **kwargs)
        else:
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

        if self.lockstep:
            _refuse_lockstep(samples.pos)
            smpls, smpls_states = nonlinearly_update_residuals(
                self.likelihood, samples.pos, samples._samples, tag_keys, tag_signs,
                **kwargs)
        else:
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
        mesh = active_mesh()
        n_stored = 0 if samples.keys is None else len(samples.keys)
        if mesh is not None:
            n_stored *= mesh.size(mesh.sample_axis)
        plan = plan_sampling(sample_mode, n_samples, n_stored)
        if plan is None:
            return samples, 0  # MAP: nothing to draw
        st_smpls = None
        if plan.draw:
            keys = samples.keys
            if plan.fresh_keys:
                # every rank splits the key alike and draws its block of the
                # keys: a sample's noise follows from its global index alone
                first, count = sample_rows(mesh, n_samples)
                keys = split(key, n_samples)[first:first + count]
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
        _check_sampling_status(st_smpls, cfg["draw_linear_kwargs"])
        kl_opt_state = self.kl_minimize(samples, **dict(cfg["kl_kwargs"]), **kwargs)
        samples, kl_opt_state = _recenter_and_slim(samples, kl_opt_state)
        return samples, state._replace(
            nit=nit + 1, key=key, sample_state=st_smpls,
            minimization_state=kl_opt_state,
        )

    def run(self, samples, *args, **kwargs):
        """``init_state(*args, **kwargs)``, then updates up to
        ``n_total_iterations`` with a status report after each."""
        state = self.init_state(*args, **kwargs)
        nm = self.__class__.__name__
        for i in range(state.nit, self.n_total_iterations):
            _log_once(f"{nm}: Starting {i + 1:04d}")
            samples, state = self.update(samples, state)
            _log_once(self.get_status_message(samples, state, name=nm))
        return samples, state


#: File names inside ``odir``: the checkpoint of each format, the report,
#: the exported operator outputs and the energy history's figure.
CHECKPOINT_NAME = "last.pkl"
SHARDED_CHECKPOINT_NAME = "last_ckpt"
MINISANITY_NAME = "minisanity.txt"
OPERATOR_OUTPUTS_NAME = "operator_outputs.h5"
ENERGY_HISTORY_NAME = "energy_history.png"


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def optimize_kl(likelihood: Likelihood, position_or_samples, *, key,
                n_total_iterations: int, n_samples, point_estimates=(),
                constants=(), kl_map="auto", residual_map="auto",
                kl_reduce=_reduce, mirror_samples=True,
                draw_linear_kwargs=dict(cg_name=None, cg_kwargs=dict()),
                nonlinearly_update_kwargs=dict(minimize_kwargs=dict()),
                kl_kwargs=dict(minimize_kwargs=dict()),
                sample_mode="nonlinear_resample",
                resume: Union[str, bool] = False,
                checkpoint_format: Optional[Literal["pickle", "orbax"]] = None,
                transitions: Optional[Callable[[int], Optional[Callable]]] = None,
                callback: Optional[Callable] = None,
                inspect_callback: Optional[Callable] = None,
                terminate_callback: Optional[Callable] = None,
                plot_energy_history: bool = True,
                export_operator_outputs: Optional[dict] = None,
                odir: Optional[str] = None,
                _optimize_vi=None, _optimize_vi_state=None):
    """One-stop MGVI/geoVI loop with checkpoint and resume.

    Every schedule argument (``n_samples``, ``sample_mode``, the kwargs) is
    a value or a callable of the iteration index.  With ``odir`` each
    iteration appends its status report (KL energy, step counts, minisanity
    tables) to ``odir/minisanity.txt`` and overwrites the checkpoint
    ``odir/last.pkl``.  ``resume=True`` loads that checkpoint (``resume=path``
    another one) and continues at its iteration with its key and samples;
    the schedule is rebuilt from the arguments, so pass the same ones.

    The hooks, in the order they run in an iteration: ``transitions(i)``
    before the update returns ``None`` or a map applied to the samples
    (parts of the model that change between iterations); after the update
    and its report and checkpoint, ``export_operator_outputs`` (a mapping of
    names to callables of a sample) writes their sample mean, std and
    samples to ``odir/operator_outputs.h5``, then ``callback(samples,
    state)``, ``inspect_callback(samples)`` or ``inspect_callback(samples,
    iteration)`` (by its signature), and ``terminate_callback(samples,
    state)``, whose true result ends the loop.  ``plot_energy_history``
    draws the KL energy of each iteration into ``odir/energy_history.png``
    after the loop where matplotlib imports (a warning is logged where it
    does not).

    ``checkpoint_format`` takes the JAX package's values: ``"pickle"`` (one
    file, one process) or ``"orbax"``, which names the port's sharded
    checkpoint (the JAX package's is an orbax one; orbax is a JAX library):
    the directory ``odir/last_ckpt`` in which every rank writes its own
    shards and rank 0 a manifest of the global shapes and layouts
    (:func:`~nifty_tpu_torch.sample_io.save_sharded_checkpoint`); it
    resumes on any world size and layout.  ``None`` picks ``"orbax"`` in a
    world of several ranks, else ``"pickle"``.  On a mesh the reports and
    the figure are logged and written by rank 0 alone, as is
    ``operator_outputs.h5``, whose outputs are first gathered from every
    rank (:func:`~nifty_tpu_torch.sample_io.save_samples_to_hdf5`).
    ``kl_reduce`` is the sample mean
    of the KL stage (see :class:`OptimizeVI`).
    """
    if checkpoint_format is None:
        checkpoint_format = "orbax" if _world_size() > 1 else "pickle"
    if checkpoint_format not in ("pickle", "orbax"):
        raise ValueError(f"unknown checkpoint format {checkpoint_format!r}")
    sharded = checkpoint_format == "orbax"
    if not sharded and _world_size() > 1:
        raise ValueError('a world of several ranks checkpoints with checkpoint_format="orbax"')
    opt_vi = _optimize_vi
    if opt_vi is None:
        opt_vi = OptimizeVI(
            likelihood, n_total_iterations, kl_map=kl_map,
            residual_map=residual_map, kl_reduce=kl_reduce, mirror_samples=mirror_samples,
        )
    ckpt_name = SHARDED_CHECKPOINT_NAME if sharded else CHECKPOINT_NAME
    ckpt_fn = os.path.join(odir, ckpt_name) if odir is not None else None
    sanity_fn = os.path.join(odir, MINISANITY_NAME) if odir is not None else None

    samples = (
        position_or_samples if isinstance(position_or_samples, Samples)
        else Samples(pos=position_or_samples, samples=None, keys=None)
    )
    state = _optimize_vi_state
    if resume:
        src = resume if isinstance(resume, str) and os.path.exists(resume) else ckpt_fn
        if src is None or not os.path.exists(src):
            raise ValueError(f"no checkpoint to resume from at {src!r}")
        if samples.pos is not None:
            logger.warning("`resume` overrides `position_or_samples`")
        if sharded:
            samples, loaded_state = load_sharded_checkpoint(src, mesh=active_mesh())
        else:
            samples, loaded_state = load_checkpoint(src)
        state = loaded_state if state is None else state

    if state is None or not state.config:
        if constants not in ((), None):
            raise NotImplementedError("`constants` is not implemented")
        schedule = VISchedule(
            n_samples=n_samples, sample_mode=sample_mode,
            point_estimates=point_estimates, constants=constants,
            draw_linear_kwargs=draw_linear_kwargs,
            nonlinearly_update_kwargs=nonlinearly_update_kwargs,
            kl_kwargs=kl_kwargs,
        )
        if state is None:
            state = OptimizeVIState(nit=0, key=key, config=schedule)
        else:
            state = state._replace(config=schedule)

    mesh = active_mesh()
    root = mesh is None or mesh.is_root
    if odir:
        os.makedirs(odir, exist_ok=True)
        if not resume and root:
            open(sanity_fn, "w").close()

    nm = "OPTIMIZE_KL"
    energy_history = []
    for i in range(state.nit, opt_vi.n_total_iterations):
        _log_once(f"{nm}: Starting {i + 1:04d}")
        if transitions is not None:
            tr = transitions(i)
            if tr is not None:
                samples = tr(samples)
        samples, state = opt_vi.update(samples, state)
        msg = opt_vi.get_status_message(samples, state, name=nm)
        _log_once(msg)
        energy_history.append((state.nit, float(state.minimization_state.fun)))
        if sanity_fn is not None and root:
            with open(sanity_fn, "a") as f:
                f.write("\n" + msg)
        if ckpt_fn is not None and sharded:
            save_sharded_checkpoint(ckpt_fn, samples, state, mesh=mesh)
        elif ckpt_fn is not None:
            save_checkpoint(ckpt_fn, samples, state)
        if export_operator_outputs is not None and odir is not None:
            save_samples_to_hdf5(samples, os.path.join(odir, OPERATOR_OUTPUTS_NAME),
                                 export_operator_outputs, overwrite=True)
        if callback is not None:
            callback(samples, state)
        if inspect_callback is not None:
            try:
                n_par = len(inspect.signature(inspect_callback).parameters)
            except (TypeError, ValueError):
                n_par = 2
            if n_par == 1:
                inspect_callback(samples)
            else:
                inspect_callback(samples, state.nit)
        if terminate_callback is not None and terminate_callback(samples, state):
            _log_once(f"{nm}: terminated early by `terminate_callback`")
            break
    if plot_energy_history and odir is not None and energy_history and root:
        _plot_energy_history(os.path.join(odir, ENERGY_HISTORY_NAME), energy_history)
    return samples, state


def _plot_energy_history(path: str, energy_history) -> None:
    """The KL energy of each iteration, drawn into ``path``."""
    try:
        import matplotlib
    except ImportError:
        logger.warning(f"matplotlib does not import: {path} is not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nits, energies = zip(*energy_history)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(nits, energies, marker="o")
    ax.set_xlabel("iteration")
    ax.set_ylabel("KL energy")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
