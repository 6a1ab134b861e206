"""What the ranks of the port's mesh tests run (imports torch, numpy and
the port only, never jax: the ranks are processes of their own).

:func:`run_cases` is the function a world runs
(``nifty_tpu_torch.parallel.run_world(run_cases, n, args=(cases,))``):
each case is ``(name, function name, kwargs)``; the function runs on
every rank and returns numpy data (rank 0's result is the one compared,
every rank's where the test says so).  The inputs come as numpy arrays
from the test, made from a seed, and the noise as a :class:`ReplayKey`
of noise the test recorded (the JAX package's, where the port is held
against it).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

import nifty_tpu_torch as jt
from nifty_tpu_torch.ops.distributed_fft import distributed_fftn, distributed_hartley
from nifty_tpu_torch.parallel import (
    gather_samples,
    make_mesh,
    pairwise_sum,
    shard_position,
    shard_samples,
)
from nifty_tpu_torch.parallel import mesh as pmesh
from nifty_tpu_torch.tree import tree_leaves

jt.logger.setLevel(logging.WARNING)


class ReplayKey:
    """A noise provider that replays recorded draws: ``table`` maps a key's
    path (the indices of the splits from the root, ``("fold", data)`` for
    a fold) to the tree of numpy arrays drawn there."""

    def __init__(self, table, path=()):
        self.table, self.path = table, tuple(path)

    def split(self, num):
        return [ReplayKey(self.table, self.path + (i,)) for i in range(num)]

    def fold_in(self, data):
        return ReplayKey(self.table, self.path + ("fold", int(data)))

    def normal(self, primals, device=None):
        drawn = self.table[self.path]
        got = [tuple(x.shape) for x in tree_leaves(drawn)]
        want = [tuple(x.shape) for x in tree_leaves(primals)]
        if got != want:
            raise ValueError(f"replayed noise at {self.path} has shapes {got}, not {want}")
        return jt.from_numpy(drawn, device=device or jt.config.default_device())


def run_cases(cases):
    """Run ``cases`` (see the module docstring) on this rank; returns
    ``{name: result}``."""
    torch.set_num_threads(1)
    out = {}
    for name, fn, kwargs in cases:
        out[name] = globals()[fn](**kwargs)
        mesh = pmesh.active_mesh()
        if mesh is not None:
            mesh.deactivate()
        jt.config.update("deterministic_reductions", False)
        jt.config.update("enable_x64", True)
    return out


def _np(x):
    return x.detach().cpu().numpy()


def _gathered(x, mesh, dim=0):
    from nifty_tpu_torch.parallel import collectives as coll

    return _np(coll.all_gather(x, mesh.group(mesh.field_axis), dim))


# -- transforms and reductions --------------------------------------------------


def hartley_case(x, field):
    """``distributed_hartley`` of ``x`` on a 1 × field mesh; returns the
    gathered transform."""
    mesh = make_mesh(1, field)
    return _gathered(distributed_hartley(mesh.own_rows(torch.from_numpy(x)), mesh), mesh)


def fftn_case(x, field):
    mesh = make_mesh(1, field)
    return _gathered(distributed_fftn(mesh.own_rows(torch.from_numpy(x)), mesh), mesh)


def hartley_vjp_case(x, y, field):
    """The gradient of ``<H x, y>`` by autograd, gathered, beside the
    forward."""
    mesh = make_mesh(1, field)
    xs = mesh.own_rows(torch.from_numpy(x)).requires_grad_(True)
    h = distributed_hartley(xs, mesh)
    (h * mesh.own_rows(torch.from_numpy(y))).sum().backward()
    return _gathered(h.detach(), mesh), _gathered(xs.grad, mesh)


def fftn_vjp_case(x, y, field):
    """The gradient of ``Re <F x, y>`` (complex ``x``, ``y``) by autograd."""
    mesh = make_mesh(1, field)
    xs = mesh.own_rows(torch.from_numpy(x)).requires_grad_(True)
    f = distributed_fftn(xs, mesh)
    (f.conj() * mesh.own_rows(torch.from_numpy(y))).real.sum().backward()
    return _gathered(xs.grad, mesh)


def pairwise_case(x, samples):
    """``pairwise_sum`` of ``x``'s rows spread over a samples axis; the
    bits, and how the reduction ran."""
    mesh = make_mesh(samples, 1)
    r = pairwise_sum(mesh.own_rows(torch.from_numpy(x), mesh.sample_axis), mesh=mesh)
    return _np(r), dict(mesh.stats)


def shard_samples_case(pos, resid, keys, samples, field):
    """``shard_samples`` of global samples, this rank's rows, and the
    round trip through ``gather_samples``."""
    mesh = make_mesh(samples, field)
    s = jt.Samples(pos=jt.from_numpy(pos, device="cpu"), samples=jt.from_numpy(resid, device="cpu"),
                   keys=list(keys))
    ss = shard_samples(s, mesh)
    back = gather_samples(ss, mesh)
    return dict(local=jt.to_numpy(ss._samples), keys=list(ss.keys),
                back=jt.to_numpy(back._samples), back_pos=jt.to_numpy(back.pos),
                back_keys=list(back.keys), index=(mesh.index("samples"), mesh.index("field")))


def random_like_case(shape, field, seed):
    """A slab of a field-sharded leaf drawn by ``random_like`` from an int
    seed and from a ``HostKey``, gathered: equal to the 1-rank draw."""
    mesh = make_mesh(1, field)
    like = {"xi": torch.zeros(shape, dtype=torch.float64), "s": torch.zeros((), dtype=torch.float64)}
    local = shard_position(like, mesh)
    out = {}
    for name, key in (("seed", seed), ("host", jt.HostKey(seed))):
        d = jt.random_like(key, local)
        out[name] = dict(xi=_gathered(d["xi"], mesh), s=_np(d["s"]))
    return out


# -- correlated-field problems -----------------------------------------------------


def correlated_field(dims, mesh, distributed=True):
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2))
    hfn = None
    if distributed:
        def hfn(x, axes=None):
            return distributed_hartley(x, mesh, axes=axes)
    return cfm.finalize(hartley_fn=hfn, device="cpu")


def field_problem(data, pos, mesh, distributed=True, noise_var=1.0):
    """The JAX tests' 64^2 problem: the correlated field, a Gaussian of
    unit noise (or ``noise_var``), placed on the mesh."""
    cf = correlated_field(tuple(data.shape), mesh, distributed)
    lh = jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / noise_var).amend(cf)
    lh = shard_position(lh, mesh)
    return lh, jt.from_numpy(pos, device="cpu", mesh=mesh)


def vi_update_case(data, pos, key_table, samples, field, sample_mode, nl_maxiter,
                   budgets=(200, 100, 30, 150), det=False, n_samples=2, kl_map="auto",
                   residual_map="auto"):
    """One ``OptimizeVI.update`` of ``_field_sharded_vi_run`` (the JAX
    tests' helper) on a samples × field mesh; returns the global samples,
    the KL energy and Newton steps, and the mesh's reduction stats."""
    jt.config.update("deterministic_reductions", det)
    mesh = make_mesh(samples, field)
    lh, p = field_problem(data, pos, mesh)
    opt = jt.OptimizeVI(lh, n_total_iterations=1, kl_map=kl_map, residual_map=residual_map)
    state = opt.init_state(ReplayKey(key_table),
                           **_vi_kwargs(budgets, nl_maxiter, n_samples, sample_mode))
    t0 = time.perf_counter()
    smp, state = opt.update(jt.Samples(pos=p, samples=None, keys=None), state)
    seconds = time.perf_counter() - t0
    whole = gather_samples(smp, mesh)
    return dict(samples=jt.to_numpy(whole._samples), pos=jt.to_numpy(whole.pos),
                fun=float(state.minimization_state.fun),
                nit=int(state.minimization_state.nit), stats=dict(mesh.stats),
                seconds=seconds)


def stages_case(data, pos, tan, key_table, samples, field):
    """``test_deterministic_mode_stages_bitwise``: the energy, a metric
    matvec and a 200-step CG draw on a samples × field mesh."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, p = field_problem(data, pos, mesh)
    t = jt.from_numpy(tan, device="cpu", mesh=mesh)
    energy = float(lh(p))
    met = pmesh.gather_position(lh.metric(p, t), mesh)
    draw, _ = jt.draw_linear_residual(lh, p, ReplayKey(key_table),
                                      cg_kwargs=dict(maxiter=200, absdelta=1e-13))
    return dict(energy=energy, metric=jt.to_numpy(met),
                draw=jt.to_numpy(pmesh.gather_position(draw, mesh)))


def sample_draw_case(data, pos, key_table, samples):
    """``test_deterministic_mode_sample_parallel_draw_bitwise``: the
    antithetic linear draw of two keys spread over a samples axis (a local
    Hartley transform: the field is not sharded)."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, 1)
    lh, p = field_problem(data, pos, mesh, distributed=False)
    opt = jt.OptimizeVI(lh, n_total_iterations=1)
    first, count = pmesh.sample_rows(mesh, 2)
    keys = ReplayKey(key_table).split(2)[first:first + count]
    smp, _ = opt.draw_linear_samples(p, keys, cg_kwargs=dict(maxiter=200, absdelta=1e-13),
                                     point_estimates=())
    return jt.to_numpy(gather_samples(smp, mesh)._samples)


def kl_step_case(data, pos, key_table, samples, n_keys, cg_kwargs, det=False, pairwise=False):
    """``test_sharded_kl_step_matches_single_device`` and
    ``test_kl_with_pairwise_reduce_mesh_independent``: each rank draws its
    keys' residuals, then the sample-averaged KL value and gradient over
    the samples axis (``_kl_vg`` with the default reduce, the pairwise one
    under ``deterministic_reductions``)."""
    from nifty_tpu_torch.optimize_kl import _mean_energy_and_grad

    jt.config.update("deterministic_reductions", det)
    mesh = make_mesh(samples, 1)
    lh, p = field_problem(data, pos, mesh, distributed=False)
    opt = jt.OptimizeVI(lh, n_total_iterations=1, residual_map="smap")
    first, count = pmesh.sample_rows(mesh, n_keys)
    keys = ReplayKey(key_table).split(n_keys)[first:first + count]
    smp, _ = opt.draw_linear_samples(p, keys, cg_kwargs=cg_kwargs)
    kw = {}
    if pairwise:
        kw["reduce"] = lambda tree: pmesh.tree_pairwise_mean(tree, mesh=mesh)
    value, grad = _mean_energy_and_grad(lh, p, smp, **kw)
    return float(value), jt.to_numpy(grad), dict(mesh.stats)


def _vi_kwargs(budgets, nl_maxiter, n_samples, sample_mode):
    draw_mi, nl_cg_mi, kl_mi, kl_cg_mi = budgets
    return dict(
        n_samples=n_samples,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=draw_mi, absdelta=1e-13)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-8, maxiter=nl_maxiter, cg_kwargs=dict(maxiter=nl_cg_mi))),
        kl_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-9, maxiter=kl_mi, cg_kwargs=dict(maxiter=kl_cg_mi))),
        sample_mode=sample_mode)


def _whole(samples, state, mesh):
    whole = gather_samples(samples, mesh)
    return dict(pos=jt.to_numpy(whole.pos), samples=jt.to_numpy(whole._samples),
                fun=float(state.minimization_state.fun), nit=int(state.nit))


def checkpoint_write_case(data, pos, seed, samples, field, odir, budgets, n_samples):
    """``optimize_kl`` with the sharded checkpoint for two iterations,
    then a third continued in memory (into ``odir/in_memory``)."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, p = field_problem(data, pos, mesh)
    kw = dict(key=jt.HostKey(seed), checkpoint_format="orbax",
              **_vi_kwargs(budgets, 3, n_samples, "nonlinear_resample"))
    s2, st2 = jt.optimize_kl(lh, p, n_total_iterations=2, odir=odir, **kw)
    s3, st3 = jt.optimize_kl(lh, s2, n_total_iterations=3, odir=f"{odir}/in_memory",
                             _optimize_vi_state=st2, **kw)
    return dict(two=_whole(s2, st2, mesh), three=_whole(s3, st3, mesh))


def checkpoint_resume_case(data, pos, seed, samples, field, odir, budgets, n_samples):
    """The third iteration resumed from ``odir``'s sharded checkpoint."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, _ = field_problem(data, pos, mesh)
    s3, st3 = jt.optimize_kl(
        lh, None, n_total_iterations=3, odir=odir, resume=True, key=jt.HostKey(seed),
        checkpoint_format="orbax", **_vi_kwargs(budgets, 3, n_samples, "nonlinear_resample"))
    return _whole(s3, st3, mesh)


def export_case(data, pos, seed, samples, field, odir, budgets, n_samples):
    """``optimize_kl`` with ``export_operator_outputs`` for two iterations
    under ``deterministic_reductions``: the field (a slab a rank on a
    field-sharded mesh), its amplitude table and the table's outer product
    with itself (two axes; both the same on every rank), which rank 0
    writes to ``odir/operator_outputs.h5``; then, without
    ``deterministic_reductions``, ``save_samples_to_hdf5`` of the run's
    samples to ``odir/direct.h5``.  Last, the export of an output whose
    field layout is unknown: a field cut to its first column (different on
    the field ranks, one axis), and zeros of a slab's shape (the same on
    every rank).  Returns the files each rank found and the error each
    unknown output raised (``None`` where it was written)."""
    import os

    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    cf = correlated_field(tuple(data.shape), mesh)
    lh = shard_position(jt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x).amend(cf),
                        mesh)
    p = jt.from_numpy(pos, device="cpu", mesh=mesh)
    ops = {"field": cf, "amplitude": cf.amplitude,
           "outer": lambda x: torch.outer(cf.amplitude(x), cf.amplitude(x))}
    smp, _ = jt.optimize_kl(lh, p, n_total_iterations=2, odir=odir, key=jt.HostKey(seed),
                            export_operator_outputs=ops, plot_energy_history=False,
                            **_vi_kwargs(budgets, 3, n_samples, "nonlinear_resample"))
    jt.config.update("deterministic_reductions", False)
    jt.save_samples_to_hdf5(smp, os.path.join(odir, "direct.h5"), ops, overwrite=True)
    files = sorted(os.listdir(odir))
    slab = (data.shape[0] // field,) + tuple(data.shape[1:])
    unknown = {}
    for name, op in (("column", lambda x: cf(x)[:, 0]),
                     ("zeros", lambda x: torch.zeros(slab, dtype=torch.float64))):
        try:
            jt.save_samples_to_hdf5(smp, os.path.join(odir, f"{name}.h5"), {name: op},
                                    overwrite=True)
            unknown[name] = None
        except ValueError as e:
            unknown[name] = str(e)
    return files, unknown


def kl_reduce_case(data, pos, seed, samples, field, budgets):
    """``OptimizeVI(kl_reduce=...)``: a reduce that counts its calls and
    takes the pairwise mean over the samples axis."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, p = field_problem(data, pos, mesh)
    calls = []

    def reduce(tree):
        calls.append(1)
        return pmesh.tree_pairwise_mean(tree, mesh=mesh)

    out = {}
    for name, kl_reduce in (("counted", reduce), ("default", None)):
        kw = {} if kl_reduce is None else dict(kl_reduce=kl_reduce)
        opt = jt.OptimizeVI(lh, n_total_iterations=1, **kw)
        state = opt.init_state(jt.HostKey(seed), **_vi_kwargs(budgets, 0, 2, "linear_resample"))
        smp, state = opt.update(jt.Samples(pos=p), state)
        out[name] = _whole(smp, state, mesh)
    out["calls"] = len(calls)
    return out


def sleep_case(rank, seconds):
    """Rank ``rank`` sleeps, the others wait for it in a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        time.sleep(seconds)
    dist.barrier()
    return dist.get_rank()


def fail_case(rank):
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    dist.barrier()
    return dist.get_rank()


def ipc_case():
    """Every collective of a 2 x 2 gloo world on the card (through the
    CUDA IPC mailboxes) beside what it must give, built from every rank's
    input here (as numpy)."""
    import torch.distributed as dist

    from nifty_tpu_torch.ops.harmonic import hartley
    from nifty_tpu_torch.parallel import collectives as coll

    mesh = make_mesh(2, 2)
    fg, sg = mesh.group(mesh.field_axis), mesh.group(mesh.sample_axis)
    s, f = mesh.index(mesh.sample_axis), mesh.index(mesh.field_axis)

    def x_of(r):
        return torch.arange(24, dtype=torch.float64, device="cuda").reshape(4, 6) + 100 * r

    def z_of(r):
        return torch.complex(x_of(r), -x_of(r))

    r, peer = dist.get_rank(), 1 - f
    x, z = x_of(r), z_of(r)
    row, col = (2 * s, 2 * s + 1), (f, 2 + f)  # the field and the samples group's ranks
    field = torch.arange(48, dtype=torch.float64, device="cuda").reshape(8, 6) ** 1.5
    got = dict(
        gather=coll.all_gather(x, fg, 1), gather_s=coll.all_gather(z, sg, 0),
        a2a=coll.all_to_all(x, fg, split_dim=1, concat_dim=0),
        a2a_c=coll.all_to_all(z, fg, split_dim=0, concat_dim=1),
        exchange=coll.exchange(z, fg, peer, peer), own=coll.exchange(x, fg, f, f),
        sum=coll.all_reduce(x, fg), max=coll.all_reduce(x, sg, op=dist.ReduceOp.MAX),
        hartley=distributed_hartley(mesh.own_rows(field), mesh))
    want = dict(
        gather=torch.cat([x_of(q) for q in row], 1), gather_s=torch.cat([z_of(q) for q in col]),
        a2a=torch.cat([x_of(q)[:, 3 * f:3 * f + 3] for q in row]),
        a2a_c=torch.cat([z_of(q)[2 * f:2 * f + 2] for q in row], 1),
        exchange=z_of(row[peer]), own=x, sum=x_of(row[0]) + x_of(row[1]),
        max=torch.maximum(x_of(col[0]), x_of(col[1])), hartley=mesh.own_rows(hartley(field)))
    return {k: (got[k].cpu().numpy(), want[k].cpu().numpy()) for k in got}


def from_numpy_case(tree, samples, field):
    """``from_numpy(tree, mesh=)``: a global numpy tree becomes this rank's
    part (its rows of the field-sharded leaves), with the layout recorded."""
    mesh = make_mesh(samples, field)
    local = jt.from_numpy(tree, device="cpu", mesh=mesh)
    return dict(local=jt.to_numpy(local), index=mesh.index(mesh.field_axis),
                sharded=mesh.field_flags(local, len(tree_leaves(local))))


# -- 3-D tomography and ICR on a mesh ------------------------------------------------


def tomography_problem(data, noise_std, pos, mesh, dims=(16, 16, 16), n_rays=48, n_points=64,
                       ray_seed=7):
    """``tests/test_tomography_3d.py``'s ``_tomography_setup``: a 3-D
    correlated field with the pencil Hartley, ``exp``, then the line of
    sight through ``n_rays`` rays between uniform points (numpy, from
    ``ray_seed``); a Gaussian of ``noise_std`` on ``data``, placed on the
    mesh (the forward model holds the field and the response as
    submodules, so that both take their slabs)."""
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1), loglogavgslope=(-4.0, 5e-1),
        flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2))
    cf = cfm.finalize(hartley_fn=lambda x, axes=None: distributed_hartley(x, mesh, axes=axes),
                      device="cpu")
    rng = np.random.default_rng(ray_seed)
    start = rng.uniform(0.05, 0.95, size=(n_rays, len(dims)))
    end = rng.uniform(0.05, 0.95, size=(n_rays, len(dims)))
    los = jt.SamplingCartesianGridLOS(start, end, shape=dims,
                                      distances=tuple(1.0 / d for d in dims),
                                      n_sampling_points=n_points, device="cpu")
    fwd = jt.Model(lambda x: los(torch.exp(cf(x))), domain=cf.domain, init=cf.init)
    fwd.cf, fwd.los = cf, los
    lh = jt.Gaussian(torch.from_numpy(data),
                     noise_cov_inv=lambda x: x / noise_std ** 2).amend(fwd)
    lh = shard_position(lh, mesh)
    return lh, jt.from_numpy(pos, device="cpu", mesh=mesh)


def tomography_update_case(data, noise_std, pos, key, samples, field, sample_mode,
                           nl_maxiter, budgets, det=False, n_samples=2, x64=True):
    """One ``OptimizeVI.update`` of the 16^3 tomography on a samples x
    field mesh, its noise replayed from a table of recorded draws or drawn
    from an int seed (``key``), in float64 or (``x64=False``) float32; the
    global samples, the KL energy and the collectives of the update by
    kind."""
    from nifty_tpu_torch.parallel import collectives as coll

    jt.config.update("deterministic_reductions", det)
    jt.config.update("enable_x64", x64)
    mesh = make_mesh(samples, field)
    lh, p = tomography_problem(data, noise_std, pos, mesh)
    opt = jt.OptimizeVI(lh, n_total_iterations=1)
    key = ReplayKey(key) if isinstance(key, dict) else jt.HostKey(key)
    state = opt.init_state(key, **_vi_kwargs(budgets, nl_maxiter, n_samples, sample_mode))
    coll.reset_counts()
    smp, state = opt.update(jt.Samples(pos=p, samples=None, keys=None), state)
    counts = dict(coll.COUNTS)
    whole = gather_samples(smp, mesh)
    return dict(samples=jt.to_numpy(whole._samples), pos=jt.to_numpy(whole.pos),
                fun=float(state.minimization_state.fun), nit=int(state.minimization_state.nit),
                collectives=counts, slab=tuple(p["cfxi"].shape))


def tomography_stages_case(data, noise_std, pos, tan, samples, field):
    """The 16^3 tomography's energy and a metric matvec (gathered) on a
    samples x field mesh."""
    mesh = make_mesh(samples, field)
    lh, p = tomography_problem(data, noise_std, pos, mesh)
    t = jt.from_numpy(tan, device="cpu", mesh=mesh)
    return dict(energy=float(lh(p)),
                metric=jt.to_numpy(pmesh.gather_position(lh.metric(p, t), mesh)))


def los_slab_case(f, ybar, field, det, start, end, dims, n_points):
    """The line of sight placed on a 1 x ``field`` mesh: its forward of the
    rank's rows of fields ``f`` (B, *dims) and the gradient of ``<y,
    ybar>`` (the slab adjoint, by autograd), gathered; the collectives of
    each by kind and bytes, and the slab's virtual rays by lane count."""
    from nifty_tpu_torch.parallel import collectives as coll

    jt.config.update("deterministic_reductions", det)
    mesh = make_mesh(1, field)
    los = jt.SamplingCartesianGridLOS(start, end, shape=dims,
                                      distances=tuple(1.0 / d for d in dims),
                                      n_sampling_points=n_points, device="cpu")
    shard_position(los, mesh)
    x = mesh.own_rows(torch.from_numpy(f), dim=1).requires_grad_(True)
    coll.reset_counts()
    y = los(x)
    fwd = (dict(coll.COUNTS), dict(coll.BYTES))
    coll.reset_counts()
    (y * torch.from_numpy(ybar)).sum().backward()
    adj = (dict(coll.COUNTS), dict(coll.BYTES))
    slab = los.slab(torch.float64)
    return dict(y=_np(y.detach()), grad=_gathered(x.grad, mesh, dim=1), forward=fwd, adjoint=adj,
                rows=slab.rows, groups=slab.groups, n_virtual=slab.n_virtual)


def icr_chart(chart_shape=(14,), depth=3):
    """A 1-D chart refined ``depth`` times, demo 9's log deformation."""
    return jt.CoordinateChart(shape0=chart_shape, depth=depth, distances0=(1.0,),
                              nonlinear_map=lambda reg: np.expm1(0.35 * reg))


def icr_problem(data, noise_std, chart_shape, depth):
    """:func:`icr_chart`'s field with a Matern-3/2 kernel, ``exp(0.5
    field)`` observed everywhere with ``noise_std`` on ``data``."""
    field = jt.RefinementField(icr_chart(chart_shape, depth),
                               lambda r: (1.0 + r) * torch.exp(-r), device="cpu")
    signal = jt.Model(lambda x: torch.exp(0.5 * field(x)), domain=field.domain,
                      init=field.init)
    signal.field = field
    return jt.Gaussian(torch.from_numpy(data),
                       noise_cov_inv=lambda x: x / noise_std ** 2).amend(signal)


def icr_update_case(data, noise_std, pos, seed, samples, chart_shape=(14,), depth=3,
                    budgets=(20, 10, 3, 10), maps="smap"):
    """One geoVI update of the 1-D ICR field with the samples over a
    ``samples`` x 1 mesh, under ``deterministic_reductions``: its latents
    stay whole on every rank.  ``maps``: the residual and KL maps (the
    sample loop, which "auto" takes on a card mesh)."""
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, 1)
    lh = shard_position(icr_problem(data, noise_std, chart_shape, depth), mesh)
    p = shard_position(jt.from_numpy(pos, device="cpu"), mesh)
    opt = jt.OptimizeVI(lh, n_total_iterations=1, residual_map=maps, kl_map=maps)
    state = opt.init_state(jt.HostKey(seed), **_vi_kwargs(budgets, 2, 2, "nonlinear_resample"))
    smp, state = opt.update(jt.Samples(pos=p), state)
    return _whole(smp, state, mesh)
