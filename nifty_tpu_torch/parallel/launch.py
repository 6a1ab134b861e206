"""Start a world of processes, one rank each, and collect their results.

:func:`run_world` spawns ``nprocs`` processes with
``torch.multiprocessing`` (``spawn``, never ``fork``: a forked child of a
process that touched CUDA cannot use the card).  Each joins a
``torch.distributed`` world through a rendezvous file of its own (no
port to pick, so worlds started together cannot collide;
:func:`~nifty_tpu_torch.parallel.mesh.initialize_distributed`), runs
``fn(*args)`` and hands back what it returns (through a file in a
temporary directory, with ``torch.save``).  The world has a wall-clock
timeout: when it passes, every process still running is killed and the
call raises, so a rank stuck in a collective fails fast.  The rendezvous
and every collective have a timeout of their own as well.

``fn`` must be importable by the children (a function at the top level
of a module).  Build the CUDA kernels in the parent before spawning, so
the ranks load the libraries instead of compiling them together.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, fn, args, nprocs, backend, device, threads, collective_timeout, outdir):
    import torch.distributed as dist

    from .. import config
    from .mesh import initialize_distributed

    try:
        if threads:
            torch.set_num_threads(threads)
        config.update("device", device)
        initialize_distributed(f"file://{os.path.join(outdir, 'rendezvous')}", nprocs, rank,
                               backend=backend, timeout=collective_timeout)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, nprocs: int, args=(), *, backend: str = "gloo", device: str = "cpu",
              timeout: float = 600.0, collective_timeout: float = 120.0,
              threads: int = 0) -> list:
    """``fn(*args)`` on each rank of a fresh world of ``nprocs`` processes;
    returns the ranks' results in rank order.

    ``backend``: ``"gloo"`` (CPU tensors, or several ranks sharing one
    card) or ``"nccl"`` (one card a rank).  ``device``: each rank's
    configured device (``"cuda"`` with NCCL binds rank r to card r).
    ``timeout``: seconds for the whole world; ``collective_timeout``: for
    the rendezvous and each collective.  ``threads``: intra-op threads a
    rank (0: torch's default).  Raises with the failing ranks' tracebacks
    if a rank fails or the world times out."""
    with tempfile.TemporaryDirectory(prefix="world_") as outdir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), nprocs, backend, device, threads,
                              collective_timeout, outdir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {nprocs} ranks did not finish in {timeout:.0f} s")
        except BaseException as err:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
            errs = []
            for r in range(nprocs):
                path = os.path.join(outdir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(f"world of {nprocs} ranks failed: {err}\n" + "\n".join(errs)) \
                from err
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


__all__ = ["run_world"]
