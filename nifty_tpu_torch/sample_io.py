"""Sample persistence, export and checkpoints (counterpart of
:mod:`nifty_tpu.sample_io` and of the pickle checkpoint of
:mod:`nifty_tpu.optimize_kl`).

Files are pickles of host numpy arrays, exact for every dtype, so a run
resumed from a checkpoint continues with the bits an uninterrupted run
has.  Keys survive: int seeds and noise providers (:class:`~nifty_tpu_torch
.tree.HostKey`, or any picklable provider) as they are, a
``torch.Generator`` as its device and state.  Loading places the arrays on
the configured default device unless a device is named.

The exports apply operator callables to every sample and write host numpy
results: ``{name}/{mean,std,samples}`` HDF5 datasets (h5py, imported where
it is used) and minimal single-HDU FITS images, whose writer is the JAX
package's own (astropy is not needed).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from . import config
from .evi import Samples
from .tree import tree_map


class _StoredGenerator:
    """A ``torch.Generator`` on the way through a file."""

    def __init__(self, gen: torch.Generator):
        self.device = str(gen.device)
        self.state = gen.get_state().cpu().numpy()

    def restore(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(torch.from_numpy(self.state.copy()))
        return gen


def _store_leaf(x):
    if isinstance(x, torch.Generator):
        return _StoredGenerator(x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x


def _restore_leaf(x, device):
    if isinstance(x, _StoredGenerator):
        return x.restore()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy()).to(device)
    return x


def _store(tree):
    return tree_map(_store_leaf, tree)


def _restore(tree, device):
    return tree_map(lambda x: _restore_leaf(x, device), tree)


def _samples_payload(samples: Samples) -> dict:
    keys = samples.keys
    return dict(
        pos=_store(samples.pos),
        samples=_store(samples._samples),
        keys=None if keys is None else _store(list(keys)),
    )


def _samples_from_payload(payload: dict, device) -> Samples:
    return Samples(
        pos=_restore(payload["pos"], device),
        samples=_restore(payload["samples"], device),
        keys=_restore(payload["keys"], device),
    )


def _device(device):
    return torch.device(device) if device is not None else config.default_device()


def save_samples(samples: Samples, path: str):
    """Pickle a host copy of the samples (position, residuals, keys)."""
    with open(path, "wb") as f:
        pickle.dump(_samples_payload(samples), f)


def load_samples(path: str, *, device=None) -> Samples:
    with open(path, "rb") as f:
        return _samples_from_payload(pickle.load(f), _device(device))


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _op_outputs(samples: Samples, op: Callable, mesh=None, name="") -> np.ndarray:
    """``op`` of every sample (of the position where there are none),
    stacked on the host.

    On a ``mesh`` every rank calls it and gets the global stack: the
    outputs of a rank's samples (its block of the stacked rows) are
    gathered over the samples axis in rank order, which is the global
    sample order of one rank.  On a field axis of several ranks an output
    is gathered along its first axis where it is a known slab
    (:func:`_field_slab`), and kept where it is the same on every field
    rank."""
    with torch.no_grad():
        if len(samples):
            outs = torch.stack([torch.as_tensor(op(s)) for s in samples])
        else:
            outs = torch.as_tensor(op(samples.pos))[None]
        if mesh is not None:
            from .parallel import collectives as coll

            if mesh.size(mesh.field_axis) > 1 and _field_slab(outs, mesh, name):
                outs = coll.all_gather(outs, mesh.group(mesh.field_axis), dim=1)
            if len(samples) and mesh.size(mesh.sample_axis) > 1:
                outs = coll.all_gather(outs, mesh.group(mesh.sample_axis), dim=0)
    return _host(outs)


def _field_slab(outs: torch.Tensor, mesh, name: str) -> bool:
    """Whether the stacked outputs ``outs`` of a field rank are its slab of
    a field (``True``) or the same on every field rank (``False``).  A slab
    has at least two axes, and its first axis times the field extent
    gives the global shape of a leaf that the mesh field-shards (a latent
    or a data leaf placed with
    :func:`~nifty_tpu_torch.parallel.mesh.shard_position`); its bits
    differ between the field ranks.  An output of neither kind (say, a
    field cut to one axis, or a replicated table of a slab's shape) raises:
    its layout is unknown."""
    from .parallel import collectives as coll

    p, shape = mesh.size(mesh.field_axis), tuple(outs.shape[1:])
    slab = len(shape) >= 2 and (shape[0] * p,) + shape[1:] in mesh.field_shapes()
    host = np.ascontiguousarray(_host(outs))
    digest = (host.shape, str(host.dtype), hashlib.sha256(host.tobytes()).hexdigest())
    same = len(set(coll.all_gather_object(digest, mesh.group(mesh.field_axis)))) == 1
    if slab != same:
        return slab
    raise ValueError(
        f"operator output {name!r} of shape {shape} a sample on a field axis of {p} ranks: "
        + ("a slab's shape, but the same on every field rank" if slab else
           "different on the field ranks, but no slab of a field-sharded leaf")
        + "; its layout is unknown, so it is not exported")


def save_samples_to_hdf5(samples: Samples, path: str,
                         ops: Mapping[str, Callable], *,
                         overwrite: bool = False,
                         samples_datasets: bool = True):
    """Write ``{name}/{mean,std,samples}`` datasets of operator outputs.

    On an active mesh every rank calls it: the outputs are gathered
    (:func:`_op_outputs`) and rank 0 alone writes the file, with the
    datasets one rank holding every sample and the whole field writes."""
    from .parallel.mesh import active_mesh

    mesh = active_mesh()
    outputs = {name: _op_outputs(samples, op, mesh, name) for name, op in ops.items()}
    if mesh is not None and not mesh.is_root:
        return
    import h5py

    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    with h5py.File(path, "w") as f:
        for name, outs in outputs.items():
            grp = f.create_group(str(name))
            grp.create_dataset("mean", data=outs.mean(axis=0))
            if outs.shape[0] > 1:
                grp.create_dataset("std", data=outs.std(axis=0, ddof=1))
            if samples_datasets:
                grp.create_dataset("samples", data=outs)


def _fits_card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:8s}= {v:>20s}"
    elif isinstance(value, (int, float)):
        card = f"{key:8s}= {value:>20}"
    elif value is None:
        card = f"{key:8s}"
    else:
        card = f"{key:8s}= '{value}'"
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80)


def write_fits(path: str, array, *, overwrite: bool = False,
               extra_header: Optional[Mapping] = None):
    """Write a minimal single-HDU FITS image (float64, big-endian)."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    data = np.asarray(_host(array), dtype=">f8")
    cards = [
        _fits_card("SIMPLE", True, "conforms to FITS standard"),
        _fits_card("BITPIX", -64),
        _fits_card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_fits_card(f"NAXIS{i + 1}", int(n)))
    for k, v in (extra_header or {}).items():
        cards.append(_fits_card(str(k)[:8].upper(), v))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * ((2880 - len(header) % 2880) % 2880)
    payload = data.tobytes()
    payload += b"\0" * ((2880 - len(payload) % 2880) % 2880)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def read_fits(path: str) -> np.ndarray:
    """Read back a FITS image written by :func:`write_fits`."""
    with open(path, "rb") as f:
        raw = f.read()
    header = raw[: raw.index(b"END")].decode("ascii", errors="ignore")
    cards = {c.split("=")[0].strip(): c.split("=", 1)[1].split("/")[0].strip()
             for c in [header[i:i + 80] for i in range(0, len(header), 80)]
             if "=" in c}
    naxis = int(cards["NAXIS"])
    shape = tuple(int(cards[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    n_header_blocks = (raw.index(b"END") // 2880) + 1
    data = np.frombuffer(
        raw[2880 * n_header_blocks:
            2880 * n_header_blocks + 8 * int(np.prod(shape))],
        dtype=">f8",
    )
    return data.reshape(shape)


def save_samples_to_fits(samples: Samples, file_name_base: str,
                         op: Callable, *, overwrite: bool = False,
                         samples_files: bool = False):
    """Write mean/std (and optionally per-sample) FITS images of ``op``."""
    outs = _op_outputs(samples, op)
    write_fits(file_name_base + ".mean.fits", outs.mean(0), overwrite=overwrite)
    if outs.shape[0] > 1:
        write_fits(file_name_base + ".std.fits", outs.std(0, ddof=1), overwrite=overwrite)
    if samples_files:
        for i, o in enumerate(outs):
            write_fits(f"{file_name_base}.sample_{i}.fits", o, overwrite=overwrite)


def save_checkpoint(path: str, samples: Samples, state):
    """Write the resumable payload of a VI run: the samples with their
    keys, the iteration counter, the run's key and the solver states.  The
    per-iteration schedule (``state.config``) holds callables and is not
    stored; ``optimize_kl`` rebuilds it from its arguments."""
    payload = dict(
        samples=_samples_payload(samples),
        nit=int(state.nit),
        key=_store_leaf(state.key),
        sample_state=_store(state.sample_state),
        minimization_state=_store(state.minimization_state),
    )
    # written beside the target and moved over it, so a run cut while it
    # writes leaves the previous checkpoint whole
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str, *, device=None):
    """``(samples, state)`` of :func:`save_checkpoint`; ``state.config`` is
    ``None``."""
    from .optimize_kl import OptimizeVIState

    device = _device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    state = OptimizeVIState(
        nit=payload["nit"],
        key=_restore_leaf(payload["key"], device),
        sample_state=_restore(payload["sample_state"], device),
        minimization_state=_restore(payload["minimization_state"], device),
    )
    return _samples_from_payload(payload["samples"], device), state


# -- the sharded checkpoint --------------------------------------------------
#
# A directory: ``manifest.pt`` (rank 0: the world it was written on, the
# trees' structures with their global shapes, which leaves are
# field-sharded, the global keys, the iteration and the run's key) and one
# ``shard_s{s}_f{f}.pt`` a rank (its position slab, from the first rank of
# each field row only, and its rows of the residuals).  It is written
# beside its place as ``<path>.tmp`` and moved there whole.


def _shard_name(s: int, f: int) -> str:
    return f"shard_s{s}_f{f}.pt"


def save_sharded_checkpoint(path: str, samples: Samples, state, mesh=None):
    """Write the resumable payload of a VI run (samples with their keys,
    the iteration, the run's key) from every rank of ``mesh`` (default:
    the active one; without one, a single process).  Every rank calls it;
    it returns when the checkpoint is in place."""
    import shutil

    import torch.distributed as dist

    from .parallel import collectives as coll
    from .parallel.mesh import active_mesh
    from .tree import ShapeWithDtype, tree_leaves, tree_unflatten

    mesh = active_mesh() if mesh is None else mesh
    world = dist.group.WORLD if dist.is_initialized() else None
    root = mesh is None or mesh.is_root
    s, f = (0, 0) if mesh is None else (mesh.index(mesh.sample_axis), mesh.index(mesh.field_axis))
    ps, pf = (1, 1) if mesh is None else (mesh.size(mesh.sample_axis),
                                          mesh.size(mesh.field_axis))
    tmp = f"{path}.tmp"
    if root:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    coll.barrier(world)
    pos, resid = samples.pos, samples._samples
    pos_leaves = tree_leaves(pos)
    flags = [False] * len(pos_leaves) if mesh is None else mesh.field_flags(pos, len(pos_leaves))
    shard = dict(
        pos=[x.detach().cpu() for x in pos_leaves] if s == 0 else None,
        samples=None if resid is None else [x.detach().cpu() for x in tree_leaves(resid)],
    )
    torch.save(shard, os.path.join(tmp, _shard_name(s, f)))
    keys = samples.keys
    if keys is not None and mesh is not None:
        keys = [k for part in coll.all_gather_object(list(keys), mesh.group(mesh.sample_axis))
                for k in part]
    if root:
        def global_like(tree, leaves, stacked):
            """The global shapes: the stacked rows of every samples rank,
            the slabs of every field rank."""
            like = []
            for x, sharded in zip(leaves, flags):
                shape = list(x.shape)
                if stacked:
                    shape[0] *= ps
                if sharded:
                    shape[int(stacked)] *= pf
                like.append(ShapeWithDtype(tuple(shape), x.dtype))
            return tree_unflatten(tree, like)

        manifest = dict(
            world=(ps, pf), field_sharded=flags,
            pos_like=global_like(pos, pos_leaves, False),
            samples_like=None if resid is None else global_like(resid, tree_leaves(resid), True),
            keys=None if keys is None else _store(list(keys)),
            nit=int(state.nit), key=_store_leaf(state.key),
        )
        torch.save(manifest, os.path.join(tmp, "manifest.pt"))
    coll.barrier(world)
    if root:
        old = f"{path}.old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    coll.barrier(world)


def load_sharded_checkpoint(path: str, *, mesh=None, device=None):
    """``(samples, state)`` of :func:`save_sharded_checkpoint`, written on
    any world: the global trees are put together from the shards, then
    given ``mesh`` this rank takes its part
    (:func:`~nifty_tpu_torch.parallel.mesh.shard_samples`).  ``state``
    holds the iteration and the key; ``state.config`` is ``None``."""
    from .optimize_kl import OptimizeVIState
    from .parallel.mesh import shard_samples
    from .tree import tree_leaves, tree_unflatten

    device = _device(device)

    def load(name):
        return torch.load(os.path.join(path, name), weights_only=False)

    manifest = load("manifest.pt")
    ps, pf = manifest["world"]
    flags = manifest["field_sharded"]
    shards = {(s, f): load(_shard_name(s, f)) for s in range(ps) for f in range(pf)}
    def joined(part, i, s, dim):
        """Leaf ``i`` of samples rank ``s``: its field ranks' slabs joined."""
        if not flags[i]:
            return shards[s, 0][part][i]
        return torch.cat([shards[s, f][part][i] for f in range(pf)], dim=dim)

    pos = tree_unflatten(manifest["pos_like"], [
        joined("pos", i, 0, 0).to(device) for i in range(len(flags))])
    resid = None
    if manifest["samples_like"] is not None:
        resid = tree_unflatten(manifest["samples_like"], [
            torch.cat([joined("samples", i, s, 1) for s in range(ps)]).to(device)
            for i in range(len(flags))])
    keys = manifest["keys"]
    samples = Samples(pos=pos, samples=resid,
                      keys=None if keys is None else _restore(keys, device))
    if mesh is not None:
        samples = shard_samples(samples, mesh)
    state = OptimizeVIState(nit=manifest["nit"], key=_restore_leaf(manifest["key"], device))
    return samples, state


def save_checkpoint_orbax(path: str, samples: Samples, state=None):
    """The JAX package's orbax checkpoint call, writing the port's sharded
    checkpoint (:func:`save_sharded_checkpoint` on the active mesh; orbax
    is a JAX library).  Without ``state`` the iteration is 0 and the key
    ``None``."""
    from .optimize_kl import OptimizeVIState

    save_sharded_checkpoint(path, samples, OptimizeVIState(nit=0, key=None)
                            if state is None else state)


def load_checkpoint_orbax(path: str):
    """``(samples, aux)`` of :func:`save_checkpoint_orbax`: the global
    samples on the default device, ``aux`` holding the iteration
    (``"nit"``) and the run's key (``"key"``)."""
    samples, state = load_sharded_checkpoint(path)
    return samples, {"nit": state.nit, "key": state.key}


__all__ = ["load_checkpoint", "load_checkpoint_orbax", "load_samples", "load_sharded_checkpoint",
           "read_fits", "save_checkpoint", "save_checkpoint_orbax", "save_samples",
           "save_samples_to_fits", "save_samples_to_hdf5", "save_sharded_checkpoint",
           "write_fits"]
