"""The collectives of a mesh, and the ``torch.autograd.Function`` pairs
that carry derivatives across them.

A mesh axis is a ``torch.distributed`` process group (``None`` for an axis
of one rank, where every collective is the identity and nothing is
sent).  The transport is the group's backend:

- NCCL runs every collective on the card's tensors;
- gloo, whose ranks may share one card (NCCL refuses two ranks on one
  GPU), keeps a tensor on the card in the card's memory: each rank holds
  two mailboxes that the group's ranks map by CUDA IPC, a sender copies
  into the receiver's mailbox, and gloo carries only a barrier a
  collective (every rank of the group must then use one card).  Copying
  through the host instead took 304-328 ms a 4096^2 pencil Hartley
  transform of two ranks on an H100, against 8 ms through the mailboxes
  (``PERF.md``).

Nothing falls back: a collective that fails raises.  Every call is
counted by kind with the bytes its input holds (:data:`COUNTS`,
:data:`BYTES`, :func:`reset_counts`), so a run can report the collectives
of an update.

Derivatives follow one convention: a *replicated* tensor (equal on every
rank of the group) has a gradient that is equal on every rank and whole;
a *sharded* tensor (each rank its own block) has its rank's block of the
gradient.  Under it the pairs are each other's transposes:

- :class:`SumAcross` (all-reduce of rank partials into a replicated sum)
  and :class:`CopyAcross` (a replicated tensor used by rank-local work:
  the identity, whose gradient sums the ranks' partial gradients);
- :class:`GatherAcross` (the ranks' blocks concatenated into a replicated
  tensor) and :class:`OwnBlock` (a rank's block of a replicated tensor).

The gradient of an all-reduced value is therefore the identity, not a
second all-reduce (``torch.distributed.nn.functional.all_reduce`` would
sum the equal gradients again, p times too large).  Each ``backward``
calls the other Function's ``apply``, so the double backward of the
metric's linearization crosses the same collectives; each has ``jvp`` and
``vmap``.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

#: Collective calls by kind, and the bytes of their inputs, since the last
#: :func:`reset_counts`.
COUNTS: Counter = Counter()
BYTES: Counter = Counter()


def reset_counts():
    COUNTS.clear()
    BYTES.clear()


def _count(kind: str, x: torch.Tensor):
    COUNTS[kind] += 1
    BYTES[kind] += x.numel() * x.element_size()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _ipc(group, x: torch.Tensor) -> bool:
    """Whether ``x`` moves through the group's CUDA IPC mailboxes (a tensor
    on the card in a gloo group); else the backend takes it as it is."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


class _Mailboxes:
    """The CUDA IPC route of one gloo group: two mailboxes a rank, each of p
    slots, mapped by every rank of the group.  A collective writes into
    the receivers' slots of one mailbox, synchronizes its stream, meets the
    others at a barrier and reads its own mailbox; the next collective uses
    the other mailbox, so one barrier a collective keeps a mailbox from
    being written while it is read (a rank reaches the next barrier only
    after its reads are done)."""

    def __init__(self, group):
        self.group, self.p, self.me = group, group_size(group), group_rank(group)
        self.slot, self.turn, self.mine, self.boxes = 0, 0, None, None

    def _grow(self, slot: int, device):
        from torch.multiprocessing.reductions import reduce_tensor

        self.mine = [torch.empty(self.p * slot, dtype=torch.uint8, device=device)
                     for _ in range(2)]
        handles = all_gather_object([reduce_tensor(b) for b in self.mine], self.group)
        self.boxes = [[], []]
        for j, shared in enumerate(handles):
            for k, (rebuild, args) in enumerate(shared):
                self.boxes[k].append(self.mine[k] if j == self.me else rebuild(*args))
        self.slot = slot

    def post(self, sends: dict, nbytes: int, device):
        """Copy ``sends[j]`` (uint8, ``nbytes`` each) into slot ``me`` of
        rank j's mailbox; returns this rank's mailbox as (p, nbytes)
        once every rank has posted.  All ranks call it with one size."""
        if nbytes > self.slot:
            self._grow(nbytes, device)
        boxes = self.boxes[self.turn]
        self.turn ^= 1
        at = self.me * self.slot
        for j, data in sends.items():
            boxes[j][at:at + nbytes].copy_(data)
        torch.cuda.current_stream(device).synchronize()
        dist.barrier(group=self.group)
        return boxes[self.me].view(self.p, self.slot)[:, :nbytes]


_MAILBOXES: dict = {}


def _mailboxes(group) -> _Mailboxes:
    box = _MAILBOXES.get(group)
    if box is None:
        box = _MAILBOXES[group] = _Mailboxes(group)
    return box


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return _real(x.contiguous()).reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """A copy of the bytes ``b`` as a tensor of ``like``'s dtype and
    ``shape``."""
    out = b.contiguous().view(like.real.dtype if like.is_complex() else like.dtype)
    if like.is_complex():
        out = torch.view_as_complex(out.reshape(-1, 2))
    return out.reshape(shape).clone()


def _real(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its real pairs (conjugation resolved)."""
    return torch.view_as_real(x.resolve_conj()) if x.is_complex() else x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order.  Without a group, ``x`` in the layout a group's result has
    (contiguous): a float32 sum's bits follow its input's strides, so a
    mesh without a world computes as a world of one rank does."""
    if group is None:
        return x.contiguous()
    p = group_size(group)
    _count("all_gather", x)
    xs = x.movedim(dim, 0).contiguous()
    if _ipc(group, xs):
        data = _as_bytes(xs)
        got = _mailboxes(group).post({j: data for j in range(p)}, data.numel(), xs.device)
        out = _from_bytes(got, xs, (p * xs.shape[0],) + tuple(xs.shape[1:]))
        return out.movedim(0, dim).contiguous()
    out = xs.new_empty((p * xs.shape[0],) + tuple(xs.shape[1:]))
    if xs.is_cuda:
        dist.all_gather_into_tensor(_real(out), _real(xs), group=group)
    else:
        parts = list(_real(out).chunk(p))
        dist.all_gather(parts, _real(xs), group=group)
    # contiguous, so that what follows sees the layout a single rank's
    # tensor has (a local FFT's bits can depend on its input's strides)
    return out.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise sum (or ``op``) of the ranks' ``x``, on every rank;
    ``x`` is not changed."""
    out = x.clone(memory_format=torch.contiguous_format)
    if group is None:
        return out
    _count("all_reduce", x)
    if _ipc(group, x):
        data = _as_bytes(out)
        got = _mailboxes(group).post({j: data for j in range(group_size(group))}, data.numel(),
                                     x.device)
        parts = _from_bytes(got, out, (group_size(group),) + tuple(out.shape))
        if op == dist.ReduceOp.SUM:
            acc = parts[0]
            for q in parts[1:]:
                acc = acc + q
            return acc
        if op == dist.ReduceOp.MAX:
            return parts.amax(dim=0)
        raise ValueError(f"a gloo group on the card reduces by SUM or MAX, not {op}")
    dist.all_reduce(_real(out), op=op, group=group)
    return out


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut along ``split_dim`` into p equal chunks,
    chunk j sent to rank j, and the chunks received concatenated along
    ``concat_dim`` in rank order.  Without a group, ``x`` contiguous, as a
    group's result is (see :func:`all_gather`)."""
    if group is None:
        return x.contiguous()
    p = group_size(group)
    _count("all_to_all", x)
    xs = x.movedim(split_dim, 0)
    n = xs.shape[0]
    if n % p:
        raise ValueError(f"all_to_all: axis of {n} is not divisible by {p} ranks")
    rest = tuple(xs.shape[1:])
    xs = xs.reshape((p, n // p) + rest).contiguous()
    if _ipc(group, xs):
        chunks = _as_bytes(xs).view(p, -1)
        got = _mailboxes(group).post({j: chunks[j] for j in range(p)}, chunks.shape[1],
                                     xs.device)
        out = _from_bytes(got, xs, xs.shape)
    else:
        out = torch.empty_like(xs)
        dist.all_to_all_single(_real(out), _real(xs), group=group)
    # (p, chunk, ...rest) with the split axis back in place, then the block
    # axis merged into concat_dim
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
    return out.reshape(shape).contiguous()


def exchange(x: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Point to point: ``x`` sent to group rank ``send_to`` while a tensor
    of its shape is received from group rank ``recv_from``."""
    xs = x.contiguous()
    if group is not None and _ipc(group, xs):
        # every rank of the group meets at the mailbox's barrier, also one
        # that sends to itself
        _count("send_recv", x)
        data = _as_bytes(xs)
        got = _mailboxes(group).post({send_to: data}, data.numel(), xs.device)
        return _from_bytes(got[recv_from], xs, xs.shape)
    me = group_rank(group)
    if send_to == me and recv_from == me:
        return x.clone()
    _count("send_recv", x)
    out = torch.empty_like(xs)
    ops = [dist.P2POp(dist.isend, _real(xs), dist.get_global_rank(group, send_to), group),
           dist.P2POp(dist.irecv, _real(out), dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_gather_object(obj, group) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if group is None:
        return [obj]
    out = [None] * group_size(group)
    COUNTS["all_gather_object"] += 1
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group):
    if group is not None:
        dist.barrier(group=group)


# -- autograd pairs ---------------------------------------------------------


def _moved(x, in_dims):
    """``x`` with its vmap batch dimension in front (a new leading axis)."""
    return x.movedim(in_dims[0], 0)


class SumAcross(torch.autograd.Function):
    """Rank partials -> their replicated sum; gradient: the identity."""

    @staticmethod
    def forward(x, group):
        return all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return CopyAcross.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return SumAcross.apply(t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return SumAcross.apply(_moved(x, in_dims), group), 0


class CopyAcross(torch.autograd.Function):
    """A replicated tensor used by rank-local work: the identity, whose
    gradient is the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return SumAcross.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return CopyAcross.apply(t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return CopyAcross.apply(_moved(x, in_dims), group), 0


class GatherAcross(torch.autograd.Function):
    """The ranks' blocks of a sharded tensor concatenated along ``dim``, on
    every rank; gradient: the rank's block."""

    @staticmethod
    def forward(x, group, dim):
        return all_gather(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return OwnBlock.apply(g, ctx.group, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return GatherAcross.apply(t, ctx.group, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        return GatherAcross.apply(_moved(x, in_dims), group, dim + 1), 0


class OwnBlock(torch.autograd.Function):
    """A rank's block along ``dim`` of a replicated tensor; gradient: the
    blocks' gradients gathered."""

    @staticmethod
    def forward(x, group, dim):
        p = group_size(group)
        n = x.shape[dim] // p
        return x.narrow(dim, group_rank(group) * n, n).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return GatherAcross.apply(g.contiguous(), ctx.group, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return OwnBlock.apply(t, ctx.group, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        return OwnBlock.apply(_moved(x, in_dims), group, dim + 1), 0


__all__ = [
    "BYTES", "COUNTS", "CopyAcross", "GatherAcross", "OwnBlock", "SumAcross",
    "all_gather", "all_gather_object", "all_reduce", "all_to_all", "barrier",
    "exchange", "group_rank", "group_size", "reset_counts",
]
