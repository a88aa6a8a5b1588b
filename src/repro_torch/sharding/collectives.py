"""The collectives the sharded forwards need, over one process group (a
mesh axis's, or the data-parallel one): the serving forward's, which carry
no gradient, and the training forward's, which do.

Every one is built from ``all_reduce`` alone, which NCCL takes on the card
and gloo takes on CPU and CUDA tensors alike, so the same code runs under
either backend; under NCCL each is one collective a CUDA graph can capture
on the calling stream. None reads a tensor back to the host. Under NCCL a
group of one rank still issues its collective (a 1x1 mesh exercises them
for real, inside the graphs); under gloo, whose every call synchronizes
the host with the card, it is skipped: over one rank a reduction is the
identity.

  * ``all_reduce_sum`` / ``all_reduce_max``: in place, the tensor's dtype;
  * ``all_gather``: the ranks' blocks concatenated along a dim, exact to
    the bit — each rank writes its block's BYTES into a zero buffer and the
    buffers are summed as ``uint8`` (one non-zero term a byte: no carry, no
    rounding, a ``-0.0`` or a NaN payload kept);
  * ``combine``: the same byte sum of blocks that are zero (as bits) on all
    ranks but one — the vocab-parallel embedding's rows;
  * ``argmax``: the greedy pick over vocab shards — each rank's max and its
    global index, the max of the maxes, then the least global index that
    holds it: ties go to the lower index, as ``torch.argmax`` and
    ``jnp.argmax`` break them.

The training forward's (``torch.autograd.Function`` pairs, each a forward
and its backward, the same collectives):

  * ``fsdp_gather``: a parameter's blocks gathered along a dim (forward);
    the gradient summed over the data-parallel group and cut to this
    rank's block (backward) — FSDP's just-in-time gather;
  * ``grad_sum``: the identity forward, the gradient summed over the group
    backward — Megatron's *f* before a column-parallel projection (and a
    replicated leaf's data-parallel reduction);
  * ``sum_forward``: the sum over the group forward, the identity backward
    — Megatron's *g* after a row-parallel one;
  * ``gather_forward``: the blocks gathered forward, this rank's block of
    the gradient backward — a leaf a layer does not run partitioned, the
    heads of a head-parallel attention before a whole projection, and the
    sequence gather of context parallelism;
  * ``scatter_forward``: this rank's block forward, the blocks gathered
    backward — a replicated tensor cut to this rank's heads, rows or
    columns.

``record_collectives()`` counts them: inside it, each LOGICAL collective
above reports its kind — as XLA names it: ``all-reduce``, ``all-gather``
— and the bytes of its result on this rank, whatever ``all_reduce``
carries it (a gather is an all-reduce of an n-fold buffer, and counts as
a gather), and appends one event ``(kind, dtype, shape, bytes)`` of that
result (the graph linter matches the shapes against the KV pool's). FSDP's gradient sum counts as what the port runs, an
all-reduce of the whole gradient over the data-parallel group: n times
the block that XLA's reduce-scatter would leave. A collective over a
group of one rank moves nothing and is not counted. The dry-run reads
collective bytes from it, as the reference's parses them out of the HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist

#: the kinds a logical collective reports as (XLA's names)
KINDS = ("all-gather", "all-reduce")


@dataclasses.dataclass
class CollectiveRecord:
    """Per kind, the result bytes on this rank and the count of the
    collectives reported; ``total`` the bytes of every kind; ``events``
    each collective in order, ``(kind, dtype, shape, bytes)`` of its
    result (``dtype`` a ``torch.dtype``, ``shape`` a tuple)."""
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    events: list = dataclasses.field(default_factory=list)

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


# the open records: the autograd engine may run a backward (and its
# collectives) on a thread of its own, which no context variable reaches
_RECORDS: list = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """A ``CollectiveRecord`` of every collective reported while the block
    runs, on any thread."""
    rec = CollectiveRecord()
    with _LOCK:
        _RECORDS.append(rec)
    try:
        yield rec
    finally:
        with _LOCK:
            _RECORDS.remove(rec)


def _record(kind: str, dtype: torch.dtype, shape, group) -> None:
    """Report one logical collective whose result on this rank is a
    ``dtype`` tensor of ``shape``."""
    if not _RECORDS or dist.get_world_size(group) == 1:
        return
    shape = tuple(int(d) for d in shape)
    nbytes = math.prod(shape) * dtype.itemsize
    with _LOCK:
        for rec in _RECORDS:
            rec.bytes[kind] += nbytes
            rec.counts[kind] += 1
            rec.events.append((kind, dtype, shape, nbytes))


def _report(kind: str, x: torch.Tensor, group) -> None:
    """Report a collective whose result has ``x``'s dtype and shape."""
    _record(kind, x.dtype, x.shape, group)


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` in place (skipped over one gloo rank); returns
    ``x``. Reports nothing: the logical collective that calls it does."""
    if dist.get_world_size(group) > 1 or dist.get_backend(group) != "gloo":
        dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place; returns ``x``."""
    _report("all-reduce", x, group)
    return _reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, in place; returns ``x``."""
    _report("all-reduce", x, group)
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along ``dim``
    in rank order, bit for bit."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.ndim
    _record("all-gather", x.dtype, x.shape[:dim] + (n * x.shape[dim],)
            + x.shape[dim + 1:], group)
    x = x.movedim(dim, 0).contiguous()
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[r] = x
    _reduce(buf.view(torch.uint8), dist.ReduceOp.SUM, group)
    out = buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out.movedim(0, dim)


def combine(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of tensors of which each element is non-zero
    (as bits) on at most one rank — a vocab-parallel lookup's rows —
    exactly: their bytes are summed as ``uint8``. Returns a new tensor."""
    out = x.contiguous().clone()
    _report("all-reduce", out, group)
    _reduce(out.view(torch.uint8), dist.ReduceOp.SUM, group)
    return out


def argmax(logits: torch.Tensor, offset: int, group) -> torch.Tensor:
    """The global argmax along the last dim of vocab-sharded ``logits``
    (this rank's columns ``offset ..``): int64, ties to the lower global
    index; the same on every rank."""
    local = logits.float()
    best, idx = local.max(dim=-1)
    idx = idx + offset
    top = all_reduce_max(best.clone(), group)
    big = torch.iinfo(torch.int64).max
    cand = torch.where(best == top, idx, torch.full_like(idx, big))
    _report("all-reduce", cand, group)
    _reduce(cand, dist.ReduceOp.MIN, group)
    # a row whose max is NaN on some rank: no rank's value equals the
    # reduced max; the row is quarantined by the non-finite flag, and its
    # token (the same on every rank) is never read
    return torch.where(cand == big, torch.zeros_like(cand), cand)


def any_true(flags: torch.Tensor, group) -> torch.Tensor:
    """The elementwise OR of a bool tensor over ``group``."""
    x = flags.to(torch.int32)
    all_reduce_max(x, group)
    return x.bool()


def block_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``group`` (a view)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad_group):
        ctx.dim, ctx.group, ctx.grad_group = dim, group, grad_group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        _report("all-reduce", g, ctx.grad_group)
        g = _reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.grad_group)
        return block_of(g, ctx.dim, ctx.group).contiguous(), None, None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return block_of(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block_of(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


def fsdp_gather(x: torch.Tensor, dim: int, group, grad_group) -> torch.Tensor:
    """``x``'s blocks over ``group`` concatenated along ``dim``; backward,
    the gradient summed over ``grad_group`` (the data-parallel ranks, a
    pod axis's too) and cut to this rank's block."""
    return _FSDPGather.apply(x, dim % x.ndim, group, grad_group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; backward, its gradient summed over ``group``."""
    return _GradSum.apply(x, group)


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); backward, the
    gradient passes unchanged."""
    return _SumForward.apply(x, group)


def gather_forward(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s blocks over ``group`` concatenated along ``dim``; backward,
    this rank's block of the gradient."""
    return _GatherForward.apply(x, dim % x.ndim, group)


def scatter_forward(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` the same on every
    rank of ``group``); backward, the ranks' gradient blocks gathered."""
    return _ScatterForward.apply(x, dim % x.ndim, group)
