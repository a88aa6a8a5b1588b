"""The few collectives the sharded serving forward needs, over one process
group (a mesh axis's, or the data-parallel one).

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
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` in place (skipped over one gloo rank); returns
    ``x``."""
    if dist.get_world_size(group) > 1 or dist.get_backend(group) != "gloo":
        dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place; returns ``x``."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, in place; returns ``x``."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along ``dim``
    in rank order, bit for bit."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.ndim
    x = x.movedim(dim, 0).contiguous()
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[r] = x
    all_reduce_sum(buf.view(torch.uint8), group)
    out = buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out.movedim(0, dim)


def combine(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of tensors of which each element is non-zero
    (as bits) on at most one rank — a vocab-parallel lookup's rows —
    exactly: their bytes are summed as ``uint8``. Returns a new tensor."""
    out = x.contiguous().clone()
    all_reduce_sum(out.view(torch.uint8), group)
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
