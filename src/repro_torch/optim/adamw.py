"""AdamW with decoupled weight decay and global-norm clipping — port of
``repro.optim.adamw``.

Plain functions over trees of tensors (dicts, lists and tuples), not
``torch.optim``: the clip by the global norm of every gradient, Adam's
bias corrections and the rule that only leaves with ``ndim >= 2`` decay
are the JAX package's, term for term. The moments live on the
parameters' device.

Over a mesh (``sharding.train``) every tree holds this rank's blocks: the
update is elementwise, so it runs on the blocks as they are, and the clip's
global norm sums the squares of the blocks over the ranks (``group``), each
leaf counted on one rank of those holding the same block (``counted``): a
replicated norm or bias is counted once, not once a rank.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Any
    v: Any


def _map(fn: Callable, tree, *rest):
    """``jax.tree.map`` over dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def adamw_init(params) -> AdamWState:
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      _map(torch.clone, zeros))


def global_norm(tree, counted=None, group=None) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``. ``counted`` (bools beside
    the leaves) drops a leaf's squares on the ranks where it is False, and
    the sum is then taken over ``group``'s ranks before the root."""
    leaves = _leaves(tree)
    flags = _leaves(counted) if counted is not None else [True] * len(leaves)
    sq = sum(g.float().square().sum() if c
             else g.new_zeros((), dtype=torch.float32)
             for g, c in zip(leaves, flags))
    if group is not None:
        from ..sharding.collectives import all_reduce_sum

        sq = all_reduce_sum(sq, group)
    return torch.sqrt(sq)


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 counted=None, group=None, inplace: bool = False):
    """One AdamW step: returns (new params, new state, the gradients'
    global norm before the clip). Every gradient is scaled by
    min(1, clip_norm / ‖g‖) first; ``counted`` and ``group``: the norm of
    blocks over a mesh (``global_norm``). The update runs a leaf at a time
    into params and moments of its own: copies of the given ones, or with
    ``inplace`` the given ones themselves (the reference's donated
    buffers: no second copy of the state), which it returns."""
    step = state.step + 1
    gn = global_norm(grads, counted, group)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    scale = torch.clamp_max(gn.new_tensor(clip_norm)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    with torch.no_grad():
        params, m, v = ((params, state.m, state.v) if inplace else
                        (_map(torch.clone, t)
                         for t in (params, state.m, state.v)))
        for g, m_, v_, p in zip(_leaves(grads), _leaves(m), _leaves(v),
                                _leaves(params)):
            g = g.float() * scale
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g * g)
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            # no decay on norms and biases
            decay = weight_decay if p.ndim >= 2 else 0.0
            pf = p.float()
            p.copy_((pf - lr * (u + decay * pf)).to(p.dtype))
    return params, AdamWState(step, m, v), gn
