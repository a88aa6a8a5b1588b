"""AdamW with decoupled weight decay and global-norm clipping — port of
``repro.optim.adamw``.

Plain functions over trees of tensors (dicts, lists and tuples), not
``torch.optim``: the clip by the global norm of every gradient, Adam's
bias corrections and the rule that only leaves with ``ndim >= 2`` decay
are the JAX package's, term for term. The moments live on the
parameters' device.
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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in _leaves(tree)))


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: returns (new params, new state, the gradients'
    global norm before the clip). Every gradient is scaled by
    min(1, clip_norm / ‖g‖) first."""
    step = state.step + 1
    gn = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    scale = torch.clamp_max(gn.new_tensor(clip_norm)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    grads = _map(lambda g: g.float() * scale, grads)

    m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
    v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state.v, grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m_, v_):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0  # no decay on norms/biases
        pf = p.float()
        return (pf - lr * (u + decay * pf)).to(p.dtype)

    new_params = _map(upd, params, m, v)
    return new_params, AdamWState(step, m, v), gn
