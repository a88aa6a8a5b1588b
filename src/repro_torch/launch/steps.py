"""Step builders — port of ``repro.launch.steps``: the train, prefill and
decode programs of any arch, in the reference's functional form.

``train_step(params, opt, batch)`` returns new params and a new optimizer
state and never writes its inputs, so the fault-tolerant loop can replay
any step from a checkpoint. The reference's sharding helpers
(``configure_sharding_hints``, ``state_specs``, ``shardings_for``) wait
for the port's ``sharding/`` (ROADMAP.md, Queue A): on one card every
tensor lives whole on the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import ModelConfig, ShapeConfig, build_model
from ..optim import adamw_update, cosine_schedule
from ..optim.adamw import _leaves, _map


def make_train_step(cfg: ModelConfig, *, lr_cfg: Optional[dict] = None,
                    chunk_kv: Optional[int] = None):
    """(model, train_step): ``train_step(params, opt, batch)`` → (params,
    opt, {"loss", "grad_norm", "lr"}), every metric a tensor on the params'
    device.

    The loss is taken over fresh leaf tensors that share the params'
    storage and require grad, and ``torch.autograd.grad`` gives its
    gradient with respect to each (float32 through the compute-dtype
    casts); the learning rate is ``cosine_schedule(opt.step, **lr_cfg)``;
    ``adamw_update`` runs under ``torch.no_grad()`` and returns new tensors,
    which carry no graph into the next step."""
    model = build_model(cfg)
    lr_cfg = lr_cfg or {"peak_lr": 3e-4, "warmup": 100, "total": 10000}

    def train_step(params, opt, batch):
        # the schedule reads the step on the host: before the forward, while
        # the device queue is empty, so that no read waits on the backward
        lr = cosine_schedule(opt.step, **lr_cfg)
        leaf_params = _map(lambda p: p.detach().requires_grad_(), params)
        leaves = _leaves(leaf_params)
        with torch.enable_grad():
            loss = model.loss(leaf_params, batch, chunk_kv=chunk_kv)
            by_leaf = dict(zip(map(id, leaves),
                               torch.autograd.grad(loss, leaves)))
        grads = _map(lambda p: by_leaf[id(p)], leaf_params)
        with torch.no_grad():
            new_params, new_opt, gnorm = adamw_update(grads, opt, params,
                                                      lr=lr)
        return new_params, new_opt, {"loss": loss.detach(), "grad_norm": gnorm,
                                     "lr": lr}

    return model, train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      chunk_kv: Optional[int] = None):
    """(model, prefill_step): ``prefill_step(params, tokens, frames=None)``
    → (the last position's logits, a fresh whole-batch bfloat16 cache of
    ``shape.seq_len`` positions, filled), on the tokens' device; an
    encoder-decoder warms the cache's cross keys and values from
    ``frames`` first."""
    model = build_model(cfg)

    def prefill_step(params, tokens, frames=None):
        cache = model.init_cache(tokens.shape[0], shape.seq_len,
                                 device=tokens.device, dtype=torch.bfloat16,
                                 per_slot=False)
        if cfg.is_encdec:
            cache = model.warm_cache(params, frames, cache)
        return model.prefill(params, tokens, cache, chunk_kv=chunk_kv)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig):
    """(model, decode_step): ``decode_step(params, cache, token)`` →
    (logits [B, V], the cache, written in place)."""
    model = build_model(cfg)

    def decode_step(params, cache, token):
        return model.decode_step(params, token, cache)

    return model, decode_step
