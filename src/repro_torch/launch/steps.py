"""Step builders — port of ``repro.launch.steps``: the train, prefill and
decode programs of any arch, in the reference's functional form, and the
sharding helpers of the train step.

``train_step(params, opt, batch)`` returns new params and a new optimizer
state and never writes its inputs, so the fault-tolerant loop can replay
any step from a checkpoint. Under ``configure_sharding_hints(cfg, mesh)``
(a ``torch.distributed`` ``DeviceMesh`` of ("data", "model"), or ("pod",
"data", "model")) the same step runs over the mesh, as the reference's
jitted step runs under its shardings: params and AdamW state are this
rank's blocks (``state_specs``' placement, ``sharding.shard_tree`` cuts
them), the batch is the global one (each rank takes its rows), the forward
gathers each layer's leaves where it runs (``sharding.train``), the
gradients come back as blocks, summed over the data-parallel ranks, and
``adamw_update`` runs on the blocks with the clip's norm over the mesh.
``state_specs`` and ``shardings_for`` give shapes (``device="meta"``
tensors) and specs without allocating.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import ModelConfig, ShapeConfig, build_model, cache_specs
from ..optim import adamw_init, adamw_update, cosine_schedule
from ..optim.adamw import _leaves, _map
from ..sharding import collectives as coll
from ..sharding.partition import (
    NamedSharding,
    PartitionSpec as P,
    batch_pspec,
    cache_pspecs,
    mesh_sizes,
    named_shardings,
    opt_spec_tree,
    params_pspecs,
)
from ..sharding.train import TrainShard, train_scope


def configure_sharding_hints(cfg: ModelConfig, mesh):
    """Arm the in-model shard context (``models.layers.set_shard_ctx``) for
    training over ``mesh``: head-parallel attention where the head count
    divides the model axis, context (sequence) parallel otherwise; an SSM
    (no heads) arms no attention mode."""
    from ..models.layers import set_shard_ctx

    sizes = mesh_sizes(mesh)
    model_n = sizes.get("model", 1)
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    if cfg.n_heads == 0:
        set_shard_ctx(enabled=True, dp=dp, model="model", attn_seq=False,
                      mesh=mesh)
        return
    set_shard_ctx(enabled=True, dp=dp, model="model",
                  attn_seq=(cfg.n_heads % model_n != 0),
                  kv_heads_ok=(cfg.n_kv_heads % model_n == 0), mesh=mesh)


def clear_sharding_hints():
    from ..models.layers import set_shard_ctx

    set_shard_ctx(enabled=False)


def _heads(cfg: ModelConfig) -> dict:
    return {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}


def state_specs(model, mesh):
    """((params, opt) shapes, (params, opt) specs) without allocation: the
    shapes are ``device="meta"`` tensors; the params' specs take the
    head rule, the moments' (a dict of step / m / v, as the reference's)
    do not."""
    params_shape = model.init(0, device="meta")
    opt_shape = adamw_init(params_shape)
    p_spec = params_pspecs(params_shape, mesh, _heads(model.cfg))
    o_spec = {"step": P(), "m": params_pspecs(params_shape, mesh),
              "v": params_pspecs(params_shape, mesh)}
    return (params_shape, opt_shape), (p_spec, o_spec)


def armed_shard(model) -> Optional[TrainShard]:
    """The ``TrainShard`` of the armed shard context's mesh (None when no
    mesh is armed), built once a mesh and mode and kept on ``model`` (the
    train step's: ``make_train_step`` returns it). Building it draws the
    whole params on ``meta`` for their specs: the dry-run builds it before
    it counts a step's memory."""
    from ..models.layers import _SHARD_CTX as ctx

    if not ctx["enabled"] or ctx.get("mesh") is None:
        return None
    held = vars(model).setdefault("_train_shard", {})
    key = (ctx["mesh"], ctx["attn_seq"], ctx["kv_heads_ok"])
    if held.get("key") is None or any(
            a is not b for a, b in zip(held["key"], key)):
        _, (p_spec, _) = state_specs(model, ctx["mesh"])
        held["key"] = key
        held["shard"] = TrainShard(ctx["mesh"], model.cfg, p_spec,
                                   attn_seq=ctx["attn_seq"],
                                   kv_heads_ok=ctx["kv_heads_ok"])
    return held["shard"]


def make_train_step(cfg: ModelConfig, *, lr_cfg: Optional[dict] = None,
                    chunk_kv: Optional[int] = None, donate: bool = False):
    """(model, train_step): ``train_step(params, opt, batch)`` → (params,
    opt, {"loss", "grad_norm", "lr"}), every metric a tensor on the params'
    device.

    The loss is taken over fresh leaf tensors that share the params'
    storage and require grad, and ``torch.autograd.grad`` gives its
    gradient with respect to each (float32 through the compute-dtype
    casts); the learning rate is ``cosine_schedule(opt.step, **lr_cfg)``;
    ``adamw_update`` runs under ``torch.no_grad()`` and returns new tensors,
    which carry no graph into the next step. ``donate`` (the reference
    launcher's ``donate_argnums``) has it write the given params and
    moments instead (``adamw_update(inplace=True)``: no second copy of the
    state), which the caller then holds as the new state. As a donated
    JAX buffer is deleted, the params given to a donated step are used up
    from the moment it starts: it returns them in new containers, and
    refuses to run again on the containers it last took (the state a
    step that failed may have half written; a caller restores it from a
    checkpoint instead).

    Under an armed mesh (``configure_sharding_hints``, read at each call)
    ``params`` and ``opt`` are this rank's blocks and ``batch`` the global
    batch: the rank's loss is its rows' divided by the data-parallel world,
    the gradient of each block sums the ranks' (inside the backward of the
    gathers), and the loss and the norm are reduced over the mesh, the same
    on every rank."""
    model = build_model(cfg)
    lr_cfg = lr_cfg or {"peak_lr": 3e-4, "warmup": 100, "total": 10000}
    held: dict = {}

    def train_step(params, opt, batch):
        if donate:
            if params is held.get("donated"):
                raise RuntimeError(
                    "these params were donated to an earlier step, which "
                    "writes them in place: use the state it returned, or "
                    "restore one from a checkpoint")
            held["donated"] = params
        # the schedule reads the step on the host: before the forward, while
        # the device queue is empty, so that no read waits on the backward
        lr = cosine_schedule(opt.step, **lr_cfg)
        shard = armed_shard(model)
        leaf_params = _map(lambda p: p.detach().requires_grad_(), params)
        leaves = _leaves(leaf_params)
        with torch.enable_grad(), train_scope(shard):
            if shard is None:
                loss = model.loss(leaf_params, batch, chunk_kv=chunk_kv)
            else:
                loss = model.loss(leaf_params, shard.rows(batch),
                                  chunk_kv=chunk_kv) / shard.dp_n
            by_leaf = dict(zip(map(id, leaves),
                               torch.autograd.grad(loss, leaves)))
        grads = _map(lambda p: by_leaf[id(p)], leaf_params)
        loss = loss.detach()
        counted = group = None
        if shard is not None:
            loss = coll.all_reduce_sum(loss.clone(), shard.dp_group)
            counted = shard.counted()
            group = torch.distributed.group.WORLD
        with torch.no_grad():
            new_params, new_opt, gnorm = adamw_update(
                grads, opt, params, lr=lr, counted=counted, group=group,
                inplace=donate)
        if donate:
            # the same tensors, in containers the step has not taken
            new_params = _map(lambda t: t, new_params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
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


def shardings_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Every placement of one (arch x shape) cell, shapes as
    ``device="meta"`` tensors: params (train mode; a decode cell's
    resident TP-only placement), the batch, and per kind the AdamW state
    (train), the whole-batch cache (decode) and an encoder-decoder's
    frames (train, prefill)."""
    model = build_model(cfg)
    params_shape = model.init(0, device="meta")
    p_spec = params_pspecs(params_shape, mesh, _heads(cfg),
                           mode="decode" if shape.kind == "decode"
                           else "train")
    out = {
        "params_shape": params_shape,
        "params": named_shardings(p_spec, mesh),
        "batch": NamedSharding(mesh, batch_pspec(mesh,
                                                 batch=shape.global_batch)),
    }
    if shape.kind == "train":
        out["opt_shape"] = adamw_init(params_shape)
        out["opt"] = named_shardings(opt_spec_tree(p_spec), mesh)
    if shape.kind == "decode":
        cache_shape = cache_specs(cfg, shape)
        out["cache_shape"] = cache_shape
        out["cache"] = named_shardings(
            cache_pspecs(cache_shape, mesh, shape.global_batch), mesh)
    if cfg.is_encdec and shape.kind in ("train", "prefill"):
        out["frames"] = NamedSharding(
            mesh, batch_pspec(mesh, ndim=3, batch=shape.global_batch))
    return out
