"""Decoder-only LM: init, the eval and training forward and its loss, the KV
cache (int8 or fp, per-slot or whole-batch), prefill, decode.

Port of ``repro.models.lm.LMModel``: family ``dense``, ``vlm`` with the
``vision_stub`` frontend (early fusion, image tokens share the vocab, so
the same path), ``moe`` (every block's MLP a top-k MoE,
``layers.moe_block``, whose Switch aux loss ``loss`` adds; experts stacked
``[L, E, ...]``), ``ssm`` (Mamba2: every block a norm and a
``mamba.mamba_block`` mixer) and ``hybrid`` (zamba2: Mamba2 layers in
segments of ``hybrid_attn_every``, each segment followed by one of
``hybrid_n_shared_blocks`` parameter-shared attention + MLP blocks, the
segment index modulo their count). A sliding window bounds the cache's
ring at ``cache_len`` and masks the eval forward alike. The SSM families'
cache is whole-batch only — the SSM and conv states float32 and the
compute dtype, the hybrid's attention cache one fp entry a segment — as in
the reference, whose serving engine does not take them. Parameters keep the
JAX package's layout — nested dicts with every block leaf stacked ``[L, ...]``
— so weights carry across unchanged (``repro_torch.weights``). Layers run as
a Python loop over per-layer views of the stacked leaves; under autograd
with ``cfg.remat`` each block (each Mamba2 layer in the SSM families) runs
under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``: its
activations are recomputed in the backward, the numbers unchanged. The KV
cache is updated IN PLACE (the JAX model returns updated copies under
donation); ``prefill`` / ``decode_step`` still return ``(logits, cache)``
with fresh ``kpos`` / ``pos`` bookkeeping tensors. ``dfq_plan`` tells the
quantization pipeline where the paper's rewrites apply.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..core.graph import (
    DensePairOp,
    DFQPlan,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
    WeightSite,
)
from ..device import resolve_device
from ..quantized.qtensor import QTensor, map_leaves
from .config import ModelConfig
from .layers import (
    AttnDims,
    apply_norm,
    attention_block,
    causal_attention_block,
    mlp_block,
    moe_block,
    slot_write,
)
from .mamba import init_mamba_params, mamba_block, ssm_dims
from ..sharding import collectives as coll
from ..sharding.tp import current_shard
from ..sharding.train import (
    Gathered,
    LayerBlocks,
    current_train,
    cut_of,
    train_scope,
)

#: the cache's per-layer leaves, each [L, B, S, ...] (the scales only in an
#: int8 cache, "v_err" only with ``kv_bias_correct`` as well)
KV_KEYS = ("k", "v", "k_scale", "v_scale", "v_err")
#: the MLP activations of ``layers.mlp_block``
ACTS = ("silu_glu", "gelu_glu", "gelu", "relu")
#: the decoder families this model runs (the encoder-decoder is
#: ``encdec.EncDecModel``)
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def _layer(tree, i: int):
    if isinstance(tree, Gathered):
        return Gathered({k: _layer(v, i) for k, v in tree.items()}, tree.cut)
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def gathering(fn):
    """``fn`` taking a ``LayerBlocks`` first, gathered where it runs (under
    a remat, again in the backward), inside its shard's ``train_scope``:
    on the card the autograd engine recomputes on a thread of its own,
    which the caller's scope does not reach."""
    def run(lp, *args):
        with train_scope(lp.shard):
            return fn(lp.gather(), *args)
    return run


def _requires_grad(tree) -> bool:
    """Whether any tensor of a params tree requires grad."""
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.scale.requires_grad
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def cast_for_compute(params, compute: torch.dtype):
    """Every float32 leaf cast to the compute dtype (QTensor scales
    included), as the JAX forwards cast them; under autograd the cast's
    gradient comes back in float32."""
    return map_leaves(
        lambda a: (a.to(compute) if a.dtype == torch.float32
                   and compute != torch.float32 else a), params)


def prepared(cache: Optional[tuple], params, build):
    """``prepare``'s cache: ``(params, *build())`` for one params object,
    reused while the caller passes the same object (the serving loop).
    Never under autograd with a leaf that requires grad: the cast would
    hold the last step's graph, and a replayed step would backward through
    a freed graph or read stale casts. Returns (the entry, the cache to
    keep)."""
    if torch.is_grad_enabled() and _requires_grad(params):
        return (params, *build()), cache
    if cache is None or cache[0] is not params:
        cache = (params, *build())
    return cache, cache


def _stack_stats(per_layer: list) -> dict:
    """Per-layer stat dicts → one dict of [L, ...] stacks (the reference's
    scan output)."""
    return {k: torch.stack([st[k] for st in per_layer]) for k in per_layer[0]}


class LMModel:
    def __init__(self, cfg: ModelConfig):
        unsupported = [
            what for what, bad in (
                (f"family {cfg.family!r}", cfg.family not in FAMILIES),
                ("experts outside family 'moe'",
                 bool(cfg.n_experts) != (cfg.family == "moe")),
                (f"frontend {cfg.frontend!r}",
                 cfg.frontend not in ("none", "vision_stub")),
                (f"norm {cfg.norm!r}", cfg.norm != "rms"),
                (f"act {cfg.act!r}", cfg.act not in ACTS),
            ) if bad]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unsupported)} is not a decoder "
                f"this model runs (dense, MoE, SSM and hybrid RMSNorm "
                f"decoders; an encoder-decoder builds EncDecModel)")
        self.cfg = cfg
        # (params object, its compute-dtype copy, per-layer views) — see
        # prepare; the serving loop reuses one params tree every step
        self._prepared = None
        #: a diagnostic: set to a list, and every MoE block a forward runs
        #: appends the choices each batch row dropped for capacity
        #: (``moe_block``'s ``drops``; a training forward under remat
        #: appends a block's again when the backward recomputes it); None
        #: records nothing
        self.drop_log: Optional[list] = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device: Optional[Union[str, torch.device]] = "cuda") -> dict:
        """Seeded random parameters on ``device`` (default: the card), in the
        JAX init's scales: normal · d_in^-1/2 linears, normal · 0.02
        embedding, zero biases, unit norms. ``torch.Generator`` draws differ
        from ``jax.random``'s; tests carry JAX weights across instead.
        ``device="meta"`` gives the shapes and dtypes alone (no draw, no
        memory: ``launch.steps.state_specs``)."""
        cfg = self.cfg
        device = resolve_device(device)
        meta = device.type == "meta"      # shapes and dtypes only
        if isinstance(seed, torch.Generator) or meta:
            gen = seed
        else:
            gen = torch.Generator(device=device).manual_seed(int(seed))
        dtype = cfg.params_dtype
        D, F = cfg.d_model, cfg.d_ff

        def normal(shape, scale):
            if meta:
                return torch.empty(shape, dtype=dtype, device=device)
            return (torch.randn(shape, generator=gen, device=device)
                    * scale).to(dtype)

        def uniform(shape):
            if meta:
                return torch.empty(shape, device=device)
            return torch.rand(shape, generator=gen, device=device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def ones(*shape):
            return torch.ones(shape, dtype=dtype, device=device)

        glu = cfg.act.endswith("_glu")

        def attention_blocks(L):
            """L stacked attention + MLP (or MoE) blocks."""
            def lin(d_in, d_out):
                return normal((L, d_in, d_out), d_in ** -0.5)

            attn = {"wq": lin(D, cfg.attn_dim), "wk": lin(D, cfg.kv_dim),
                    "wv": lin(D, cfg.kv_dim), "wo": lin(cfg.attn_dim, D),
                    "bo": zeros(L, D)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(L, cfg.attn_dim), bk=zeros(L, cfg.kv_dim),
                            bv=zeros(L, cfg.kv_dim))
            if cfg.qk_norm:
                attn.update(q_norm=ones(L, cfg.head_dim),
                            k_norm=ones(L, cfg.head_dim))

            def dense_mlp(f):
                mlp = {"wu": lin(D, f), "wd": lin(f, D), "bd": zeros(L, D)}
                if glu:
                    mlp["wg"] = lin(D, f)
                return mlp

            if cfg.n_experts:
                # the JAX _init_moe: experts [L, E, ...], the router, and
                # the shared experts' MLP d_ff x n_shared_experts wide
                E = cfg.n_experts
                experts = {"wu": normal((L, E, D, F), D ** -0.5),
                           "wd": normal((L, E, F, D), F ** -0.5)}
                if glu:
                    experts["wg"] = normal((L, E, D, F), D ** -0.5)
                mlp = {"router": lin(D, E), "experts": experts}
                if cfg.n_shared_experts:
                    mlp["shared"] = dense_mlp(F * cfg.n_shared_experts)
            else:
                mlp = dense_mlp(F)
            return {"attn_norm": {"w": ones(L, D)}, "attn": attn,
                    "mlp_norm": {"w": ones(L, D)}, "mlp": mlp}

        L = cfg.n_layers
        extra = {}
        if cfg.family in ("ssm", "hybrid"):
            blocks = {"norm": {"w": ones(L, D)},
                      "mixer": init_mamba_params(normal, uniform, L, cfg,
                                                 dtype, device)}
            if cfg.family == "hybrid":
                extra["shared_blocks"] = attention_blocks(
                    cfg.hybrid_n_shared_blocks)
        else:
            blocks = attention_blocks(L)
        params = {"embed": normal((cfg.vocab_size, D), 0.02),
                  "final_norm": {"w": ones(D)}, "blocks": blocks, **extra}
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((D, cfg.vocab_size), D ** -0.5)
        return params

    def dfq_plan(self) -> DFQPlan:
        """Where DFQ's rewrites apply in this model's params, and its weight
        sites — the attention branch of the JAX ``LMModel.dfq_plan``, op for
        op and site for site. An MoE block keeps its ``mlp_norm`` gain (the
        reference folds no norm into experts), equalizes each expert's
        up/down pair and the shared experts', and quantizes the router and
        the stacked expert weights; the expert sites have no statistic, so
        bias correction passes them by. The Mamba2 mixers (``ssm``,
        ``hybrid``) take norm folding only — the gated RMSNorm before
        out_proj blocks their CLE pairs — and quantize in_proj / out_proj;
        the hybrid's attention ops address its ``shared_blocks``."""
        cfg = self.cfg
        ops: list = []
        sites: list = []
        if cfg.family in ("ssm", "hybrid"):
            ops.append(NormFoldOp(
                norm_w=("blocks", "norm", "w"),
                consumers=[("blocks", "mixer", "in_proj")],
                consumer_biases=[("blocks", "mixer", "in_bias")]))
            sites += [
                WeightSite("ssm_in_proj", ("blocks", "mixer", "in_proj"),
                           ("blocks", "mixer", "in_bias"), "dense", "ssm_in"),
                WeightSite("ssm_out_proj", ("blocks", "mixer", "out_proj"),
                           ("blocks", "mixer", "out_bias"), "dense",
                           "ssm_out_in"),
            ]
        if cfg.family == "ssm":
            return DFQPlan(tuple(ops), tuple(sites), cfg.name)
        prefix = ("shared_blocks",) if cfg.family == "hybrid" else ("blocks",)

        def P(*rest):
            return prefix + rest

        glu = cfg.act.endswith("_glu")
        attn_bias = ((P("attn", "bq"), P("attn", "bk"), P("attn", "bv"))
                     if cfg.qkv_bias else (None, None, None))
        ops += [
            NormFoldOp(norm_w=P("attn_norm", "w"),
                       consumers=[P("attn", "wq"), P("attn", "wk"),
                                  P("attn", "wv")],
                       consumer_biases=list(attn_bias))]
        if not cfg.n_experts:
            ops.append(NormFoldOp(
                norm_w=P("mlp_norm", "w"),
                consumers=([P("mlp", "wg")] if glu else []) + [P("mlp", "wu")],
                consumer_biases=[None, None] if glu else [None]))
        ops.append(VOPairOp(wv=P("attn", "wv"), wo=P("attn", "wo"),
                            bv=P("attn", "bv") if cfg.qkv_bias else None,
                            n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
                            head_dim=cfg.head_dim))
        if not cfg.qk_norm:
            ops.append(QKPairOp(
                wq=P("attn", "wq"), wk=P("attn", "wk"),
                bq=P("attn", "bq") if cfg.qkv_bias else None,
                bk=P("attn", "bk") if cfg.qkv_bias else None,
                n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope=cfg.rope))
        if cfg.n_experts:
            ops.append(DensePairOp(w1=P("mlp", "experts", "wu"),
                                   w2=P("mlp", "experts", "wd"), exact=glu))
            if cfg.n_shared_experts:
                ops.append(DensePairOp(w1=P("mlp", "shared", "wu"),
                                       w2=P("mlp", "shared", "wd"),
                                       exact=glu))
        else:
            ops.append(DensePairOp(
                w1=P("mlp", "wu"), w2=P("mlp", "wd"),
                b1=P("mlp", "bu") if cfg.mlp_bias else None,
                exact=glu or cfg.act == "relu"))
        if cfg.qkv_bias:
            ops.append(VBiasAbsorbOp(
                bv=P("attn", "bv"), wo=P("attn", "wo"), bo=P("attn", "bo"),
                n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim))
        sites += [
            WeightSite("wq", P("attn", "wq"), P("attn", "bq"), "dense", "attn_in"),
            WeightSite("wk", P("attn", "wk"), P("attn", "bk"), "dense", "attn_in"),
            WeightSite("wv", P("attn", "wv"), P("attn", "bv"), "dense", "attn_in"),
            WeightSite("wo", P("attn", "wo"), P("attn", "bo"), "dense", "o_in"),
        ]
        if cfg.n_experts:
            sites += [
                WeightSite("router", P("mlp", "router"), P("mlp", "router_b"),
                           "dense", "mlp_in"),
                WeightSite("experts_wu", P("mlp", "experts", "wu"), None,
                           "dense", None),
                WeightSite("experts_wd", P("mlp", "experts", "wd"), None,
                           "dense", None),
            ]
            if glu:
                sites.append(WeightSite("experts_wg", P("mlp", "experts", "wg"),
                                        None, "dense", None))
        else:
            sites += [
                WeightSite("wu", P("mlp", "wu"), P("mlp", "bu"), "dense", "mlp_in"),
                WeightSite("wd", P("mlp", "wd"), P("mlp", "bd"), "dense", "down_in"),
            ]
            if glu:
                sites.append(WeightSite("wg", P("mlp", "wg"), P("mlp", "bg"),
                                        "dense", "mlp_in"))
        return DFQPlan(tuple(ops), tuple(sites), cfg.name)

    # ------------------------------------------------------------- forward
    def _attn_dims(self) -> AttnDims:
        cfg = self.cfg
        return AttnDims(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm,
                        rope=cfg.rope, rope_theta=cfg.rope_theta,
                        window=cfg.sliding_window,
                        causal_segments=cfg.attn_causal_segments)

    def prepare(self, params: dict):
        """The params cast to the compute dtype (``cast_for_compute``) plus
        the per-layer views of the stacked blocks — computed once per
        params object, since the serving loop passes the same tree every
        step; under autograd, with a leaf that requires grad, every call
        (``prepared``)."""
        tr = current_train()
        if tr is not None:
            # a sharded train step: this rank's blocks, each layer
            # gathered where it runs
            top, stacks = tr.prepare(params)
            return top, stacks["blocks"]

        def build():
            p = cast_for_compute(params, self.cfg.compute_dtype)
            return p, [_layer(p["blocks"], i)
                       for i in range(self.cfg.n_layers)]

        entry, self._prepared = prepared(self._prepared, params, build)
        return entry[1], entry[2]

    def _remat(self, capture) -> bool:
        """Whether this forward recomputes its blocks in the backward."""
        return self.cfg.remat and capture is None and torch.is_grad_enabled()

    def _shared(self, p, seg: int) -> dict:
        """The hybrid's parameter-shared block after segment ``seg``."""
        return _layer(p["shared_blocks"], seg % self.cfg.hybrid_n_shared_blocks)

    def _segments(self):
        """The hybrid's segments: (segment index, its layer indices)."""
        every = self.cfg.hybrid_attn_every
        return [(seg, range(seg * every, (seg + 1) * every))
                for seg in range(self.cfg.n_layers // every)]

    def _mamba_layer(self, p, x, *, state=None, capture=None):
        h = apply_norm(x, p["norm"], self.cfg.norm)
        out, new_state = mamba_block(p["mixer"], h, self.cfg, state=state,
                                     capture=capture)
        return x + out, new_state

    def _mlp(self, p, h, capture=None):
        """The block's MLP (an MoE block's with its aux loss, else 0)."""
        if self.cfg.n_experts:
            return moe_block(p, h, self.cfg, capture=capture,
                             drops=self.drop_log)
        return mlp_block(p, h, self.cfg.act, capture=capture), 0.0

    def _transformer_block(self, p, x, *, positions, cache, slots,
                           chunk_kv=None):
        cfg = self.cfg
        h = apply_norm(x, p["attn_norm"], cfg.norm)
        x = x + attention_block(p["attn"], h, self._attn_dims(),
                                positions=positions, cache=cache, slots=slots,
                                chunk_kv=chunk_kv)
        h = apply_norm(x, p["mlp_norm"], cfg.norm)
        return x + self._mlp(p["mlp"], h)[0]

    def apply(self, params, tokens: torch.Tensor, *, capture: bool = False,
              chunk_kv: Optional[int] = None, return_hidden: bool = False,
              return_aux: bool = False):
        """The eval and training forward: causal (within the sliding window,
        if any), no cache, fp keys and values. tokens [B, T] → logits
        [B, T, V]; ``return_hidden`` returns the final norm's output
        [B, T, D] instead. ``chunk_kv`` chunks the attention
        (``layers.attention_scores_softmax``).

        ``capture=True`` returns ``(logits, stats)``: per stat key
        (``attn_in``, ``o_in``, ``mlp_in``, ``down_in``; an MoE block's
        ``down_in_moe`` [L, E, F] and ``router_probs`` [L, E] in place of
        ``down_in``) the per-layer means of each site's input stacked
        [L, D], plus ``final_h`` [D], the mean of the final norm's output —
        means in the compute dtype, as the JAX scan gives them (the SSM
        families: ``_apply_ssm``'s keys).
        ``return_aux=True`` returns ``(logits, aux)`` instead, aux the MoE
        blocks' summed load-balancing loss (0.0 for a dense model) — the
        two halves of the JAX ``apply``'s result.
        """
        p, layers = self.prepare(params)
        h, aux, stats = self._hidden(p, layers, tokens, capture, chunk_kv)
        logits = h if return_hidden else self._unembed(p, h)
        if return_aux:
            return logits, aux
        if not capture:
            return logits
        stats["final_h"] = h.reshape(-1, self.cfg.d_model).mean(dim=0)
        return logits, stats

    def _hidden(self, p, layers, tokens, capture, chunk_kv):
        """The final norm's output [B, T, D], the MoE aux loss and the
        stats (a dict with ``capture``, else None) over prepared params."""
        cfg = self.cfg
        x = self._embed(p, tokens)
        aux = 0.0
        if cfg.family in ("ssm", "hybrid"):
            x, stats = self._apply_ssm(p, layers, x, capture, chunk_kv)
        else:
            per_layer = []
            for lp in layers:
                layer_stats = {} if capture else None
                x, a = self._block(self._eval_block, lp, x, layer_stats,
                                   chunk_kv)
                aux = aux + a
                per_layer.append(layer_stats)
            stats = (_stack_stats(per_layer) if capture else None)
        return apply_norm(x, p["final_norm"], cfg.norm), aux, stats

    def _block(self, fn, lp, x, stats, *args):
        """``fn(lp, x, stats, *args)``, under ``checkpoint`` where this
        forward remats (a sharded train step's ``LayerBlocks`` gathered
        inside it)."""
        if isinstance(lp, LayerBlocks):
            fn = gathering(fn)
        if self._remat(stats):
            return checkpoint(fn, lp, x, stats, *args, use_reentrant=False)
        return fn(lp, x, stats, *args)

    def _eval_block(self, lp, x, stats, chunk_kv=None):
        """One attention + MLP block of the eval forward; returns (x, the
        MoE aux loss)."""
        cfg = self.cfg
        h = apply_norm(x, lp["attn_norm"], cfg.norm)
        x = x + causal_attention_block(lp["attn"], h, self._attn_dims(),
                                       capture=stats, chunk_kv=chunk_kv)
        h = apply_norm(x, lp["mlp_norm"], cfg.norm)
        out, a = self._mlp(lp["mlp"], h, capture=stats)
        return x + out, a

    def _eval_mamba(self, lp, x, stats):
        return self._mamba_layer(lp, x, capture=stats)[0]

    def _apply_ssm(self, p, layers, x, capture, chunk_kv=None):
        """The SSM families' eval forward. Stats as the reference's: the
        mixers' ``ssm_in`` / ``ssm_out_in`` stacked [L, ...] (under
        ``"mamba"`` for the hybrid), and each shared block application's
        own under ``"shared_<segment>"``. Under remat the Mamba2 layers
        recompute (the hybrid's shared blocks do not, as the
        reference's)."""
        if self.cfg.family == "ssm":
            per_layer = []
            for lp in layers:
                st = {} if capture else None
                x = self._block(self._eval_mamba, lp, x, st)
                per_layer.append(st)
            return x, (_stack_stats(per_layer) if capture else None)
        per_layer, stats = [], {}
        for seg, idx in self._segments():
            for i in idx:
                st = {} if capture else None
                x = self._block(self._eval_mamba, layers[i], x, st)
                per_layer.append(st)
            st = {} if capture else None
            x, _ = self._eval_block(self._shared(p, seg), x, st, chunk_kv)
            if capture:
                stats[f"shared_{seg}"] = st
        if capture:
            stats["mamba"] = _stack_stats(per_layer)
        return x, stats

    def loss(self, params, batch: dict, *,
             chunk_kv: Optional[int] = None) -> torch.Tensor:
        """Mean next-token cross entropy over ``batch["tokens"]`` /
        ``batch["labels"]`` [B, T], the logits taken ``logit_chunk``
        positions at a time in float32 (``jax.nn.logsumexp`` minus the
        gold logit, read with ``gather``: the value and the gradient of the
        reference's masked sum), plus 0.01 x the MoE blocks' aux loss, as
        the JAX ``loss``. ``T`` must be a multiple of the chunk, as the JAX
        ``loss``'s reshape requires. Differentiable: the training step
        takes its gradient with respect to float32 params through the
        compute-dtype casts. Under a sharded train step (``sharding.train``)
        the loss is this rank's rows', and a vocab-parallel head takes the
        cross entropy over its vocab shards (``TrainShard.nll``)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, T = tokens.shape
        C = min(cfg.logit_chunk, T)
        if T % C:
            raise ValueError(f"loss: sequence length {T} is not a multiple "
                             f"of logit_chunk {C}")
        p, layers = self.prepare(params)
        h, aux, _ = self._hidden(p, layers, tokens, None, chunk_kv)
        tr = current_train()
        vocab_cut = tr is not None and self._head_name(p) in cut_of(p)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(T // C):
            logits = self._unembed(p, h[:, c * C:(c + 1) * C]).float()
            lc = labels[:, c * C:(c + 1) * C]
            if vocab_cut:
                total = total + tr.nll(logits, lc).sum()
                continue
            gold = torch.gather(logits, -1, lc[..., None].long())
            total = total + (torch.logsumexp(logits, -1)
                             - gold[..., 0]).sum()
        loss = total / (B * T)
        if cfg.n_experts:
            loss = loss + 0.01 * aux
        return loss

    def calibration_stats(self, params, tokens: torch.Tensor) -> dict:
        """Synthetic-calibration E[x] per stat key (data-free: the tokens
        are random ids): ``apply(..., capture=True)``'s stats, keyed like
        ``WeightSite.stat_key``."""
        return self.apply(params, tokens, capture=True)[1]

    def _embed(self, params, tokens):
        tr = current_train()
        if tr is not None:
            return tr.embed(params["embed"], tokens, "embed" in cut_of(params),
                            self.cfg.compute_dtype)
        tp = current_shard()
        if tp is None or not tp.embed_sharded:
            return params["embed"][tokens].to(self.cfg.compute_dtype)
        # vocab-parallel: this rank's rows [lo, lo + V/M), zeros for the
        # other ids, summed over the ranks (one non-zero term an element)
        w = params["embed"]
        lo = tp.model_rank * w.shape[0]
        mine = (tokens >= lo) & (tokens < lo + w.shape[0])
        rows = w[torch.where(mine, tokens - lo, 0)].to(self.cfg.compute_dtype)
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return coll.combine(rows, tp.model_group)

    @staticmethod
    def _head_name(params) -> str:
        return "lm_head" if "lm_head" in params else "embed"

    def _unembed(self, params, h):
        """The logits of ``h``; under a sharded train step whose head is
        vocab-parallel, this rank's vocab columns."""
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].t()
        tr = current_train()
        if tr is not None and self._head_name(params) in cut_of(params):
            return tr.logits(h, w)
        return h @ w.to(h.dtype)

    # ---------------------------------------------------------------- cache
    def cache_len(self, seq_len: int) -> int:
        """The ring a cache for ``seq_len`` positions holds: the sliding
        window, where it is shorter."""
        if self.cfg.sliding_window is not None:
            return min(seq_len, self.cfg.sliding_window)
        return seq_len

    def init_cache(self, batch: int, seq_len: int, *,
                   device: Optional[Union[str, torch.device]] = "cuda",
                   per_slot: Optional[bool] = None,
                   kv_bits: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None,
                   kv_heads: Optional[int] = None) -> dict:
        """The KV cache. ``per_slot=True`` (the serving engine's, and the
        default of the attention families) makes every
        batch row a serving slot with its own write offset (``pos`` [B]) and
        absolute slot positions (``kpos`` [B, S], -1 = empty);
        ``per_slot=False`` the whole-batch form, every row at one offset
        (``pos`` scalar, ``kpos`` [S]). ``kv_bits`` (default
        ``cfg.kv_cache_bits``, 16 unless a ``kv_cache`` stage recorded 8):
        8 → int8 payload with per-token, per-head float32 scales, scale 0
        marking an unwritten position, and with ``kv_bias_correct`` a
        ``v_err`` leaf [L, B, S, Hkv] float32 holding each token's V error
        mean; 16 → the payload in ``dtype`` (default the compute dtype) and
        no other leaf. The ring holds ``cache_len(seq_len)`` positions.

        The SSM families take the whole-batch form only (their default; an
        explicit ``per_slot=True`` raises, the reference's refusal): ``ssm``
        [L, B, H, P, S] float32 and ``conv`` [L, B, W-1, d_conv] in
        ``dtype``, and for the hybrid fp ``k`` / ``v`` [L // every, B, S,
        Hkv, hd] (whatever ``kv_bits``, as the reference's) with ``kpos``
        [S]. ``kv_heads`` sizes an attention cache's head axis (default
        ``cfg.n_kv_heads``; a tensor-parallel rank's pool holds its own
        heads)."""
        cfg = self.cfg
        kv_bits = cfg.kv_cache_bits if kv_bits is None else int(kv_bits)
        if kv_bits not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
        device = resolve_device(device)
        if cfg.family in ("ssm", "hybrid"):
            return self._ssm_cache(batch, seq_len, device, bool(per_slot),
                                   dtype or cfg.compute_dtype)
        if per_slot is None:
            per_slot = True
        L, S, H, hd = (cfg.n_layers, self.cache_len(seq_len),
                       kv_heads or cfg.n_kv_heads, cfg.head_dim)
        kv_dtype = (torch.int8 if kv_bits == 8
                    else dtype or cfg.compute_dtype)
        cache = {
            "k": torch.zeros((L, batch, S, H, hd), dtype=kv_dtype, device=device),
            "v": torch.zeros((L, batch, S, H, hd), dtype=kv_dtype, device=device),
            "kpos": torch.full((batch, S) if per_slot else (S,), -1,
                               dtype=torch.int64, device=device),
            "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int64,
                               device=device),
        }
        if kv_bits == 8:
            cache["k_scale"] = torch.zeros((L, batch, S, H), dtype=torch.float32,
                                           device=device)
            cache["v_scale"] = torch.zeros((L, batch, S, H), dtype=torch.float32,
                                           device=device)
            if cfg.kv_bias_correct:
                cache["v_err"] = torch.zeros((L, batch, S, H),
                                             dtype=torch.float32, device=device)
        return cache

    def _ssm_cache(self, batch, seq_len, device, per_slot, dtype) -> dict:
        cfg = self.cfg
        if per_slot:
            raise ValueError(
                f"per-slot caches are only supported for attention-family "
                f"models (got family={cfg.family!r}); SSM state handoff is "
                f"position-free but needs dedicated plumbing")
        _, H, _, St, _, d_conv = ssm_dims(cfg)
        L = cfg.n_layers
        cache = {
            "ssm": torch.zeros((L, batch, H, cfg.ssm_head_dim, St),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((L, batch, cfg.ssm_conv_width - 1, d_conv),
                                dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int64, device=device),
        }
        if cfg.family == "hybrid":
            S, n_app = self.cache_len(seq_len), L // cfg.hybrid_attn_every
            shape = (n_app, batch, S, cfg.n_kv_heads, cfg.head_dim)
            cache.update(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device),
                         kpos=torch.full((S,), -1, dtype=torch.int64,
                                         device=device))
        return cache

    def _mamba_cached(self, lp, x, cache, i: int):
        """Layer i's mixer over its cached state, written back in place."""
        x, st = self._mamba_layer(lp, x, state={"ssm": cache["ssm"][i],
                                                "conv": cache["conv"][i]})
        cache["ssm"][i].copy_(st["ssm"])
        cache["conv"][i].copy_(st["conv"])
        return x

    def _forward_cached(self, params, tokens, cache, *, logits_at=None,
                        chunk_kv=None):
        """Run T tokens from ``cache["pos"]`` (each row's, or the batch's);
        ``logits_at`` [B] picks each row's logits position, a scalar the
        batch's (default: the last), ``"all"`` every position's ([B, T,
        V]); ``chunk_kv`` chunks the attention over a whole-batch cache."""
        cfg = self.cfg
        p, layers = self.prepare(params)
        B, T = tokens.shape
        pos = cache["pos"]
        steps = torch.arange(T, device=pos.device)
        positions = pos[:, None] + steps[None, :] if pos.ndim else pos + steps
        x = self._embed(p, tokens)
        new = {"pos": pos + T}
        if cfg.family == "ssm":
            for i, lp in enumerate(layers):
                x = self._mamba_cached(lp, x, cache, i)
        else:
            slots = slot_write(cache["kpos"], positions, cfg.sliding_window)
            new["kpos"] = slots.kpos
            if cfg.family == "hybrid":
                for seg, idx in self._segments():
                    for i in idx:
                        x = self._mamba_cached(layers[i], x, cache, i)
                    x = self._transformer_block(
                        self._shared(p, seg), x, positions=positions,
                        slots=slots, chunk_kv=chunk_kv,
                        cache={"k": cache["k"][seg], "v": cache["v"][seg]})
            else:
                for i, lp in enumerate(layers):
                    x = self._transformer_block(
                        lp, x, positions=positions, slots=slots,
                        chunk_kv=chunk_kv,
                        cache={k: cache[k][i] for k in KV_KEYS if k in cache})
        x = apply_norm(x, p["final_norm"], cfg.norm)
        if isinstance(logits_at, str) and logits_at == "all":
            return self._unembed(p, x), {**cache, **new}
        if logits_at is None:
            h_last = x[:, -1:, :]
        else:
            at = torch.as_tensor(logits_at, device=x.device).to(torch.int64)
            at = torch.broadcast_to(at.reshape(-1), (B,))
            h_last = torch.gather(x, 1, at[:, None, None].expand(
                B, 1, x.shape[-1]))
        logits = self._unembed(p, h_last)[:, 0]
        return logits, {**cache, **new}

    def prefill(self, params, tokens, cache, *, logits_at=None,
                chunk_kv: Optional[int] = None):
        return self._forward_cached(params, tokens, cache, logits_at=logits_at,
                                    chunk_kv=chunk_kv)

    def decode_step(self, params, token, cache):
        """token [B, 1] → (logits [B, V], cache)."""
        return self._forward_cached(params, token, cache)
