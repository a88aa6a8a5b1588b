"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) — port of
``repro.models.encdec``.

The conv audio front end is a STUB, as in the reference: callers give
precomputed frame embeddings [B, enc_seq, d_model]. The backbone: pre-LN
transformer stacks, LayerNorm (γ, β), plain-GELU MLPs with biases
everywhere, sinusoidal encoder positions, learned decoder positions, causal
decoder self-attention and cross attention to the encoder output.
Parameters keep the reference's layout (``enc_blocks`` / ``dec_blocks``
stacked ``[L, ...]``), so weights carry across unchanged
(``repro_torch.weights``).

Decoding runs over a whole-batch fp cache: the self-attention ring (``k``,
``v`` [L, B, S, H, hd], ``kpos`` [S], ``pos``), written in place, and the
cross keys and values (``ck``, ``cv`` [L, B, enc_seq, H, hd]) that
``warm_cache`` projects once from the encoder output. A ``QTensor`` weight
routes through the int8 GEMMs (``layers.linear``) like the decoder-only
model's.

Training: ``loss`` is differentiable through the compute-dtype casts;
under autograd with ``cfg.remat`` every encoder and decoder layer runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), and
``chunk_kv`` chunks the decoder's causal self-attention.

DFQ notes: the plain-GELU MLP pairs are *approximate* CLE (``exact=False``,
skipped by default); LayerNorm gives the norm folds a shift (β) to fold
into the consumers' biases.
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
from .config import ModelConfig
from .layers import (
    AttnDims,
    apply_norm,
    attention_block,
    causal_attention_block,
    cross_attention_block,
    cross_kv,
    mlp_block,
    slot_write,
)
from ..sharding.train import LayerBlocks, current_train, cut_of
from .lm import _layer, _stack_stats, cast_for_compute, gathering, prepared


def sinusoidal_positions(T: int, d: int, device=None) -> torch.Tensor:
    """[T, d] float32: sin of each position's angles, then cos."""
    pos = torch.arange(T, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device),
                          (2 * dim).float() / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecModel:
    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encdec or cfg.norm != "ln":
            raise NotImplementedError(
                f"{cfg.name}: EncDecModel runs a LayerNorm encoder-decoder "
                f"(n_enc_layers > 0, norm 'ln')")
        self.cfg = cfg
        self._prepared = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device: Optional[Union[str, torch.device]] = "cuda") -> dict:
        """Seeded random parameters on ``device`` in the reference's scales:
        normal · D^-1/2 attention projections, normal · d_in^-1/2 MLPs,
        normal · 0.02 embedding, normal · 0.01 decoder positions, zero
        biases, unit LayerNorm gains. ``torch.Generator`` draws differ from
        ``jax.random``'s; tests carry JAX weights across instead.
        ``device="meta"`` gives the shapes and dtypes alone."""
        cfg = self.cfg
        device = resolve_device(device)
        meta = device.type == "meta"      # shapes and dtypes only
        gen = (seed if isinstance(seed, torch.Generator) or meta
               else torch.Generator(device=device).manual_seed(int(seed)))
        dtype = cfg.params_dtype
        D, F = cfg.d_model, cfg.d_ff

        def normal(shape, scale):
            if meta:
                return torch.empty(shape, dtype=dtype, device=device)
            return (torch.randn(shape, generator=gen, device=device)
                    * scale).to(dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def ln(L):
            return {"w": torch.ones((L, D), dtype=dtype, device=device),
                    "b": zeros(L, D)}

        def attn(L):
            s = D ** -0.5
            return {"wq": normal((L, D, cfg.attn_dim), s),
                    "bq": zeros(L, cfg.attn_dim),
                    "wk": normal((L, D, cfg.kv_dim), s),
                    "bk": zeros(L, cfg.kv_dim),
                    "wv": normal((L, D, cfg.kv_dim), s),
                    "bv": zeros(L, cfg.kv_dim),
                    "wo": normal((L, cfg.attn_dim, D), s),
                    "bo": zeros(L, D)}

        def mlp(L):
            return {"wu": normal((L, D, F), D ** -0.5), "bu": zeros(L, F),
                    "wd": normal((L, F, D), F ** -0.5), "bd": zeros(L, D)}

        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        final = {k: v[0] for k, v in ln(1).items()}
        return {
            "embed": normal((cfg.vocab_size, D), 0.02),
            "dec_pos": normal((cfg.max_seq, D), 0.01),
            "enc_blocks": {"attn_norm": ln(Le), "attn": attn(Le),
                           "mlp_norm": ln(Le), "mlp": mlp(Le)},
            "dec_blocks": {"attn_norm": ln(Ld), "attn": attn(Ld),
                           "cross_norm": ln(Ld), "cross": attn(Ld),
                           "mlp_norm": ln(Ld), "mlp": mlp(Ld)},
            "enc_final_norm": dict(final),
            "final_norm": {k: v.clone() for k, v in final.items()},
        }

    # -------------------------------------------------------------- forward
    def _dims(self) -> AttnDims:
        cfg = self.cfg
        return AttnDims(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope=False,
                        causal_segments=cfg.attn_causal_segments)

    def prepare(self, params: dict):
        """The params cast to the compute dtype (every float32 leaf, as the
        reference's ``_cast``) and the per-layer views of both stacks —
        once per params object; under autograd, with a leaf that requires
        grad, every call (``lm.prepared``)."""
        cfg = self.cfg
        tr = current_train()
        if tr is not None:
            # a sharded train step: this rank's blocks, each layer
            # gathered where it runs
            top, stacks = tr.prepare(params)
            return top, stacks["enc_blocks"], stacks["dec_blocks"]

        def build():
            p = cast_for_compute(params, cfg.compute_dtype)
            return (p, [_layer(p["enc_blocks"], i)
                        for i in range(cfg.n_enc_layers)],
                    [_layer(p["dec_blocks"], i) for i in range(cfg.n_layers)])

        entry, self._prepared = prepared(self._prepared, params, build)
        return entry[1:]

    def _run(self, fn, *args, stats=None):
        """``fn(*args, stats)``, under ``checkpoint`` where this forward
        remats (``cfg.remat``, autograd on, no stats captured)."""
        if isinstance(args[0], LayerBlocks):
            fn = gathering(fn)
        if self.cfg.remat and stats is None and torch.is_grad_enabled():
            return checkpoint(fn, *args, stats, use_reentrant=False)
        return fn(*args, stats)

    def encode(self, params, frames: torch.Tensor, *,
               capture: bool = False):
        """frames [B, enc_seq, D] (the stubbed front end's embeddings) →
        the encoder states [B, enc_seq, D], and with ``capture`` the stats
        (``attn_in``, ``o_in``, ``mlp_in``, ``down_in`` stacked [L, ...])."""
        cfg = self.cfg
        p, enc, _ = self.prepare(params)
        compute = cfg.compute_dtype
        x = frames.to(compute) + sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(compute)
        per_layer = []
        for lp in enc:
            st = {} if capture else None
            x = self._run(self._enc_layer, lp, x, stats=st)
            per_layer.append(st)
        x = apply_norm(x, p["enc_final_norm"], "ln")
        return x, (_stack_stats(per_layer) if capture else {})

    def _enc_layer(self, lp, x, st):
        h = apply_norm(x, lp["attn_norm"], "ln")
        x = x + causal_attention_block(lp["attn"], h, self._dims(),
                                       capture=st, causal=False)
        h = apply_norm(x, lp["mlp_norm"], "ln")
        return x + mlp_block(lp["mlp"], h, self.cfg.act, capture=st)

    def _dec_layer(self, lp, x, self_attn, kv, st):
        """One decoder layer: ``self_attn(h, capture)`` the self-attention
        (causal, or over the cache), ``kv`` the cross keys and values;
        ``st`` (a dict) receives the layer's stats, the reference's
        names."""
        cap = st is not None
        h = apply_norm(x, lp["attn_norm"], "ln")
        self_st, cross_st, mlp_st = ({} if cap else None for _ in range(3))
        x = x + self_attn(h, self_st)
        h = apply_norm(x, lp["cross_norm"], "ln")
        x = x + cross_attention_block(lp["cross"], h, self._dims(),
                                      kv=kv, capture=cross_st)
        h = apply_norm(x, lp["mlp_norm"], "ln")
        x = x + mlp_block(lp["mlp"], h, self.cfg.act, capture=mlp_st)
        if cap:
            st.update({f"dec_{k}": v for k, v in self_st.items()})
            st.update({f"cross_{k}": v for k, v in cross_st.items()})
            st.update({f"dec_{k}": v for k, v in mlp_st.items()})
        return x

    def decode(self, params, tokens: torch.Tensor,
               enc_out: Optional[torch.Tensor], *,
               cache: Optional[dict] = None, capture: bool = False,
               chunk_kv: Optional[int] = None):
        """The decoder over tokens [B, T]: teacher-forced against
        ``enc_out`` (no cache; ``chunk_kv`` chunks its causal
        self-attention), or from ``cache["pos"]`` over a warmed cache
        (self-attention ring written in place, cross keys and values read;
        ``chunk_kv`` chunks the attention over the cache alike). Returns
        (logits [B, T, V], the new cache or None, stats)."""
        cfg = self.cfg
        p, _, dec = self.prepare(params)
        B, T = tokens.shape
        dev = tokens.device
        pos0 = cache["pos"] if cache is not None else torch.zeros(
            (), dtype=torch.int64, device=dev)
        positions = pos0 + torch.arange(T, device=dev)
        tr = current_train()
        if tr is not None:
            x = tr.embed(p["embed"], tokens, "embed" in cut_of(p),
                         cfg.compute_dtype)
        else:
            x = p["embed"][tokens].to(cfg.compute_dtype)
        x = x + p["dec_pos"][positions].to(cfg.compute_dtype)
        slots = (slot_write(cache["kpos"], positions)
                 if cache is not None else None)
        dims = self._dims()
        per_layer = []
        for i, lp in enumerate(dec):
            st = {} if capture else None
            if cache is None:
                def layer(lp, x, st):
                    def self_attn(h, cap):
                        return causal_attention_block(lp["attn"], h, dims,
                                                      capture=cap,
                                                      chunk_kv=chunk_kv)

                    return self._dec_layer(lp, x, self_attn,
                                           cross_kv(lp["cross"], enc_out,
                                                    dims), st)

                x = self._run(layer, lp, x, stats=st)
            else:
                def self_attn(h, cap, lp=lp, i=i):
                    return attention_block(lp["attn"], h, dims,
                                           positions=positions, slots=slots,
                                           chunk_kv=chunk_kv,
                                           cache={"k": cache["k"][i],
                                                  "v": cache["v"][i]})

                x = self._dec_layer(lp, x, self_attn,
                                    (cache["ck"][i], cache["cv"][i]), st)
            per_layer.append(st)
        x = apply_norm(x, p["final_norm"], "ln")
        if tr is not None and "embed" in cut_of(p):
            logits = tr.logits(x, p["embed"].t())   # this rank's vocab
        else:
            logits = x @ p["embed"].t().to(x.dtype)
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "kpos": slots.kpos, "pos": pos0 + T}
        return logits, new_cache, (_stack_stats(per_layer) if capture
                                   else {})

    def _frames(self, tokens, frames):
        if frames is None:
            cfg = self.cfg
            frames = torch.zeros((tokens.shape[0], cfg.enc_seq, cfg.d_model),
                                 dtype=cfg.compute_dtype, device=tokens.device)
        return frames

    def apply(self, params, tokens: torch.Tensor,
              frames: Optional[torch.Tensor] = None, *,
              capture: bool = False, chunk_kv: Optional[int] = None):
        """The teacher-forced forward: tokens [B, T] and frames (default: the
        zeros stub) → logits [B, T, V]; with ``capture`` (logits, stats),
        the encoder's stats prefixed ``enc_`` beside the decoder's
        (``dec_*``, ``cross_*``), as the reference names them. ``chunk_kv``
        chunks the decoder's self-attention."""
        enc_out, enc_stats = self.encode(params, self._frames(tokens, frames),
                                         capture=capture)
        logits, _, dec_stats = self.decode(params, tokens, enc_out,
                                           capture=capture, chunk_kv=chunk_kv)
        if not capture:
            return logits
        return logits, {**{f"enc_{k}": v for k, v in enc_stats.items()},
                        **dec_stats}

    def loss(self, params, batch: dict, *,
             chunk_kv: Optional[int] = None) -> torch.Tensor:
        """Mean next-token cross entropy (float32 logits) over
        ``batch["tokens"]`` / ``batch["labels"]``, the encoder fed
        ``batch.get("frames")``; differentiable, as ``LMModel.loss`` (a
        vocab-parallel head under a sharded train step too)."""
        logits = self.apply(params, batch["tokens"], batch.get("frames"),
                            chunk_kv=chunk_kv).float()
        tr = current_train()
        if tr is not None and logits.shape[-1] < self.cfg.vocab_size:
            return tr.nll(logits, batch["labels"]).mean()
        gold = torch.gather(logits, -1, batch["labels"][..., None].long())
        return (torch.logsumexp(logits, -1) - gold[..., 0]).mean()

    def calibration_stats(self, params, tokens: torch.Tensor,
                          frames: Optional[torch.Tensor] = None) -> dict:
        """Synthetic-calibration E[x] per stat key (tokens and frames are
        random): ``apply(..., capture=True)``'s stats."""
        return self.apply(params, tokens, frames, capture=True)[1]

    # ---------------------------------------------------------------- cache
    def cache_len(self, seq_len: int) -> int:
        return seq_len

    def init_cache(self, batch: int, seq_len: int, *,
                   device: Optional[Union[str, torch.device]] = "cuda",
                   dtype: Optional[torch.dtype] = None,
                   per_slot: bool = False) -> dict:
        """The whole-batch fp cache (``dtype``, default the compute dtype):
        the self-attention ring and the zeroed cross keys and values
        (``warm_cache`` fills them). The reference's encoder-decoder keeps
        an fp cache whatever ``kv_cache_bits`` says, and has no per-slot
        form; ``per_slot=True`` raises."""
        if per_slot:
            raise ValueError(
                f"per-slot caches are only supported for decoder-only "
                f"models (got {self.cfg.name!r}, an encoder-decoder)")
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or cfg.compute_dtype
        L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

        def zeros(S):
            return torch.zeros((L, batch, S, H, hd), dtype=dtype,
                               device=device)

        return {"k": zeros(seq_len), "v": zeros(seq_len),
                "ck": zeros(cfg.enc_seq), "cv": zeros(cfg.enc_seq),
                "kpos": torch.full((seq_len,), -1, dtype=torch.int64,
                                   device=device),
                "pos": torch.zeros((), dtype=torch.int64, device=device)}

    def warm_cache(self, params, frames: torch.Tensor, cache: dict) -> dict:
        """The encoder pass and the cross keys and values of every decoder
        layer (once a request), written into ``cache["ck"]`` /
        ``cache["cv"]`` in place; returns the cache."""
        enc_out, _ = self.encode(params, frames)
        _, _, dec = self.prepare(params)
        for i, lp in enumerate(dec):
            k, v = cross_kv(lp["cross"], enc_out, self._dims())
            cache["ck"][i].copy_(k.to(cache["ck"].dtype))
            cache["cv"][i].copy_(v.to(cache["cv"].dtype))
        return cache

    def prefill(self, params, tokens, cache, *,
                chunk_kv: Optional[int] = None):
        logits, new_cache, _ = self.decode(params, tokens, None, cache=cache,
                                           chunk_kv=chunk_kv)
        return logits[:, -1], new_cache

    def decode_step(self, params, token, cache):
        """token [B, 1] → (logits [B, V], cache)."""
        logits, new_cache, _ = self.decode(params, token, None, cache=cache)
        return logits[:, -1], new_cache

    # ------------------------------------------------------------- DFQ plan
    def dfq_plan(self) -> DFQPlan:
        """The reference's plan, op for op and site for site: per stack the
        LayerNorm folds (γ into the consumers, β into their biases), the
        exact V/O and Q/K pairs and the V-bias absorption of each attention
        (the decoder's cross attention too), and the approximate plain-GELU
        MLP pair."""
        cfg = self.cfg
        ops: list = []
        sites: list = []
        heads = dict(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
                     head_dim=cfg.head_dim)
        for stack, pre in (("enc_blocks", "enc"), ("dec_blocks", "dec")):
            def P(*rest, stack=stack):
                return (stack,) + rest

            attns = [("attn", f"{pre}_attn")]
            if stack == "dec_blocks":
                attns.append(("cross", "cross_attn"))
            for key, _ in attns:
                norm = "attn_norm" if key == "attn" else "cross_norm"
                ops.append(NormFoldOp(
                    norm_w=P(norm, "w"), norm_b=P(norm, "b"),
                    consumers=[P(key, "wq"), P(key, "wk"), P(key, "wv")],
                    consumer_biases=[P(key, "bq"), P(key, "bk"),
                                     P(key, "bv")]))
                ops.append(VOPairOp(wv=P(key, "wv"), wo=P(key, "wo"),
                                    bv=P(key, "bv"), **heads))
                ops.append(QKPairOp(wq=P(key, "wq"), wk=P(key, "wk"),
                                    bq=P(key, "bq"), bk=P(key, "bk"),
                                    rope=False, **heads))
                ops.append(VBiasAbsorbOp(bv=P(key, "bv"), wo=P(key, "wo"),
                                         bo=P(key, "bo"), **heads))
                in_stat = f"{pre}_attn_in" if key == "attn" else "cross_attn_in"
                o_stat = f"{pre}_o_in" if key == "attn" else "cross_o_in"
                sites += [
                    WeightSite(f"{pre}_{key}_wq", P(key, "wq"), P(key, "bq"),
                               "dense", in_stat),
                    WeightSite(f"{pre}_{key}_wk", P(key, "wk"), P(key, "bk"),
                               "dense", None),
                    WeightSite(f"{pre}_{key}_wv", P(key, "wv"), P(key, "bv"),
                               "dense", None),
                    WeightSite(f"{pre}_{key}_wo", P(key, "wo"), P(key, "bo"),
                               "dense", o_stat),
                ]
            ops.append(NormFoldOp(
                norm_w=P("mlp_norm", "w"), norm_b=P("mlp_norm", "b"),
                consumers=[P("mlp", "wu")], consumer_biases=[P("mlp", "bu")]))
            # plain-GELU MLP: CLE is approximate here
            ops.append(DensePairOp(w1=P("mlp", "wu"), b1=P("mlp", "bu"),
                                   w2=P("mlp", "wd"), exact=False))
            sites += [
                WeightSite(f"{pre}_wu", P("mlp", "wu"), P("mlp", "bu"),
                           "dense", f"{pre}_mlp_in"),
                WeightSite(f"{pre}_wd", P("mlp", "wd"), P("mlp", "bd"),
                           "dense", f"{pre}_down_in"),
            ]
        return DFQPlan(tuple(ops), tuple(sites), cfg.name)
