"""One rank's part of a tensor-parallel serving engine, and the scope that
hands it to the layers.

``ServeShard`` reads, once, what the planner's specs mean for the forward
(``params_pspecs(mode="serve")``, ``serve_cache_pspecs``): which slots this
rank holds ("data", or all of them where the pool does not divide the DP
world or is paged), which KV heads ("model"), which projections are
column-parallel (q/k/v, gate/up: their out dim on "model") and row-parallel
(o/down: their in dim), whether the embedding and the logits are
vocab-parallel. The engine enters ``tp_scope(shard)`` around its forwards;
``current_shard()`` is None outside one, and the layers then run their
single-device code.

The forward under a shard, what GSPMD partitions implicitly in the
reference:

  * a column-parallel projection reads whole activation rows and writes
    this rank's columns; its 1-D bias (replicated in the planner) is cut to
    the same columns where it is added;
  * attention is head-local where the model axis divides both head counts
    (``head_local``: the reference's ``_serve_decode_partition`` guard, off
    at a model axis of 1): this rank's q heads over its KV heads, no
    collective; elsewhere every rank attends over every head;
  * a row-parallel projection multiplies this rank's K slice and sums the
    partials over "model" (``layers._row_linear``), its bias added once;
  * an MoE block (the reference serves it through ``_moe_block_local``,
    GSPMD partitioning it under these specs) keeps its router whole on
    every rank — a cut router GEMM may sum in another order and flip a
    top-k choice — and dispatches and combines this rank's slots locally;
    the experts' gate/up are column-parallel over F (one expert-batched
    launch a projection), their down row-parallel, the shared expert an
    MLP under the same rules (``col`` / ``row`` keys ``experts/…`` and
    ``shared/…``);
  * the embedding gathers this rank's vocab rows and sums the ranks'
    (one non-zero term an element), the logits are this rank's vocab
    columns, and the engine's greedy pick and non-finite flag reduce over
    them.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from . import collectives as coll
from .partition import (
    MIN_SHARD_DIM,
    _dp_world,
    mesh_coords,
    mesh_sizes,
    params_pspecs,
    spec_paths,
)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("serve_shard",
                                                          default=None)


def current_shard() -> Optional["ServeShard"]:
    """The shard of the forward being run (None: single device)."""
    return _CURRENT.get()


@contextlib.contextmanager
def tp_scope(shard: Optional["ServeShard"]):
    token = _CURRENT.set(shard)
    try:
        yield shard
    finally:
        _CURRENT.reset(token)


def dp_group(mesh):
    """The data-parallel process group: "data"'s, or over ("pod", "data")
    where the mesh has a pod axis (``launch.mesh`` builds it)."""
    group = getattr(mesh, "repro_dp_group", None)
    return group if group is not None else mesh.get_group("data")


def _spec_of(specs: dict, block: str, name: str):
    """The spec of ``/blocks/<block>/<name>`` (its payload's for a
    QTensor), or None where the model has no such leaf."""
    for path in (f"/blocks/{block}/{name}", f"/blocks/{block}/{name}/q"):
        if path in specs:
            return specs[path]
    return None


class ServeShard:
    """This rank's slots, heads and projections under ``mesh``."""

    def __init__(self, mesh, cfg, params, *, num_slots: int, paged: bool,
                 backend: str):
        sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
        self.mesh = mesh
        self.backend = backend
        self.model_n = sizes["model"]
        self.model_rank = coords["model"]
        self.model_group = mesh.get_group("model")
        _, self.dp_n = _dp_world(mesh)
        self.dp_rank = coords["data"] + (coords.get("pod", 0) * sizes["data"])
        self.dp_group = dp_group(mesh)
        heads = {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}
        #: the planner's serve-mode specs (what an artifact records)
        self.specs = params_pspecs(params, mesh, heads, mode="serve")
        flat = dict(spec_paths(self.specs))
        # the router stays whole on every rank (a cut router GEMM may sum
        # in another order and flip a top-k choice); the planner cuts it
        # only at MIN_SHARD_DIM experts, which no arch of the catalog has
        router = _spec_of(flat, "mlp", "router")
        if router is not None and any(
                "model" in (a if isinstance(a, tuple) else (a,))
                for a in router):
            raise NotImplementedError(
                f"{cfg.name}: the planner cuts the MoE router's "
                f"{cfg.n_experts} experts over \"model\" (at least "
                f"{MIN_SHARD_DIM}); serving holds the router whole on every "
                f"rank and does not cut it")
        # slots: the serve cache's rule (no MIN_SHARD_DIM floor); a paged
        # pool replicates them
        self.slots_sharded = (not paged and num_slots % self.dp_n == 0
                              and num_slots >= self.dp_n)
        per = num_slots // self.dp_n if self.slots_sharded else num_slots
        self.slot_lo = self.dp_rank * per if self.slots_sharded else 0
        self.slot_hi = self.slot_lo + per
        # KV heads of the cache (serve_cache_pspecs), and the attention
        n_kv = cfg.n_kv_heads
        self.kv_heads_sharded = n_kv % self.model_n == 0 and n_kv >= self.model_n
        self.head_local = (self.model_n > 1 and cfg.n_heads % self.model_n == 0
                           and n_kv % self.model_n == 0)
        self.kv_heads = n_kv // self.model_n if self.kv_heads_sharded else n_kv
        # the flags key a dense projection by its name, an MoE block's by
        # its subtree's too (experts/wd, shared/wu), present where the
        # model has them
        self.col, self.row = {}, {}
        for block, key in (("attn", ""), ("mlp", ""),
                           ("mlp/experts", "experts/"),
                           ("mlp/shared", "shared/")):
            names = ("wq", "wk", "wv", "wo") if block == "attn" else (
                "wg", "wu", "wd")
            for name in names:
                spec = _spec_of(flat, block, name)
                if key and spec is None:
                    continue
                if name in ("wo", "wd"):
                    self.row[key + name] = (spec is not None
                                            and spec[-2] == "model")
                else:
                    self.col[key + name] = (spec is not None
                                            and spec[-1] == "model")
        embed = flat.get("/embed")
        self.embed_sharded = embed is not None and embed[0] == "model"
        head = flat.get("/lm_head")
        self.logits_sharded = (head[1] == "model" if head is not None
                               else self.embed_sharded)

    # ------------------------------------------------------------ helpers
    def block(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` over "model"."""
        n = t.shape[dim] // self.model_n
        return t.narrow(dim, self.model_rank * n, n)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks of ``t`` along ``dim`` over "model", whole."""
        return coll.all_gather(t, dim, self.model_group)

    def col_bias(self, b: Optional[torch.Tensor], name: str):
        """A column-parallel projection's bias, cut to this rank's columns
        where the projection is sharded."""
        if b is None or not self.col.get(name):
            return b
        return self.block(b)

    def heads(self, t: torch.Tensor, name: str, local: bool) -> torch.Tensor:
        """A projection's output [..., cols] as the attention reads it:
        this rank's heads where ``local``, else all of them."""
        sharded = self.col[name]
        if sharded and not local:
            return self.gather(t)
        if local and not sharded:
            return self.block(t)
        return t

    def vocab_offset(self, local_vocab: int) -> int:
        return self.model_rank * local_vocab if self.logits_sharded else 0

    def pick(self, logits: torch.Tensor):
        """(greedy token int64, non-finite flag) of each row of this rank's
        logits, over the vocab shards."""
        bad = ~torch.isfinite(logits).all(dim=-1)
        if not self.logits_sharded:
            return torch.argmax(logits, dim=-1), bad
        tok = coll.argmax(logits, self.vocab_offset(logits.shape[-1]),
                          self.model_group)
        return tok, coll.any_true(bad, self.model_group)

    def gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of this rank's per-slot output (dim 0), on
        every rank of the data-parallel group."""
        return coll.all_gather(t, 0, self.dp_group)
