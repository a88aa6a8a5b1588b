"""One rank's part of a sharded train step — the port's own, beside
``tp.py`` (serving): what the reference's GSPMD program does implicitly
under its train-mode specs.

At rest every parameter, gradient and AdamW moment is this rank's block
under ``params_pspecs(..., mode="train")``: FSDP over "data" on the in dim,
Megatron TP over "model", the stacked ``[L, ...]`` dim never cut, anything
non-divisible replicated. ``TrainShard`` holds what those specs mean for
the forward:

  * a layer's leaves are gathered when the layer runs (``LayerBlocks``,
    one layer of a stacked tree at a time, inside the function a remat
    recomputes: the backward gathers again, every rank in one order) —
    over "data" by ``collectives.fsdp_gather``, whose backward sums the
    gradient over the data-parallel group and cuts it back to the block
    (a leaf that "data" does not cut takes ``grad_sum`` over that group
    instead); float32 leaves then cast to the compute dtype, as
    ``lm.cast_for_compute`` casts them;
  * a leaf stays cut over "model" where the layers run it partitioned —
    the attention and MLP projections (column-parallel q/k/v, gate/up;
    row-parallel o/down; an MoE block's experts and shared expert) and the
    vocab-parallel embedding and head — and the gathered dict says which
    (``Gathered.cut``); any other leaf the specs cut over "model" (the
    SSM mixer's, the cross attention's, a router cut at 128 experts, the
    decoder positions) is gathered whole by ``gather_forward``, whose
    backward keeps this rank's block of the gradient;
  * the batch: this rank's rows by ``batch_pspec`` (every row where the
    global batch does not divide the data-parallel world);
  * the clip's global norm counts each leaf once: on the ranks at
    coordinate 0 of every axis its spec does not use (``counted``).

The layers read the running shard from ``current_train()`` (the train
step's ``train_scope``) and the attention's mode from ``layers``'s shard
context (``set_shard_ctx``, armed by ``launch.steps
.configure_sharding_hints``): head-parallel where the model axis divides
the heads, sequence-parallel otherwise. On a model axis of 1 nothing is
cut over "model" and the layers run their single-device code.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

import torch

from . import collectives as coll
from .partition import (
    _dp_world,
    batch_pspec,
    local_block,
    mesh_coords,
    mesh_sizes,
    spec_paths,
)
from .tp import dp_group

#: leaves the layers run cut over "model" (by name)
TP_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "embed", "lm_head")
#: subtrees whose leaves the layers run whole (the cross attention, the
#: SSM mixer)
WHOLE_UNDER = ("/cross/", "/mixer/")
#: the stacked trees gathered a layer at a time
STACKS = ("blocks", "enc_blocks", "dec_blocks")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("train_shard",
                                                          default=None)


def current_train() -> Optional["TrainShard"]:
    """The shard of the training forward being run (None: one device)."""
    return _CURRENT.get()


@contextlib.contextmanager
def train_scope(shard: Optional["TrainShard"]):
    token = _CURRENT.set(shard)
    try:
        yield shard
    finally:
        _CURRENT.reset(token)


class Gathered(dict):
    """A layer's leaves as its forward reads them; ``cut`` names the
    direct children that stay cut over "model"."""

    def __init__(self, items, cut=()):
        super().__init__(items)
        self.cut = frozenset(cut)


def cut_of(p) -> frozenset:
    """The names of ``p``'s leaves cut over "model" (none outside a
    sharded training forward)."""
    return getattr(p, "cut", frozenset())


def _axes(a) -> tuple:
    return (a,) if isinstance(a, str) else tuple(a or ())


class LayerBlocks:
    """Layer ``i`` of a stacked tree's blocks, gathered by ``gather()``."""

    def __init__(self, shard: "TrainShard", tree: dict, i: int, prefix: str):
        self.shard, self.tree, self.i, self.prefix = shard, tree, i, prefix

    def gather(self) -> Gathered:
        return self.shard.gather(self.tree, self.prefix, layer=self.i)


class TrainShard:
    """This rank's blocks and groups under ``mesh`` for a model of ``cfg``
    whose params the planner placed by ``specs`` (a spec tree of the whole
    params, ``launch.steps.state_specs``')."""

    def __init__(self, mesh, cfg, specs, *, attn_seq: bool = False,
                 kv_heads_ok: bool = False):
        sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
        self.mesh, self.cfg, self.specs = mesh, cfg, specs
        self.sizes, self.coords = sizes, coords
        self.model_n = sizes.get("model", 1)
        self.model_rank = coords.get("model", 0)
        self.model_group = mesh.get_group("model")
        self.data_n = sizes["data"]
        self.data_group = mesh.get_group("data")
        _, self.dp_n = _dp_world(mesh)
        self.dp_group = dp_group(mesh)
        self.attn_seq, self.kv_heads_ok = attn_seq, kv_heads_ok
        self.flat = dict(spec_paths(specs))

    @property
    def tp(self) -> bool:
        """Whether the layers run partitioned over "model"."""
        return self.model_n > 1

    # ---------------------------------------------------------- the gather
    def leaf(self, t: torch.Tensor, path: str, spec) -> tuple:
        """(``t`` as the forward reads it, whether it stays cut over
        "model")."""
        name = path.rsplit("/", 1)[-1]
        keep = name in TP_NAMES and not any(w in path for w in WHOLE_UNDER)
        data = [d for d, a in enumerate(spec) if "data" in _axes(a)]
        if data and self.data_n > 1:
            t = coll.fsdp_gather(t, data[0], self.data_group, self.dp_group)
        elif self.dp_n > 1:
            t = coll.grad_sum(t, self.dp_group)
        cut = False
        if self.model_n > 1:
            for d, a in enumerate(spec):
                if "model" in _axes(a):
                    if keep:
                        cut = True
                    else:
                        t = coll.gather_forward(t, d, self.model_group)
        compute = self.cfg.compute_dtype
        if t.dtype == torch.float32 and compute != torch.float32:
            t = t.to(compute)
        return t, cut

    def gather(self, tree, prefix: str, layer: Optional[int] = None):
        """``tree`` (at ``prefix`` in the params) gathered; with ``layer``,
        that layer of a stacked tree (its spec's first dim dropped)."""
        if isinstance(tree, dict):
            items, cut = {}, []
            for k, v in tree.items():
                path = f"{prefix}/{k}"
                if isinstance(v, dict):
                    items[k] = self.gather(v, path, layer)
                    continue
                spec = self.flat[path]
                if layer is not None:
                    v, spec = v[layer], tuple(spec)[1:]
                items[k], c = self.leaf(v, path, spec)
                if c:
                    cut.append(k)
            return Gathered(items, cut)
        raise TypeError(f"{prefix}: a params subtree is a dict")

    def prepare(self, params: dict) -> tuple:
        """(the params outside the stacked trees, gathered; {stack name:
        [LayerBlocks of each layer]})."""
        top = self.gather({k: v for k, v in params.items()
                           if k not in STACKS}, "")
        stacks = {}
        for k in STACKS:
            if k in params:
                n = next(iter(_tensors(params[k]))).shape[0]
                stacks[k] = [LayerBlocks(self, params[k], i, f"/{k}")
                             for i in range(n)]
        return top, stacks

    # ---------------------------------------------------------- the batch
    def rows(self, batch: dict) -> dict:
        """This rank's rows of every tensor of ``batch`` (``batch_pspec``:
        every row where the batch does not divide the data-parallel
        world)."""
        out = {}
        for k, v in batch.items():
            spec = batch_pspec(self.mesh, v.ndim, batch=v.shape[0])
            out[k] = local_block(v, spec, self.mesh).contiguous()
        return out

    # ------------------------------------------------- the vocab-parallel head
    def embed(self, w: torch.Tensor, tokens: torch.Tensor, cut: bool,
              dtype) -> torch.Tensor:
        """The embedding rows of ``tokens``: where ``cut`` (``w`` this
        rank's vocab rows) each rank's own rows, zeros for the other ids,
        summed over "model" (one non-zero term an element)."""
        if not cut:
            return w[tokens].to(dtype)
        lo = self.model_rank * w.shape[0]
        mine = (tokens >= lo) & (tokens < lo + w.shape[0])
        rows = w[torch.where(mine, tokens - lo, 0)].to(dtype)
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return coll.sum_forward(rows, self.model_group)

    def logits(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """This rank's vocab columns of the logits, ``w`` [D, V/M] its
        columns of the head (Megatron's *f* on ``h``)."""
        return coll.grad_sum(h, self.model_group) @ w.to(h.dtype)

    def nll(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per position, logsumexp minus the gold logit, of float32 logits
        cut over "model" (this rank's vocab columns): the max and the sum
        of exponentials reduced over "model", the gold logit from the rank
        that owns it."""
        lf = logits.float()
        V = lf.shape[-1]
        m = coll.all_reduce_max(lf.detach().amax(dim=-1), self.model_group)
        se = torch.exp(lf - m[..., None]).sum(dim=-1)
        lse = torch.log(coll.sum_forward(se, self.model_group)) + m
        cols = torch.arange(V, device=lf.device) + self.model_rank * V
        gold = torch.where(cols == labels[..., None].long(), lf,
                           torch.zeros_like(lf)).sum(dim=-1)
        return lse - coll.sum_forward(gold, self.model_group)

    # ---------------------------------------------------------- the clip
    def counted(self) -> Any:
        """A tree of bools beside the params: True where this rank's block
        of the leaf is counted in a global sum — at coordinate 0 of every
        mesh axis its spec does not use."""
        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
            used = {x for a in self.flat[prefix] for x in _axes(a)}
            return all(self.coords[a] == 0 for a in self.sizes
                       if a not in used)

        return walk(self.specs, "")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree
