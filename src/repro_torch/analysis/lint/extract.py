"""Graph extraction: record the serve paths as op graphs (port of
``repro.analysis.lint.extract``).

For a recipe + mesh shape this builds a ``LintGraph``:

  * each of the four engine paths (the stepwise ``prefill`` and
    ``decode``, the fast ``prefill_multi`` and ``decode_horizon`` at
    k = ``decode_horizon``) as a ``JitArtifact`` holding its ``OpGraph``
    (``graph_model``): the engine's own dispatch run once with every row
    masked (``ServingEngine.serve_jit_specs``), under the recorder;
  * the registered serving kernels (``kernels.serving_kernel_specs``),
    each recorded alone (no pool: the dtype ledger still covers them);
  * the pool's leaf shapes (global and this rank's) the in-place audit and
    the collective rule match against;
  * the sharding-spec tables (params + cache) and QTensor payload/scale
    pairs the scale-coupling rule checks;
  * the engine's warmup / dispatch shape sets, and on a live engine its
    captured graphs and their pool addresses.

Two modes. **Static** (``live=False``, the contracts' mode): each path runs
on ``meta`` copies of the params, the pool and (paged) the dense view, at
the plain tier — shapes and dtypes only, so nothing runs and the engine's
own tensors are untouched. **Live** (``live=True``, ``lint_engine`` and
``serve --lint``): each path runs on the engine's own tensors at its own
tier — on the card, the kernels themselves, each a kernel node, their
launches counted as any others (``OpGraph.launches`` holds each path's).
A masked dispatch leaves bookkeeping and live K/V as they were, so a live
lint changes nothing a later request reads.

A ``-tp`` recipe's engine (``build_graph``) runs as rank 0 of a fake world
of the mesh's size (``launch.dryrun.fake_mesh``, whose collectives do
nothing); the collectives are the logical ones each path reports.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from .graph_model import OpGraph, dtype_name, type_str


@dataclasses.dataclass
class JitArtifact:
    """One recorded serve path (or a standalone kernel)."""

    name: str
    kind: str                    # "prefill" | "decode" | "kernel"
    graph: Optional[OpGraph] = None
    # (dtype, dims) of every pool leaf — global and this rank's
    cache_leaves_global: list = dataclasses.field(default_factory=list)
    cache_leaves_local: list = dataclasses.field(default_factory=list)
    # trailing dims of a cache payload leaf as the attention reads it
    # ([S, Hkv, hd]; a paged pool's dense view's) — a convert outside
    # every kernel matching these is a whole-ring dequant (dtype-ledger)
    cache_payload_dims: tuple = ()
    # (dtype, dims) of the paged pool's page table (global + local; empty
    # for a contiguous pool) — left out of pool-collective matching
    page_table_shapes: list = dataclasses.field(default_factory=list)
    # (dtype, dims) of the payload leaves (this rank's): a tensor of one
    # of these that an op outside a kernel allocates is a pool copy
    pool_payload: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LintGraph:
    recipe: str
    mesh_shape: Optional[tuple]
    engine: dict                                  # fingerprint (arch, knobs)
    jits: dict = dataclasses.field(default_factory=dict)
    warmup_shapes: set = dataclasses.field(default_factory=set)
    dispatch_shapes: set = dataclasses.field(default_factory=set)
    # {path: {"dtype", "shape", "spec"}} for params and pool leaves
    param_leaves: dict = dataclasses.field(default_factory=dict)
    cache_spec_leaves: dict = dataclasses.field(default_factory=dict)
    scale_pairs: list = dataclasses.field(default_factory=list)
    # {leaf: "dtype[dims]"} of the pool (this rank's)
    pool_leaves: dict = dataclasses.field(default_factory=dict)
    # a live engine's: the (dispatch, dim) shapes of its captured CUDA
    # graphs (None: it builds none), whether warmup() ran, each graph's
    # pool addresses at its capture and the live pool's
    captured: Optional[set] = None
    warmed: bool = False
    captured_ptrs: dict = dataclasses.field(default_factory=dict)
    pool_ptrs: dict = dataclasses.field(default_factory=dict)


def _spec_entries(spec, rank: int) -> list:
    """A PartitionSpec → a JSON-able full-rank list of axis entries (None /
    "axis" / ["axis", ...]); trailing dims replicate."""
    entries: list = [None] * rank
    if spec is None:
        return entries
    for i, e in enumerate(tuple(spec)[:rank]):
        entries[i] = list(e) if isinstance(e, tuple) else e
    return entries


def _leaf_table(tree, spec_tree) -> dict:
    """{path: {"dtype", "shape", "spec"}} over a (QTensor-bearing) tree,
    with full-rank spec entries where a spec tree is given."""
    from ...sharding.partition import _walk, spec_paths

    specs = dict(spec_paths(spec_tree)) if spec_tree is not None else {}
    out = {}
    for path, leaf in _walk(tree):
        shape = tuple(int(d) for d in leaf.shape)
        spec = specs.get(path)
        out[path] = {"dtype": dtype_name(leaf.dtype), "shape": list(shape),
                     "spec": (_spec_entries(spec, len(shape))
                              if spec is not None else None)}
    return out


def _global_dims(name: str, dims: tuple, shard) -> tuple:
    """A pool leaf's whole-pool dims from this rank's (``ServeShard``'s
    cut: slots over the data ranks, KV heads over the model ranks)."""
    if shard is None or name == "page_table":
        return dims
    d = list(dims)
    if name in ("kpos", "pos"):
        if shard.slots_sharded:
            d[0] *= shard.dp_n
    elif len(d) >= 4:
        if shard.slots_sharded:
            d[1] *= shard.dp_n
        if shard.kv_heads_sharded:
            d[3] *= shard.model_n
    return tuple(d)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device="meta")


def _tree_meta(tree):
    from ...quantized.qtensor import QTensor

    if isinstance(tree, torch.Tensor):
        return _meta(tree)
    if isinstance(tree, QTensor):
        return QTensor(_meta(tree.q), _meta(tree.scale), tree.mode)
    if isinstance(tree, dict):
        return {k: _tree_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_meta(v) for v in tree)
    return tree


@contextlib.contextmanager
def _on_meta(engine):
    """The engine with ``meta`` copies of its params, pool and dense view
    in place of its own (restored on leaving), its forwards prepared."""
    pool, model = engine.pool, engine.model
    saved = (engine.params, engine._prepared, pool.cache, model._prepared,
             getattr(pool, "storage", None), getattr(engine, "dense", None),
             getattr(engine, "_view", None))
    try:
        engine.params = _tree_meta(engine.params)
        if engine.paged:
            pool.storage = {n: _meta(t) for n, t in pool.storage.items()}
            pool.cache = {n: (pool.storage[n][:, :pool.num_pages]
                              if n in pool.storage else _meta(t))
                          for n, t in saved[2].items()}
            engine.dense = {n: _meta(t) for n, t in engine.dense.items()}
            engine._view = {**engine.dense, "kpos": pool.cache["kpos"],
                            "pos": pool.cache["pos"]}
        else:
            pool.cache = {n: _meta(t) for n, t in pool.cache.items()}
        engine._prepared = model.prepare(engine.params)
        yield engine
    finally:
        (engine.params, engine._prepared, pool.cache,
         model._prepared) = saved[:4]
        if engine.paged:
            pool.storage, engine.dense, engine._view = saved[4:]


def graph_from_engine(engine, recipe: str = "",
                      mesh_shape: Optional[tuple] = None,
                      include_kernels: bool = True,
                      live: bool = False) -> LintGraph:
    """Extract a ``LintGraph`` from a ``ServingEngine``: static (meta
    copies at the plain tier; nothing runs) or ``live`` (its own tensors
    at its own tier; see the module docstring)."""
    from ...kernels import lower_serving_kernels
    from ...serving.cache_pool import KNOWN_BOOKKEEPING
    from ...sharding.partition import (
        payload_scale_pairs,
        serve_cache_pspecs,
    )

    cfg, pool, shard = engine.cfg, engine.pool, engine.shard
    loc = [(dtype_name(t.dtype), tuple(int(d) for d in t.shape))
           for _, t in sorted(pool.cache.items())]
    glob = [(dt, _global_dims(n, dims, shard))
            for n, (dt, dims) in zip(sorted(pool.cache), loc)]
    payload = [(dt, dims) for n, (dt, dims) in zip(sorted(pool.cache), loc)
               if n not in KNOWN_BOOKKEEPING]
    table_shapes = []
    k_shape = tuple(int(d) for d in pool.cache["k"].shape)
    if engine.paged:
        pt = pool.cache["page_table"]
        dims = tuple(int(d) for d in pt.shape)
        table_shapes = [(dtype_name(pt.dtype), dims)] * 2
        # the paths attend through the dense view [L, B, S, Hkv, hd]
        payload_dims = (engine.max_len,) + k_shape[3:]
        payload += [(dtype_name(t.dtype), tuple(int(d) for d in t.shape))
                    for t in engine.dense.values()]
    else:
        payload_dims = k_shape[2:]                      # [S, Hkv, hd]
    if mesh_shape is None and engine.mesh is not None:
        mesh_shape = tuple(int(d) for d in engine.mesh.shape)

    graph = LintGraph(
        recipe=recipe,
        mesh_shape=tuple(mesh_shape) if mesh_shape else None,
        engine={
            "arch": cfg.name,
            "num_slots": engine.num_slots,
            "max_len": engine.max_len,
            "prefill_chunk": engine.prefill_chunk,
            "decode_horizon": engine.decode_horizon,
            "kv_bits": engine.kv_bits,
            "fast": engine.fast,
            "page_size": engine.page_size,
        },
        warmup_shapes=set(engine.warmup_shapes()),
        dispatch_shapes=set(engine.dispatch_shapes()),
        pool_leaves={n: type_str(t.dtype, t.shape)
                     for n, t in pool.cache.items()},
    )
    art_kw = dict(cache_leaves_global=glob, cache_leaves_local=loc,
                  cache_payload_dims=payload_dims,
                  page_table_shapes=table_shapes, pool_payload=payload)

    device = engine.device if live else "meta"
    with contextlib.nullcontext() if live else _on_meta(engine):
        paths = engine.lowered_serve_jits(device=device)
    for name, g in paths.items():
        graph.jits[name] = JitArtifact(
            name=name,
            kind="decode" if name.startswith("decode") else "prefill",
            graph=g, **art_kw)
    if include_kernels:
        kernels = lower_serving_kernels(
            head_dim=cfg.head_dim, n_kv_heads=cfg.n_kv_heads,
            n_q_heads=cfg.n_heads, seq=engine.max_len,
            batch=engine.num_slots, d_in=cfg.d_model, d_out=cfg.d_ff,
            device=device)
        for name, g in kernels.items():
            graph.jits[name] = JitArtifact(
                name=name, kind="kernel", graph=g,
                cache_payload_dims=payload_dims)

    if live:
        if engine.graphs is not None:
            graph.captured = engine.graphs.keys()
            graph.captured_ptrs = {k: engine.graphs.pool_ptrs(k)
                                   for k in graph.captured}
            graph.pool_ptrs = engine.pool_pointers()
        graph.warmed = engine.warmed

    # sharding-spec tables for scale-coupling: the serve-mode specs the
    # engine cut its params by, and the pool's over its whole shapes
    graph.param_leaves = _leaf_table(
        engine.params, shard.specs if shard is not None else None)
    c_specs = None
    if engine.mesh is not None:
        whole = {n: torch.empty(_global_dims(n, tuple(t.shape), shard),
                                dtype=t.dtype, device="meta")
                 for n, t in pool.cache.items()}
        c_specs = serve_cache_pspecs(whole, engine.mesh)
        graph.cache_spec_leaves = _leaf_table(whole, c_specs)
    else:
        graph.cache_spec_leaves = _leaf_table(pool.cache, None)
    graph.scale_pairs = payload_scale_pairs(engine.params)
    return graph


def build_graph(recipe: str, mesh_shape: Optional[tuple] = None,
                arch: str = "qwen2-0.5b", *, num_slots: int = 4,
                max_len: int = 32, prefill_chunk: int = 8,
                decode_horizon: int = 8, page_size: Optional[int] = None,
                include_kernels: bool = True) -> LintGraph:
    """Quantize ``arch``'s smoke model through ``recipe`` on the CPU and
    extract its static lint graph under ``mesh_shape`` (None: one device;
    a mesh: rank 0 of a fake world of its size). ``page_size`` lints the
    paged engine (the ``+paged`` recipe flag's geometry). The entry point
    of ``python -m repro_torch.analysis.lint``."""
    from ...configs import get_config
    from ...models import build_model
    from ...pipeline import quantize
    from ...serving import ServingEngine

    cfg = get_config(arch, smoke=True)
    qm = quantize(build_model(cfg), None, recipe=recipe, device="cpu")

    def make(mesh):
        engine = ServingEngine(
            qm.model, qm.params, qm.cfg, num_slots=num_slots,
            max_len=max_len, prefill_chunk=prefill_chunk,
            decode_horizon=decode_horizon, page_size=page_size,
            device="cpu", mesh=mesh)
        return graph_from_engine(engine, recipe=recipe,
                                 mesh_shape=mesh_shape,
                                 include_kernels=include_kernels)

    if not mesh_shape:
        return make(None)
    from ...launch.dryrun import fake_mesh

    with fake_mesh(tuple(mesh_shape)) as mesh:
        return make(mesh)
