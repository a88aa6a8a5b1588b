"""Rank processes for the port's sharded serving tests.

``run_ranks(world, tasks, tmp_path)`` spawns ``world`` processes in one
process group, over gloo on the CPU and a file store under ``tmp_path``;
every rank runs the same ``tasks``, each on its mesh (built once a shape
with ``launch.mesh.make_production_mesh``: ("data", "model") or ("pod",
"data", "model") meshes of ``world`` positions), and rank 0 returns their
results (a rank's exception is raised in the caller). The
ranks import torch and the port only — no JAX — and take one thread each,
so that several ranks share the test worker's cores.

A task is ``(name, kind, mesh shape, kwargs)``; kinds:

  * ``engine`` — a ``ServingEngine(mesh=...)`` over a model carried across
    from a numpy params tree serves requests: its tokens, finish ticks and
    statuses, its shard's layout, and the heads each fused decode saw;
  * ``logits`` — ``model.prefill`` of one sequence under the shard, the
    vocab shards gathered, beside the single-device prefill of the same
    params.
"""
from __future__ import annotations

import os
import pickle
import traceback


def run_ranks(world, tasks, tmp_path, timeout: float = 600.0) -> dict:
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(tasks, f)
    out = os.path.join(tmp, "out")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, os.path.join(tmp, "store"), job,
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    results = {}
    for r in range(world):
        path = f"{out}.{r}"
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[r] = pickle.load(f)
    for r, res in sorted(results.items()):
        if isinstance(res, str):
            raise RuntimeError(f"rank {r} of {world} failed:\n{res}")
    if 0 not in results:
        raise RuntimeError(f"{world} ranks: exit codes "
                           f"{[p.exitcode for p in procs]}")
    return results[0]


def rank_main(rank, world, store, job, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    result = None
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        from repro_torch.launch.mesh import make_production_mesh

        with open(job, "rb") as f:
            tasks = pickle.load(f)
        meshes, done = {}, {}
        for name, kind, shape, kw in tasks:
            if shape not in meshes:
                meshes[shape] = make_production_mesh(shape=shape,
                                                     device="cpu")
            done[name] = KINDS[kind](meshes[shape], **kw)
        dist.destroy_process_group()
        if rank == 0:
            result = done
    except BaseException:
        result = traceback.format_exc()
    if result is not None:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)


def _model(arch, overrides, params_np):
    import dataclasses

    from repro_torch import get_config
    from repro_torch.models import build_model
    from repro_torch.weights import from_jax_numpy

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return build_model(cfg), from_jax_numpy(params_np, cfg, device="cpu"), cfg


def engine_task(mesh, *, arch, params, requests, kv_bits, overrides=None,
                engine=None):
    from repro_torch.models import layers
    from repro_torch.serving import Request, ServingEngine

    model, p, cfg = _model(arch, overrides, params)
    seen = []
    real = layers.fused_decode

    def counting(q, *a, **kw):
        seen.append(int(q.shape[1]))
        return real(q, *a, **kw)

    layers.fused_decode = counting
    try:
        eng = ServingEngine(model, p, cfg, device="cpu", kv_bits=kv_bits,
                            mesh=mesh, **(engine or {}))
        out = eng.run([Request(rid=rid, prompt=prompt, max_new_tokens=g,
                               arrival=a)
                       for rid, prompt, g, a in requests])
    finally:
        layers.fused_decode = real
    sh = eng.shard
    return {
        "results": {rid: (list(r.tokens), r.admitted_at, r.finished_at,
                          r.status) for rid, r in out.items()},
        "stats": dict(eng.stats),
        "head_local": sh.head_local, "slots_sharded": sh.slots_sharded,
        "col": dict(sh.col), "row": dict(sh.row),
        "embed_sharded": sh.embed_sharded,
        "fused_heads": sorted(set(seen)),
        "cache_shapes": {k: tuple(v.shape) for k, v in eng.pool.cache.items()},
        "param_shapes": _shapes(eng.params),
    }


def _shapes(tree, path=""):
    from repro_torch.quantized.qtensor import QTensor

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, QTensor):
        return {f"{path}/q": tuple(tree.q.shape),
                f"{path}/scale": tuple(tree.scale.shape)}
    return {path: tuple(tree.shape)}


def logits_task(mesh, *, arch, params, tokens, kv_bits, overrides=None):
    import torch

    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.partition import shard_tree
    from repro_torch.sharding.tp import ServeShard, tp_scope

    model, p, cfg = _model(arch, overrides, params)
    toks = torch.as_tensor(tokens, dtype=torch.int64)
    B, T = toks.shape
    with torch.no_grad():
        cache = model.init_cache(B, 16, device="cpu", per_slot=True,
                                 kv_bits=kv_bits)
        single, _ = model.prefill(p, toks, cache)
        shard = ServeShard(mesh, cfg, p, num_slots=B, paged=True,
                           backend="gloo")
        local = shard_tree(p, shard.specs, mesh)
        cache = model.init_cache(B, 16, device="cpu", per_slot=True,
                                 kv_bits=kv_bits, kv_heads=shard.kv_heads)
        with tp_scope(shard):
            got, _ = model.prefill(local, toks, cache)
        if shard.logits_sharded:
            got = coll.all_gather(got, -1, shard.model_group)
    return {"single": single.numpy(), "sharded": got.numpy()}


KINDS = {"engine": engine_task, "logits": logits_task}
