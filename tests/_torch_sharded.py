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
    params;
  * ``moe_block`` — one MoE block (layer 0) on given activations under the
    shard (this rank's rows where the slots shard over "data"), its
    output, router logits and drops gathered over the data axis, beside
    the single-device block on every row;
  * ``refuse`` — the planner's spec of the MoE router and whether
    ``ServeShard`` refuses to serve it cut;
  * ``gate`` — chip_smoke.py's MoE-block gate on layer 0, as it is and
    with a planted fault (the partial sums over "model" not added);
  * ``counts`` — a sharded engine's run with every kernel op's calls
    counted by the name its CUDA wrapper counts launches by;
  * ``async`` — the async front-end over a sharded engine
    (``serving.mesh_control``: rank 0 leads, the others follow) on one of
    ``async_run``'s scenarios; ``fail_at`` makes every follower raise at
    that replayed step, ``fail_leader`` rank 0 after one step.

A rank that fails exits non-zero and ``run_ranks`` then stops the others,
as the launcher does (``stop_on_failure=False``: it waits for each to end). ``run_ranks(..., collect=True)`` returns the result of
every rank that wrote one (a failed rank's traceback as a string) instead
of raising.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback


def run_ranks(world, tasks, tmp_path, timeout: float = 600.0,
              collect: bool = False, stop_on_failure: bool = True) -> dict:
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
    # as the launcher: a rank that exits non-zero (it failed) stops the
    # others, which may be waiting for it in a collective
    end = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < end:
        if stop_on_failure and any(p.exitcode not in (None, 0)
                                   for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    results = {}
    for r in range(world):
        path = f"{out}.{r}"
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[r] = pickle.load(f)
    if collect:
        return results
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
    if isinstance(result, str):
        # a failed rank exits at once, its process group unfinished: its
        # peers' next collective sees the connection close (the launcher's
        # ranks do the same)
        os._exit(1)


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


def moe_block_task(mesh, *, arch, params, x, overrides=None):
    import torch

    from repro_torch.models import layers
    from repro_torch.models.lm import _layer
    from repro_torch.sharding.partition import shard_tree
    from repro_torch.sharding.tp import ServeShard, tp_scope

    model, p, cfg = _model(arch, overrides, params)
    xs = torch.as_tensor(x)
    B = xs.shape[0]
    with torch.no_grad():
        mlp = _layer(p["blocks"], 0)["mlp"]
        drops = []
        y1, aux1 = layers.moe_block(mlp, xs, cfg, drops=drops)
        single = {"y": y1.numpy(), "aux": float(aux1),
                  "drops": drops[0].numpy(),
                  "logits": layers.router_logits(mlp, xs).numpy()}
        shard = ServeShard(mesh, cfg, p, num_slots=B, paged=False,
                           backend="gloo")
        local = _layer(shard_tree(p, shard.specs, mesh)["blocks"], 0)["mlp"]
        rows = xs[shard.slot_lo:shard.slot_hi]
        drops = []
        with tp_scope(shard):
            y2, aux2 = layers.moe_block(local, rows, cfg, drops=drops)
            logits = layers.router_logits(local, rows)
        got = {"y": y2, "drops": drops[0], "logits": logits}
        if shard.slots_sharded:
            got = {k: shard.gather_slots(v.contiguous())
                   for k, v in got.items()}
        got = {k: v.numpy() for k, v in got.items()}
        got["aux"] = float(aux2)
    return {"single": single, "sharded": got,
            "slots_sharded": shard.slots_sharded}


def refuse_task(mesh, *, arch, params, overrides=None):
    """The planner's serve-mode spec of the MoE router, and what
    ``ServeShard`` says to it (None: it serves)."""
    from repro_torch.sharding.partition import params_pspecs, spec_paths
    from repro_torch.sharding.tp import ServeShard

    _, p, cfg = _model(arch, overrides, params)
    flat = dict(spec_paths(params_pspecs(
        p, mesh, {"n_q": cfg.n_heads, "n_kv": cfg.n_kv_heads}, mode="serve")))
    try:
        ServeShard(mesh, cfg, p, num_slots=4, paged=False, backend="gloo")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return {"router_spec": str(flat.get("/blocks/mlp/router/q",
                                        flat.get("/blocks/mlp/router"))),
            "refused": refused}


def gate_task(mesh, *, arch, params, x, chip_smoke, overrides=None):
    """chip_smoke.py's MoE-block gate (``moe_block_gap``) on layer 0 under
    the shard, as it is and with a planted fault — the partial sums over
    "model" (float32 and int32) not added, each rank keeping its own —:
    (gate reading, faulty reading)."""
    import importlib.util

    import torch

    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.partition import shard_tree
    from repro_torch.sharding.tp import ServeShard

    spec = importlib.util.spec_from_file_location("chip_smoke", chip_smoke)
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    _, p, cfg = _model(arch, overrides, params)
    xs = torch.as_tensor(x)
    shard = ServeShard(mesh, cfg, p, num_slots=xs.shape[0], paged=False,
                       backend="gloo")
    local = shard_tree(p, shard.specs, mesh)
    honest = chip.moe_block_gap(torch, cfg, p, local, xs, shard)
    real = coll.all_reduce_sum

    def dropped(t, group):
        if group is shard.model_group and t.dtype in (torch.float32,
                                                      torch.int32):
            return t
        return real(t, group)

    coll.all_reduce_sum = dropped
    try:
        faulty = chip.moe_block_gap(torch, cfg, p, local, xs, shard)
    finally:
        coll.all_reduce_sum = real
    return {"honest": honest, "faulty": faulty, "tol": chip.MOE_BLOCK_TOL}


def async_run(serving, engine, scenario, vocab_size):
    """One of the front-end's seeded open-loop scenarios over ``engine``
    through ``serving`` (the port's ``repro_torch.serving`` or the JAX
    package's ``repro.serving``), as ``test_torch_serving_async``'s overload
    run: ``underload`` (8 requests at 0.25 a tick), ``overload`` (12 at 1.5
    a tick against the caller's queue bound: retries, shedding, a breaker
    that opens) and ``drain`` (12 at 0.1 a tick, the server drained at its
    first step from the 12th on with an empty queue: later arrivals are
    refused until their retries run out — a request still queued at a
    drain would wait for ever, in both packages). Returns (per-rid outcome
    tuples, admission stats, breaker opens, terminal statuses)."""
    import asyncio

    qps, n = {"underload": (0.25, 8), "overload": (1.5, 12),
              "drain": (0.1, 12)}[scenario]
    trace = serving.open_loop_trace(7, n, qps, vocab_size=vocab_size,
                                    prompt_lens=(4, 12), gen_lens=(4, 12),
                                    priority_levels=2)
    server = serving.AsyncServer(
        engine, breaker=serving.CircuitBreaker(window=8, failure_threshold=0.5,
                                               min_volume=4, cooldown=8.0))
    if scenario == "drain":
        def drain(step):
            if (step >= 12 and not engine.draining
                    and not engine.scheduler.pending()):
                server.drain()

        server.pre_step.append(drain)
    client = serving.AsyncClient(server, serving.RetryPolicy(max_attempts=3),
                                 seed=2)
    outcomes = asyncio.run(serving.run_open_loop(server, client, trace))
    stats = {k: v for k, v in server.stats.items() if k != "results"}
    return ([(o.rid, o.status, o.attempts, tuple(o.tokens),
              tuple(o.token_ticks), o.first_token_tick, o.finished_tick)
             for o in outcomes], stats, server.breaker.opens,
            dict(server.stats["results"]))


def async_task(mesh, *, arch, params, kv_bits, scenario, engine,
               overrides=None, fail_at=None, fail_leader=False, timeout=None):
    import torch.distributed as dist

    from repro_torch import serving
    from repro_torch.serving import mesh_control

    model, p, cfg = _model(arch, overrides, params)
    eng = serving.ServingEngine(model, p, cfg, device="cpu", kv_bits=kv_bits,
                                mesh=mesh, **engine)
    group = (mesh_control.control_group() if timeout is None
             else mesh_control.control_group(timeout))
    if dist.get_rank() != 0:
        if fail_at is not None:
            real, calls = eng.step, []

            def step():
                calls.append(1)
                if len(calls) == fail_at:
                    raise RuntimeError(f"follower failed at step {fail_at}")
                real()

            eng.step = step
        return {"steps": mesh_control.follow(eng, group)}
    leader = mesh_control.Leader(eng, group)
    try:
        if fail_leader:
            eng.step()
            raise RuntimeError("leader failed")
        out = async_run(serving, eng, scenario, cfg.vocab_size)
    except BaseException as e:
        leader.close(e)
        raise
    leader.close()
    return {"run": out, "batches": leader.batches,
            "graphs_off": eng.stats["graphs_off"]}


def counts_task(mesh, *, arch, params, requests, kv_bits, overrides=None,
                engine=None):
    """A sharded engine's run with every kernel op's calls counted under
    the name its CUDA wrapper counts a launch by (the plain versions run
    here): {name: calls}, the shard's flags and the engine's stats."""
    import collections

    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.qmatmul_w8a8 import ops as w8a8_ops
    from repro_torch.kernels.qmatmul_w8a16 import ops as w8a16_ops
    from repro_torch.kernels.quantize_act import ops as qa_ops
    from repro_torch.serving import Request, ServingEngine

    counts = collections.Counter()
    mods = (fd_ops, w8a8_ops, w8a16_ops, qa_ops)
    real = {m: m.resolve for m in mods}

    def counting(resolve):
        def wrapped(op, t, backend=None):
            fn = resolve(op, t, backend)

            def call(*a, **kw):
                experts = op == "qmatmul_w8a8_i32" and a[0].ndim == 3
                counts[op + ("_experts" if experts else "")] += 1
                return fn(*a, **kw)
            return call
        return wrapped

    model, p, cfg = _model(arch, overrides, params)
    for m in mods:
        m.resolve = counting(real[m])
    try:
        eng = ServingEngine(model, p, cfg, device="cpu", kv_bits=kv_bits,
                            mesh=mesh, **(engine or {}))
        eng.run([Request(rid=rid, prompt=prompt, max_new_tokens=g, arrival=a)
                 for rid, prompt, g, a in requests])
    finally:
        for m in mods:
            m.resolve = real[m]
    sh = eng.shard
    return {"counts": dict(counts), "stats": dict(eng.stats),
            "flags": {"col": dict(sh.col), "row": dict(sh.row),
                      "head_local": sh.head_local,
                      "slots_sharded": sh.slots_sharded}}


KINDS = {"engine": engine_task, "logits": logits_task,
         "moe_block": moe_block_task, "async": async_task,
         "counts": counts_task, "refuse": refuse_task, "gate": gate_task}
