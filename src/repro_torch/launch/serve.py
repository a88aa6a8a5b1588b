"""Serving launcher: build a model, quantize it data-free and serve it with
the continuous-batching engine — on the card unless told otherwise.

    python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --quantize w8a16 --trace 16 --slots 8 --prefill-chunk 32 --warmup
    python -m repro_torch.launch.serve --arch qwen2-0.5b --recipe \
        serve-w8a8 --verbose --save /path/to/artifact
    python -m repro_torch.launch.serve --arch qwen2-0.5b --serve-async \
        --trace 48 --qps 2.0 --timeout 48 --max-queue 4

    import repro_torch
    run = repro_torch.serve(repro_torch.ServeConfig(arch="qwen2-0.5b",
                                                    trace=16))

The weights are random (seeded). As in the JAX launcher, they go through
the ``serve-<quantize>`` recipe (``repro_torch.quantize``: norm folding,
cross-layer equalization, bias absorption, the int8 pack with per-tensor
scales) over the fp KV cache, or with ``--kv-bits 8`` the
``serve-<quantize>-kv8`` recipe and the int8 KV cache; ``--quantize none``
serves the fp32 weights as drawn. ``--load DIR`` serves a saved
``QuantizedModel`` instead (either package's artifact), as it was saved.
The engine takes the fast path (decode horizons of up to
``--decode-horizon`` steps; CUDA graphs on the card) unless
``--reference`` asks for the stepwise path; ``--warmup`` captures every
graph before the timed loop. ``--page-size`` serves from the paged pool
(``--num-pages``, ``--no-prefix-reuse``), ``--deadline T`` gives every
request a deadline T ticks after its arrival, and the report then lists
the fault counters and the results by status. ``--recipe`` quantizes with
any pipeline recipe (an explicit ``--kv-bits`` is folded into the
artifact's config, as the JAX launcher does), ``--save`` persists the
``QuantizedModel`` and ``--verbose`` prints the per-site weight SQNR.
Without ``--trace`` the launcher serves ``--batch`` uniform requests on the
JAX package's calibration ids; ``--max-queue`` bounds the admission queue
(a request it refuses is shed, and the rest are served); SIGTERM drains
(admission closes, in-flight and parked requests finish); and
``--serve-async`` serves the trace open-loop through the async front-end
(``serving.AsyncServer`` behind a circuit breaker and the shedding ladder,
``AsyncClient`` with retry and jittered backoff) and reports the SLO view.
``serve`` returns a ``ServeRun`` with the results, the engine's stats, the
pipeline's stage report, the wall time of the serving loop, what warmup ran
and, on the async path, the SLO summary and the server's counters (the JAX
launcher returns the results map alone).

``--mesh DxM`` (or ``PxDxM``) serves tensor-parallel over a
``torch.distributed`` device mesh, as the JAX launcher does: the recipe's
``-tp`` twin is quantized (``serve-w8a16-tp``, ...), whose shard stage the
artifact records, and ``--save`` records the mesh and every leaf's spec.
``serve`` starts the mesh's ranks itself — one process a mesh position
(``torch.multiprocessing``, spawned, over a file store in a temporary
directory) — unless it already runs inside a process group of that size
(one ``serve`` call a rank, as ``torchrun`` starts them). Every rank builds
and quantizes the same seeded model, places its blocks and runs the same
host loop: the scheduler reads nothing but the trace and the tokens,
which every rank receives whole from the collectives, so every rank
decides the same admissions, chunks, horizons and preemptions. Rank 0
prints and returns the run; the other ranks print nothing. A ``--load``
artifact's recorded mesh is served unless ``--mesh`` names another, or
single-device, with a note, where this host cannot hold it (NCCL: more
ranks than cards). ``--mesh-backend`` picks the process group's backend
(NCCL on the card, gloo on the CPU by default). ``--serve-async`` over a
mesh runs the front-end on rank 0 alone; every other rank replays rank 0's
engine calls, step by step, over a gloo group of their own
(``serving.mesh_control``). A rank that fails exits non-zero, the others
are stopped, and the error names the rank that failed first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data import calibration_tokens
from ..device import resolve_device
from ..kernels.dispatch import active_tier
from ..models import build_model
from ..pipeline import QuantizedModel, quantize
from ..runtime import StragglerMonitor
from ..serving import (
    QueueFull,
    Request,
    ServingEngine,
    count_leaked_pages,
    open_loop_trace,
    required_cache_len,
    synthetic_trace,
)
from .serve_config import (  # noqa: F401
    QUANTIZE_CHOICES,
    ServeConfig,
    ServeConfigError,
    build_parser,
)


@dataclasses.dataclass
class ServeRun:
    results: dict            # {rid: RequestResult}
    stats: dict              # the engine's counters
    seconds: float           # wall time of the serving loop (synchronized)
    generated_tokens: int
    report: list             # the quantization pipeline's stage records
    path: str = ""           # "fast (decode horizon K)" or "stepwise"
    warmup: Optional[dict] = None        # ServingEngine.warmup()'s record
    busy_share: Optional[float] = None   # with --profile, on the card
    quantize_seconds: float = 0.0        # model build + quantize (or load)
    kv_bits: int = 16                    # the served KV cache's precision
    # on the card: peak device memory allocated up to the end of quantize
    # (or load), and from there to the end of the serving loop
    quantize_peak_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    # the KV pool's payload bytes, and (paged) the engine's dense view's
    pool_bytes: int = 0
    view_bytes: int = 0
    # the synchronous path: the rids the bounded queue refused (QueueFull)
    shed: list = dataclasses.field(default_factory=list)
    # the async path (--serve-async): loadgen.summarize's SLO view, the
    # server's admission counters (breaker opens among them) and the
    # clients' outcomes in rid order; None otherwise
    async_summary: Optional[dict] = None
    server_stats: Optional[dict] = None
    outcomes: Optional[list] = None
    # whether SIGTERM drained the serving loop, and (the async front-end)
    # the engine tick at which admission closed
    drained: bool = False
    drained_at: Optional[float] = None
    # the paged pool: pages still referenced after the loop that no live
    # slot maps and no prefix index pins (a refcount leak; must be 0)
    leaked_pages: Optional[int] = None
    # the mesh served over (None: one device), its backend, and the launch
    # counts of each rank's serving loop (rank order; {} on one device)
    mesh: Optional[tuple] = None
    mesh_backend: Optional[str] = None
    rank_launches: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / max(self.seconds, 1e-9)


#: the families the reference's engine refuses: attention-free or hybrid
#: SSMs, and its encoder-decoder (whisper, family "audio")
UNSERVABLE_FAMILIES = ("ssm", "hybrid", "audio")


def _check_servable(cfg, what):
    """The reference launcher's refusal, with its message: the
    continuous-batching engine serves attention-family decoder-only
    models."""
    if cfg.family in UNSERVABLE_FAMILIES:
        raise ServeConfigError(
            f"{what}: the continuous-batching engine serves "
            f"attention-family decoder-only models; quantize "
            f"{cfg.family!r} archs via repro_torch.pipeline.cli and run them "
            f"through model.prefill/decode_step directly"
        )


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _report_profile(prof, wall_s: float, top: int = 12) -> Optional[float]:
    """Device time by kernel name and the device busy share of the loop,
    which it returns (None when the profiler recorded no device time).
    Busy time is the sum of kernel times (kernels on one stream do not
    overlap), so busy share = that sum over the synchronized wall time."""
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("profile: the profiler recorded no device time")
        return None
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} "
          f"ms wall ({busy_us / 1e4 / wall_s:.1f} % busy, "
          f"{100 - busy_us / 1e4 / wall_s:.1f} % idle)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")
    return busy_us / 1e6 / wall_s


def _requests(config: ServeConfig, vocab_size: int) -> list:
    """The workload: ``trace`` synthetic arrivals (open-loop with two
    priority classes under ``serve_async``), else ``batch`` uniform
    requests on the JAX package's calibration ids; each with ``deadline``
    ticks after its arrival."""
    if not config.trace:
        prompts = calibration_tokens(0, config.batch, config.prompt_len,
                                     vocab_size, device="cpu").numpy()
        prompts = prompts.astype(np.int32)
        return [Request(rid=i, prompt=prompts[i],
                        max_new_tokens=config.gen_len,
                        deadline=config.deadline)
                for i in range(config.batch)]
    lens = dict(vocab_size=vocab_size,
                prompt_lens=(config.prompt_min, config.prompt_len),
                gen_lens=(config.gen_min, config.gen_len))
    if config.serve_async:
        # two priority classes so the shedder's lowest-class rung has a
        # victim population (class 1 survives rung 1)
        requests = open_loop_trace(config.trace_seed, config.trace,
                                   config.qps, priority_levels=2, **lens)
    else:
        requests = synthetic_trace(config.trace_seed, config.trace,
                                   mean_interarrival=1.0, **lens)
    if config.deadline is not None:
        requests = [dataclasses.replace(r, deadline=r.arrival + config.deadline)
                    for r in requests]
    return requests


def _serve_async(config: ServeConfig, engine: ServingEngine, requests,
                 sigterm: list, drained_at: list, *, at_step: bool = False,
                 drain_file: Optional[str] = None):
    """The trace through the async front-end, open-loop: returns
    (summary, server stats). SIGTERM drains the server and ``drained_at``
    gets the tick. ``at_step``: the drain waits for the next step boundary
    (a mesh's ranks replay it there); ``drain_file``: no handler, the
    drain comes when that file appears (the launcher writes it on its
    SIGTERM)."""
    import asyncio

    from ..serving import (
        SLO,
        AsyncClient,
        AsyncServer,
        CircuitBreaker,
        RetryPolicy,
        ShedPolicy,
        run_open_loop,
        summarize,
    )

    sp = config.shed_pressure
    server = AsyncServer(
        engine, breaker=CircuitBreaker(cooldown=config.breaker_cooldown),
        shed=ShedPolicy(shed_pressure=sp, tighten_pressure=min(1.0, 1.5 * sp),
                        refuse_pressure=min(1.0, 2.0 * sp)))
    client = AsyncClient(
        server, RetryPolicy(max_attempts=config.retry_attempts),
        seed=config.trace_seed)

    def drain():
        if not engine.draining:
            drained_at.append(engine.clock)
            server.drain()

    def at_boundary(_):
        if drain_file and not sigterm and os.path.exists(drain_file):
            sigterm.append(1)
        if sigterm:
            drain()

    if at_step:
        server.pre_step.append(at_boundary)
    handler = ((lambda *_: sigterm.append(1)) if at_step
               else (lambda *_: (sigterm.append(1), drain())))
    prev = (signal.signal(signal.SIGTERM, handler) if drain_file is None
            else None)
    try:
        outcomes = asyncio.run(run_open_loop(server, client, requests,
                                             timeout=config.timeout))
    finally:
        if drain_file is None:
            signal.signal(signal.SIGTERM, prev)
    stats = {k: (dict(v) if k == "results" else v)
             for k, v in server.stats.items()}
    stats["breaker_opens"] = server.breaker.opens
    return summarize(outcomes, slo=SLO()), stats, outcomes


def _serve_async_mesh(config: ServeConfig, engine: ServingEngine, requests,
                      sigterm: list, drained_at: list, rank0: bool,
                      drain_file: Optional[str]):
    """``_serve_async`` over a mesh (``serving.mesh_control``): rank 0 runs
    the front-end and leads, each other rank replays its engine calls over
    a gloo group of their own; returns rank 0's (summary, server stats,
    outcomes), (None, None, None) on the others. A SIGTERM to rank 0 (or,
    spawned by the launcher, its ``drain_file``) drains it at the next
    step boundary, the drain reaching the others with that step's batch;
    the others ignore SIGTERM."""
    from ..serving.mesh_control import Leader, control_group, follow

    group = control_group()
    if not rank0:
        prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
        try:
            follow(engine, group)
        finally:
            signal.signal(signal.SIGTERM, prev)
        return None, None, None
    leader = Leader(engine, group)
    try:
        out = _serve_async(config, engine, requests, sigterm, drained_at,
                           at_step=True, drain_file=drain_file)
    except BaseException as e:
        leader.close(e)
        raise
    leader.close()
    return out


def _report_async(summary: dict, stats: dict) -> None:
    """The JAX launcher's SLO, admission and breaker lines."""
    from ..serving import SLO

    slo = SLO()
    print(f"async front-end: offered {summary['offered_qps']:.3f} "
          f"req/tick, goodput {summary['goodput_qps']:.3f} req/tick "
          f"({summary['goodput_fraction']:.0%} of offered; SLO: ttft <= "
          f"{slo.ttft:g}, per-token <= {slo.per_token:g} ticks)")
    print(f"  ttft p50/p99 {summary['ttft_p50']:.1f}/"
          f"{summary['ttft_p99']:.1f} ticks, per-token p50/p99 "
          f"{summary['per_token_p50']:.2f}/"
          f"{summary['per_token_p99']:.2f} ticks, "
          f"mean attempts {summary['mean_attempts']:.2f}")
    print("  admission: " + ", ".join(
        f"{k}={stats[k]}" for k in
        ("submitted", "accepted", "shed_breaker", "shed_priority",
         "shed_refused", "shed_queue", "deadlines_tightened"))
        + f"; breaker opens={stats['breaker_opens']}")


def _quantize(config: ServeConfig, device):
    """Build the config's model and quantize it (``None`` for
    ``--quantize none`` without ``--recipe``); returns (qm, cfg, model,
    params)."""
    cfg = get_config(config.arch, smoke=config.smoke)
    _check_servable(cfg, f"--arch {config.arch}")
    if config.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=config.layers)
    if not config.recipe and config.quantize == "none":
        if config.kv_bits is not None:
            cfg = dataclasses.replace(cfg, kv_cache_bits=config.kv_bits)
        model = build_model(cfg)
        return None, cfg, model, model.init(config.seed, device=device)
    recipe = config.recipe
    if recipe is None:
        from ..pipeline.recipes import BUILTIN_RECIPES

        recipe = (f"serve-{config.quantize}-kv8" if config.kv_bits == 8
                  else f"serve-{config.quantize}")
        # --mesh prefers the recipe's -tp twin (its shard stage records the
        # plan on the artifact); the engine serves any recipe sharded
        if config.mesh and f"{recipe}-tp" in BUILTIN_RECIPES:
            recipe = f"{recipe}-tp"
    # quantize draws the weights itself: no reference here keeps the
    # float32 tree alive once the pipeline has replaced it
    qm = quantize(build_model(cfg), None, init_seed=config.seed,
                  device=device, recipe=recipe)
    if config.kv_bits is not None and qm.cfg.kv_cache_bits != config.kv_bits:
        # an explicit --recipe may not carry a kv_cache stage: fold the
        # requested KV precision into the artifact so that a --save /
        # --load round trip serves the cache of this run
        qm.cfg = dataclasses.replace(qm.cfg, kv_cache_bits=config.kv_bits)
        qm.model = build_model(qm.cfg)
    return qm, qm.cfg, qm.model, qm.params


def _mesh_shape(config: ServeConfig):
    """(the mesh to serve over or None, where it came from): ``--mesh``, else
    a ``--load`` artifact's recorded mesh — unless this host cannot hold
    it, which is noted and served single-device."""
    if config.mesh is not None:
        return config.mesh, "--mesh"
    if not config.load:
        return None, None
    from ..pipeline.artifact import read_sharding
    from .mesh import check_fits, mesh_backend

    rec = read_sharding(config.load)
    if not (rec.get("mode") and rec.get("mesh_shape")):
        return None, None
    shape = tuple(rec["mesh_shape"])
    try:
        check_fits(shape, config.device,
                   mesh_backend(config.device, config.mesh_backend))
    except ValueError as e:
        print(f"note: artifact-recorded mesh {'x'.join(map(str, shape))}: "
              f"{e} — serving single-device")
        return None, None
    return shape, "artifact-recorded mesh"


def serve(config: ServeConfig) -> ServeRun:
    """Build, quantize and serve per ``config``; prints a short report.
    With a mesh (``--mesh``, or a ``--load`` artifact's), the run is the
    mesh's ranks' (see the module docstring): rank 0's ``ServeRun``."""
    config = dataclasses.replace(config).validate()
    shape, source = _mesh_shape(config)
    if shape is None:
        return _serve(config, None)
    import math

    import torch.distributed as dist

    config = dataclasses.replace(config, mesh=shape)
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return _serve_rank(config, source)
    return _spawn_ranks(config, source)


def _serve_rank(config: ServeConfig, source: str,
                drain_file: Optional[str] = None) -> ServeRun:
    """This process's rank of the mesh: build the mesh over the running
    process group, serve, and report the run (rank 0 prints);
    ``drain_file``: the launcher's SIGTERM (``_serve_async``)."""
    import torch.distributed as dist

    from ..kernels import launch_counts
    from .mesh import make_production_mesh, mesh_backend

    device = resolve_device(config.device)
    backend = mesh_backend(device, config.mesh_backend)
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mesh = make_production_mesh(shape=config.mesh, device=device,
                                backend=backend)
    with contextlib.ExitStack() as quiet:
        if dist.get_rank():
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        print(f"mesh ({source}): " + ", ".join(
            f"{a}={n}" for a, n in zip(mesh.mesh_dim_names, mesh.shape))
            + f" over {backend} on {device}")
        run = _serve(config, mesh, drain_file)
    run.mesh, run.mesh_backend = tuple(config.mesh), backend
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, launch_counts())
    run.rank_launches = counts
    return run


def _rank_main(rank: int, world: int, store: str, config: ServeConfig,
               source: str, out: str) -> None:
    """A spawned rank: join the process group, serve, and (rank 0) write
    the run to ``out``; a rank that fails writes its exception there.
    Under ``--serve-async`` every rank ignores SIGTERM (a signal could
    interrupt a collective): the launcher turns its own into
    ``<out>.drain``, which rank 0 reads at each step boundary."""
    import torch.distributed as dist

    from .mesh import mesh_backend

    if config.serve_async:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)

    backend = mesh_backend(config.device, config.mesh_backend)
    if torch.device(config.device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    result = None
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            run = _serve_rank(config, source, f"{out}.drain")
        finally:
            dist.destroy_process_group()
        if rank == 0:
            result = run
    except BaseException as e:               # reported to the parent
        result = (e, traceback.format_exc())
    sys.stdout.flush()
    if result is not None:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)
    if isinstance(result, tuple):
        # a non-zero exit: the parent stops the other ranks at once
        sys.exit(1)


def _spawn_ranks(config: ServeConfig, source: str) -> ServeRun:
    """Start the mesh's ranks (spawned processes over a file store), wait
    for them, and return rank 0's run; a rank's failure is raised here.
    Under ``--serve-async`` a SIGTERM to this process writes the drain
    file rank 0 reads at its step boundaries: the mesh drains."""
    import math

    import torch.multiprocessing as mp

    world = math.prod(config.mesh)
    tmp = tempfile.mkdtemp(prefix="repro_serve_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   config, source, os.path.join(tmp, "run")))
                 for r in range(world)]
        sys.stdout.flush()
        for p in procs:
            p.start()
        drain_file = os.path.join(tmp, "run.drain")
        prev = (signal.signal(signal.SIGTERM,
                              lambda *_: open(drain_file, "w").close())
                if config.serve_async else None)
        # a rank that fails exits non-zero and leaves the others waiting
        # in a collective: stop them, and report the rank that failed
        # first
        first = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    first = bad[0] if first is None else first
                    for p in procs:
                        p.kill()
                time.sleep(0.05)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
        results = {}
        for r in range(world):
            path = os.path.join(tmp, f"run.{r}")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results[r] = pickle.load(f)
        failed = sorted((r != first, r) for r, res in results.items()
                        if isinstance(res, tuple))
        for _, r in failed:
            err, tb = results[r]
            if isinstance(err, ServeConfigError):
                raise err
            raise RuntimeError(f"mesh rank {r} failed:\n{tb}")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad or 0 not in results:
            raise RuntimeError(f"mesh ranks {bad} exited with codes "
                               f"{[procs[r].exitcode for r in bad]}")
        return results[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _serve(config: ServeConfig, mesh,
           drain_file: Optional[str] = None) -> ServeRun:
    """Build, quantize and serve per ``config``, sharded over ``mesh``
    (a ``DeviceMesh``) where given; ``drain_file``: a spawned rank's
    SIGTERM, written by the launcher (``_serve_async``)."""
    device = resolve_device(config.device)
    rank0 = mesh is None or mesh.get_rank() == 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    if config.load:
        qm = QuantizedModel.load(config.load, device=device)
        _check_servable(qm.cfg, f"--load {config.load} (arch {qm.cfg.name})")
        config, notes = config.with_artifact(ServeConfig.from_artifact(qm))
        for note in notes:
            print(f"note: {note}")
        how = f"loaded from {config.load}"
    else:
        qm, cfg, model, params = _quantize(config, device)
        how = "quantized"
    quantize_peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        quantize_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    quantize_s = time.perf_counter() - t_start
    if qm is not None:
        cfg, model, params = qm.cfg, qm.model, qm.params
        peak = ("" if quantize_peak is None else
                f", peak device memory {quantize_peak / 2**30:.2f} GiB")
        print(f"{how} {cfg.name} ({cfg.n_layers} layers) with recipe "
              f"{qm.recipe.name!r} on {device} in {quantize_s:.1f} s{peak}:")
        for rec in qm.report:
            notes = {k: v for k, v in rec["metrics"].items()
                     if k != "sqnr_db"}
            print(f"  {rec['stage']}: {notes} ({rec['seconds'] * 1e3:.1f} ms)")
        sqnr = qm.site_sqnr_db()
        print("  per-site weight SQNR (dB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sqnr.items()))
        if config.verbose:
            from ..pipeline.cli import print_site_sqnr

            print_site_sqnr(qm)
        if config.save and rank0:
            qm.save(config.save, mesh=mesh)
            print(f"saved QuantizedModel to {config.save}"
                  + (" (serve-mode specs recorded)"
                     if mesh is not None and qm.shard_mode else ""))
    else:
        print(f"serving {cfg.name} unquantized ({cfg.param_dtype} weights, "
              f"{cfg.dtype} compute) on {device}")

    requests = _requests(config, cfg.vocab_size)
    if config.trace:
        rate = f" at {config.qps:g} req/tick" if config.serve_async else ""
        print(f"trace: {len(requests)} requests, prompt {config.prompt_min}.."
              f"{config.prompt_len}, gen {config.gen_min}..{config.gen_len}, "
              f"Poisson arrivals{rate}")
    need = max(required_cache_len(len(r.prompt), r.max_new_tokens,
                                  config.prefill_chunk) for r in requests)
    straggler = (None if config.straggler_threshold is None
                 else StragglerMonitor(threshold=config.straggler_threshold))
    engine = ServingEngine(model, params, cfg, num_slots=config.slots,
                           max_len=config.max_len or need,
                           prefill_chunk=config.prefill_chunk,
                           decode_horizon=config.decode_horizon,
                           fast=not config.reference,
                           kv_bits=config.kv_bits,
                           page_size=config.page_size,
                           num_pages=config.num_pages,
                           prefix_reuse=config.prefix_reuse,
                           max_queue=config.max_queue,
                           straggler=straggler, device=device, mesh=mesh)
    layout = (f"paged ({engine.pool.num_pages} pages x {engine.page_size} "
              f"positions, prefix reuse "
              f"{'on' if engine.prefix_index is not None else 'off'})"
              if engine.paged
              else f"{config.slots} slots x {engine.max_len} positions")
    print(f"kv cache: {'int8' if engine.kv_bits == 8 else 'fp'} "
          f"({engine.pool.bytes_per_slot() / 1e3:.1f} kB/slot, {layout}) "
          f"on {device}")
    tier = active_tier(torch.empty(0, device=device))
    print(f"kernel tier: {tier} (" + ("the hand-written CUDA kernels"
          if tier == "cuda" else "the plain PyTorch versions") + ")")
    warm = engine.warmup() if config.warmup else None
    if warm is not None and "graphs" in warm:
        print(f"warmup: captured {warm['graphs']} CUDA graphs in "
              f"{warm['seconds']:.1f} s (capture {warm['capture_seconds']:.1f}"
              f" s, graph pool {warm['graph_pool_bytes'] / 2**20:.1f} MiB)")
    elif warm is not None:
        print(f"warmup: ran the serving shapes in {warm['seconds']:.1f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # SIGTERM → graceful drain: stop admitting, finish in-flight and parked
    # requests, report (the JAX launcher's contract)
    sigterm: list = []
    drained_at: list = []
    summary = server_stats = outcomes = None
    shed: list = []
    prof = _profiler(device) if config.profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        if config.serve_async and mesh is not None:
            summary, server_stats, outcomes = _serve_async_mesh(
                config, engine, requests, sigterm, drained_at, rank0,
                drain_file)
            results = engine.results
        elif config.serve_async:
            summary, server_stats, outcomes = _serve_async(
                config, engine, requests, sigterm, drained_at)
            results = engine.results
        else:
            prev = signal.signal(
                signal.SIGTERM,
                lambda *_: (sigterm.append(1), engine.request_drain()))
            try:
                for r in requests:
                    try:
                        engine.submit(r)
                    except QueueFull:
                        shed.append(r.rid)
                results = engine.run()
            finally:
                signal.signal(signal.SIGTERM, prev)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    busy = _report_profile(prof, dt) if config.profile else None
    if summary is not None:
        _report_async(summary, server_stats)
    if sigterm:
        print(f"drain: SIGTERM received — admission stopped, "
              f"{engine.scheduler.pending()} queued requests unserved")
    path = ("stepwise" if config.reference
            else f"fast (decode horizon {config.decode_horizon})")
    if mesh is not None:
        path += (f", sharded {config.mesh_str} over "
                 f"{engine.shard.backend}"
                 + ("" if engine.graphs is not None or config.reference
                    else f"; no CUDA graphs: {engine.stats['graphs_off']}"
                    if device.type == "cuda" else ""))
    run = ServeRun(results=results, stats=dict(engine.stats), seconds=dt,
                   generated_tokens=engine.stats["generated_tokens"],
                   report=[] if qm is None else qm.report, path=path,
                   warmup=warm, busy_share=busy, quantize_seconds=quantize_s,
                   quantize_peak_bytes=quantize_peak, kv_bits=engine.kv_bits,
                   peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
                   pool_bytes=engine.pool.cache_bytes(),
                   view_bytes=engine.view_bytes(), shed=shed,
                   async_summary=summary, server_stats=server_stats,
                   outcomes=outcomes, drained=bool(sigterm),
                   drained_at=drained_at[0] if drained_at else None,
                   leaked_pages=(count_leaked_pages(engine) if engine.paged
                                 else None))
    print(f"served {len(results)} requests / {run.generated_tokens} generated "
          f"tokens in {dt * 1e3:.1f} ms ({run.tokens_per_second:.1f} tok/s, "
          f"{path} path)")
    print(f"engine: {engine.stats['decode_steps']} decode steps in "
          f"{engine.stats['decode_dispatches']} dispatches, "
          f"{engine.stats['prefill_chunks']} prefill chunks in "
          f"{engine.stats['prefill_dispatches']} dispatches, "
          f"{engine.syncs_per_token():.2f} host syncs/token, mean slot "
          f"occupancy {engine.mean_occupancy():.2f}")
    faults = {k: engine.stats[k] for k in
              ("shed", "preempted", "resumed", "cancelled", "expired",
               "quarantined", "straggler_steps")}
    by_status: dict = {}
    for res in results.values():
        by_status[res.status] = by_status.get(res.status, 0) + 1
    if any(faults.values()) or set(by_status) - {"ok"}:
        print("faults: " + ", ".join(f"{k}={v}" for k, v in faults.items())
              + f" (straggler threshold "
                f"{engine.stats['straggler_threshold']:g}x step EMA)")
        print("results by status: " +
              ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
    if results:
        first = results[min(results)]
        print(f"sample token ids (rid {first.rid}):", first.tokens[:12])
    return run


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        return serve(ServeConfig.from_args(args))
    except ServeConfigError as e:
        ap.error(str(e))


if __name__ == "__main__":
    main()
