"""Serving launcher: build a model, quantize it data-free and serve it with
the continuous-batching engine — on the card unless told otherwise.

    python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --quantize w8a16 --trace 16 --slots 8 --prefill-chunk 32 --warmup

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
the fault counters and the results by status. ``serve`` returns a
``ServeRun`` with the results, the engine's stats, the pipeline's stage
report, the wall time of the serving loop and what warmup ran (the JAX
launcher returns the results map alone).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels.dispatch import active_tier
from ..models import build_model
from ..pipeline import QuantizedModel, quantize
from ..runtime import StragglerMonitor
from ..serving import ServingEngine, required_cache_len, synthetic_trace
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

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / max(self.seconds, 1e-9)


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


def serve(config: ServeConfig) -> ServeRun:
    """Build, quantize and serve per ``config``; prints a short report."""
    config = dataclasses.replace(config).validate()
    device = resolve_device(config.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    if config.load:
        qm = QuantizedModel.load(config.load, device=device)
        config, notes = config.with_artifact(ServeConfig.from_artifact(qm))
        for note in notes:
            print(f"note: {note}")
        how = f"loaded from {config.load}"
    else:
        cfg = get_config(config.arch, smoke=config.smoke)
        if config.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=config.layers)
        if config.quantize == "none":
            qm = None
            if config.kv_bits is not None:
                cfg = dataclasses.replace(cfg, kv_cache_bits=config.kv_bits)
            model = build_model(cfg)
            params = model.init(config.seed, device=device)
        else:
            kv8 = "-kv8" if config.kv_bits == 8 else ""
            # quantize draws the weights itself: no reference here keeps
            # the float32 tree alive once the pipeline has replaced it
            qm = quantize(build_model(cfg), None, init_seed=config.seed,
                          device=device,
                          recipe=f"serve-{config.quantize}{kv8}")
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
    else:
        print(f"serving {cfg.name} unquantized ({cfg.param_dtype} weights, "
              f"{cfg.dtype} compute) on {device}")

    requests = synthetic_trace(
        config.trace_seed, config.trace, vocab_size=cfg.vocab_size,
        prompt_lens=(config.prompt_min, config.prompt_len),
        gen_lens=(config.gen_min, config.gen_len), mean_interarrival=1.0)
    if config.deadline is not None:
        requests = [dataclasses.replace(r, deadline=r.arrival + config.deadline)
                    for r in requests]
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
                           straggler=straggler, device=device)
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
    prof = _profiler(device) if config.profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        results = engine.run(requests)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    busy = _report_profile(prof, dt) if config.profile else None
    path = ("stepwise" if config.reference
            else f"fast (decode horizon {config.decode_horizon})")
    run = ServeRun(results=results, stats=dict(engine.stats), seconds=dt,
                   generated_tokens=engine.stats["generated_tokens"],
                   report=[] if qm is None else qm.report, path=path,
                   warmup=warm, busy_share=busy, quantize_seconds=quantize_s,
                   quantize_peak_bytes=quantize_peak, kv_bits=engine.kv_bits,
                   peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
                   pool_bytes=engine.pool.cache_bytes(),
                   view_bytes=engine.view_bytes())
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
