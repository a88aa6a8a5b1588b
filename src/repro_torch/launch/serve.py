"""Serving launcher: build a model, quantize it data-free and serve it with
the continuous-batching engine — on the card unless told otherwise.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --quantize w8a16 \
        --kv-bits 8 --trace 16 --slots 8 --prefill-chunk 32 --warmup

    import repro_torch
    run = repro_torch.serve(repro_torch.ServeConfig(arch="qwen2-0.5b",
                                                    trace=16))

The weights are random (seeded). As in the JAX launcher, they go through
the ``serve-<quantize>-kv8`` recipe (``repro_torch.quantize``): norm
folding, cross-layer equalization, bias absorption, the int8 pack
(per-tensor scales) and the int8 KV cache. ``--load DIR`` serves a saved
``QuantizedModel`` instead (either package's artifact; its KV precision
must be the int8 cache's), as it was saved. The engine takes the fast path
(decode horizons of up to ``--decode-horizon`` steps; CUDA graphs on the
card) unless ``--reference`` asks for the stepwise path; ``--warmup``
captures every graph before the timed loop. ``serve`` returns a
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
from ..models import build_model
from ..pipeline import QuantizedModel, quantize
from ..serving import ServingEngine, required_cache_len, synthetic_trace
from .serve_config import (  # noqa: F401
    KV_BITS,
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
    if config.load:
        qm = QuantizedModel.load(config.load, device=device)
        config, notes = config.with_artifact(ServeConfig.from_artifact(qm))
        for note in notes:
            print(f"note: {note}")
        if qm.kv_bits != KV_BITS:
            raise ServeConfigError(
                f"--load {config.load}: the artifact records a 16-bit KV "
                f"cache (no kv_cache stage with bits=8 in recipe "
                f"{qm.recipe.name!r}); the port serves the int8 KV cache "
                "only — re-quantize with a ('kv_cache', {'bits': 8}) step")
        how = f"loaded from {config.load}"
    else:
        model = build_model(get_config(config.arch, smoke=config.smoke))
        qm = quantize(model, model.init(config.seed, device=device),
                      recipe=f"serve-{config.quantize}-kv8", device=device)
        how = "quantized"
    cfg, model, params = qm.cfg, qm.model, qm.params
    print(f"{how} {cfg.name} with recipe {qm.recipe.name!r} on {device}:")
    for rec in qm.report:
        notes = {k: v for k, v in rec["metrics"].items() if k != "sqnr_db"}
        print(f"  {rec['stage']}: {notes} ({rec['seconds'] * 1e3:.1f} ms)")
    sqnr = qm.site_sqnr_db()
    print("  per-site weight SQNR (dB): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sqnr.items()))

    requests = synthetic_trace(
        config.trace_seed, config.trace, vocab_size=cfg.vocab_size,
        prompt_lens=(config.prompt_min, config.prompt_len),
        gen_lens=(config.gen_min, config.gen_len), mean_interarrival=1.0)
    need = max(required_cache_len(len(r.prompt), r.max_new_tokens,
                                  config.prefill_chunk) for r in requests)
    engine = ServingEngine(model, params, cfg, num_slots=config.slots,
                           max_len=config.max_len or need,
                           prefill_chunk=config.prefill_chunk,
                           decode_horizon=config.decode_horizon,
                           fast=not config.reference, kv_bits=qm.kv_bits,
                           device=device)
    print(f"kv cache: int8 ({engine.pool.bytes_per_slot() / 1e3:.1f} kB/slot, "
          f"{config.slots} slots x {engine.max_len} positions) on {device}")
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
                   report=qm.report, path=path, warmup=warm, busy_share=busy)
    print(f"served {len(results)} requests / {run.generated_tokens} generated "
          f"tokens in {dt * 1e3:.1f} ms ({run.tokens_per_second:.1f} tok/s, "
          f"{path} path)")
    print(f"engine: {engine.stats['decode_steps']} decode steps in "
          f"{engine.stats['decode_dispatches']} dispatches, "
          f"{engine.stats['prefill_chunks']} prefill chunks in "
          f"{engine.stats['prefill_dispatches']} dispatches, "
          f"{engine.syncs_per_token():.2f} host syncs/token, mean slot "
          f"occupancy {engine.mean_occupancy():.2f}")
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
