"""Serving launcher: build a model, quantize it data-free and serve it with
the continuous-batching engine — on the card unless told otherwise.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --quantize w8a16 \
        --kv-bits 8 --trace 16 --slots 8 --prefill-chunk 32

    import repro_torch
    run = repro_torch.serve(repro_torch.ServeConfig(arch="qwen2-0.5b",
                                                    trace=16))

The weights are random (seeded). As in the JAX launcher, they go through
the ``serve-<quantize>-kv8`` recipe (``repro_torch.quantize``): norm
folding, cross-layer equalization, bias absorption, the int8 pack
(per-tensor scales) and the int8 KV cache. ``serve`` returns a ``ServeRun``
with the results, the engine's stats, the pipeline's stage report and the
wall time of the serving loop (the JAX launcher returns the results map
alone).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..pipeline import quantize
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

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / max(self.seconds, 1e-9)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _report_profile(prof, wall_s: float, top: int = 12) -> None:
    """Device time by kernel name and the device busy share of the loop.
    Busy time is the sum of kernel times (kernels on one stream do not
    overlap), so busy share = that sum over the synchronized wall time."""
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} "
          f"ms wall ({busy_us / 1e4 / wall_s:.1f} % busy, "
          f"{100 - busy_us / 1e4 / wall_s:.1f} % idle)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")


def serve(config: ServeConfig) -> ServeRun:
    """Build, quantize and serve per ``config``; prints a short report."""
    config = dataclasses.replace(config).validate()
    device = resolve_device(config.device)
    cfg = get_config(config.arch, smoke=config.smoke)
    model = build_model(cfg)
    params = model.init(config.seed, device=device)
    qm = quantize(model, params, recipe=f"serve-{config.quantize}-kv8",
                  device=device)
    params = qm.params
    print(f"quantized {cfg.name} with recipe {qm.recipe.name!r} on {device}:")
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
                           kv_bits=qm.kv_bits, device=device)
    print(f"kv cache: int8 ({engine.pool.bytes_per_slot() / 1e3:.1f} kB/slot, "
          f"{config.slots} slots x {engine.max_len} positions) on {device}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof = _profiler(device) if config.profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        results = engine.run(requests)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    if config.profile:
        _report_profile(prof, dt)
    run = ServeRun(results=results, stats=dict(engine.stats), seconds=dt,
                   generated_tokens=engine.stats["generated_tokens"],
                   report=qm.report)
    print(f"served {len(results)} requests / {run.generated_tokens} generated "
          f"tokens in {dt * 1e3:.1f} ms ({run.tokens_per_second:.1f} tok/s, "
          f"stepwise path)")
    print(f"engine: {engine.stats['decode_steps']} decode steps, "
          f"{engine.stats['prefill_chunks']} prefill chunks, "
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
