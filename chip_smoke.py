#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing here catches a failure):

  1. build  — compile every CUDA kernel from ``src/repro_torch/csrc`` (one
     nvcc per source, in parallel) and print the build time, the
     registers/spills ptxas reports, and the card's name and power limit.
  2. kernels — call each kernel's wrapper on the card at the shapes the
     serving path gives it and hold it against its plain PyTorch version on
     the same inputs: quantize_act and qmatmul_w8a8 bit-equal, fused_decode's
     appended cache bit-equal, its output within ``OUT_TOL``, and its
     quantize-out bit-equal to quantize_act of that output and off the
     plain version's only at rounding ties.
     Times each kernel (device time, queued behind a sleep kernel so the
     host's per-call cost is hidden, and the time of a back-to-back wrapper
     call, host included), its plain version and, where one exists, the one
     PyTorch call computing the same function, all with CUDA events.
  3. reference — a smoke-size qwen2 on the card against the same model on
     the CPU (plain versions): teacher-forced logits within tolerance.
  4. serve — ``repro_torch.serve``: qwen2-0.5b at full width (24 layers,
     seeded random weights packed to int8 by the pack stage alone — no norm
     folding, CLE or bias absorption), the stepwise engine with 8 slots,
     max_len 512, prefill chunks of 32, 16 requests of 32-256 prompt tokens
     and 32 new tokens each. Every request must finish with finite logits,
     and every kernel's launch count (reset just before) must be above 0.

The line before the last is the kernel table as one JSON object; the last
line is the device record. Exits non-zero with no result when torch sees no
CUDA device, or when the port's sources are not beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor-core
# operations/s, float32 (CUDA-core) operations/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12

# fused_decode's ``out`` against its plain version (expf and the order of the
# sums differ, so the float32 results are ~1e-7 apart): float32 within
# atol 1e-6 + rtol 1e-5; bfloat16 within one bf16 ulp of the reference value,
# since two float32 values that close can round to neighbouring bf16 values.
OUT_TOL = {"float32": "atol 1e-6 + rtol 1e-5", "bfloat16": "1 bf16 ulp"}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one back-to-back call of ``fn`` in ms, between CUDA
    events: the Python wrapper's host time included, which is what a caller
    pays when the card runs faster than the host enqueues."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms. The card is first held
    busy by ``torch.cuda._sleep`` while the host enqueues all ``iters``
    calls, so the CUDA events around them time the calls back to back on
    the device, without the host's per-call cost. The sleep is doubled until
    it outlasts the enqueue."""
    import time

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        sleep_ms = _sleep_ms(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < sleep_ms:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("the host could not enqueue ahead of the card")


_SLEEP_MS: dict = {}


def _sleep_ms(cycles: int) -> float:
    """How long ``torch.cuda._sleep(cycles)`` holds the card, in ms."""
    import torch

    if cycles not in _SLEEP_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_MS[cycles] = start.elapsed_time(end)
    return _SLEEP_MS[cycles]


def bound_ms(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2
def check_quantize_act(torch, dev, gen):
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    rows = []
    for M, K in ((8, 896), (8, 4864), (64, 896), (256, 896), (256, 4864)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(dtype)
            x[0, :7] = torch.tensor([0.5, 1.5, -2.5, 0, 0, 0, 0])  # ties
            q, s = quantize_act_cuda(x)
            qr, sr = quantize_act_ref(x)
            torch.cuda.synchronize()
            assert torch.equal(q, qr) and torch.equal(s, sr), (
                f"quantize_act {M}x{K} {dtype}: not bit-equal to the plain "
                f"version ({int((q != qr).sum())} payload mismatches)")
            e = x.element_size()
            b, by = bound_ms(M * K * e + M * K + 4 * M, 5 * M * K, F32_OPS_S)
            rows.append({
                "shape": f"x[{M},{K}] {str(dtype)[6:]}", "max_abs_err": 0.0,
                "ms": device_ms(lambda: quantize_act_cuda(x), 100),
                "call_ms": call_ms(lambda: quantize_act_cuda(x), 100),
                "plain_ms": device_ms(lambda: quantize_act_ref(x), 20),
                "bound_ms": b, "bound_by": by, "library_ms": None})
    return rows


def _kmajor_int8(torch, gen, dev, K, N):
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    return w.t()                                   # [K, N], K-major storage


def check_qmatmul(torch, dev, gen):
    from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_cuda
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref

    rows = []
    for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (8, 64, 256):
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            for out_dtype in (torch.bfloat16, torch.float32):
                y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=out_dtype)
                yr = qmatmul_w8a8_ref(a, w, sa, sw, bias, out_dtype)
                torch.cuda.synchronize()
                assert torch.equal(y, yr), (
                    f"qmatmul_w8a8 M={M} K={K} N={N} {out_dtype}: not "
                    f"bit-equal (max |diff| "
                    f"{float((y.float() - yr.float()).abs().max())})")
            # torch._int_mm takes M > 16 only: at decode (M = 8) it runs on
            # the rows zero-padded to 32, the nearest shape it accepts
            a_lib = a if M > 16 else torch.cat(
                [a, a.new_zeros((32 - M, K))])
            lib = device_ms(lambda: torch._int_mm(a_lib, w), 50)
            lib_call = ("torch._int_mm" if M > 16
                        else f"torch._int_mm, M zero-padded {M}->32")
            b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw, bias,
                                             out_dtype=torch.bfloat16)
            rows.append({
                "shape": f"M={M} K={K} N={N} -> bf16", "max_abs_err": 0.0,
                "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                    a, w, sa, sw, bias, torch.bfloat16), 10),
                "bound_ms": b, "bound_by": by, "library_ms": lib,
                "library": lib_call})
    return rows


def bf16_ulp(torch, x):
    """Spacing of bfloat16 numbers at |x| (float32): 2**(e-8) for |x| in
    [2**(e-1), 2**e), the subnormal spacing 2**-133 below 2**-126."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_fused_out(torch, out, outr, oq, os_, oqr, osr, what):
    """Hold fused_decode's ``out`` and its quantize-out epilogue against the
    plain version's; return (max |out diff|, a summary)."""
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    B = out.shape[0]
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    diff = (o - r).abs()
    bf16 = out.dtype == torch.bfloat16
    ok = diff <= (bf16_ulp(torch, r) if bf16 else 1e-6 + 1e-5 * r.abs())
    assert bool(ok.all()), (f"{what}: out off at {int((~ok).sum())} values "
                            f"(max |diff| {float(diff.max())})")
    # the epilogue quantizes the cast output (not the float32 accumulator)
    # with the quantize_act formula: bit-equal to that on the kernel's out
    qs, ss = quantize_act_ref(o)
    assert torch.equal(oq, qs) and torch.equal(os_, ss), (
        f"{what}: quantize-out is not quantize_act of the cast output")
    # against the reference: a row whose out is bit-equal quantizes
    # bit-equal; elsewhere the scale moves by at most the row's out error
    # / 127 (+1 ulp for the division), and an int8 value only at a rounding
    # tie of the reference (|x/scale| within 1e-3 of .5) or, in bf16, where
    # that element of out itself moved
    same = (diff == 0).all(1)
    assert torch.equal(oq[same], oqr[same]) and torch.equal(
        os_[same], osr[same]), f"{what}: quantize-out of a bit-equal row differs"
    assert bool(((os_ - osr).abs()
                 <= diff.amax(1) / 127 + osr * 2.0 ** -23).all()), (
        f"{what}: quantize-out scale off")
    dq = (oq.int() - oqr.int()).abs()
    tie = ((r / osr[:, None]).abs() % 1.0 - 0.5).abs() < 1e-3
    allowed = tie | (diff > 0) if bf16 else tie
    assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~allowed).any()), (
        f"{what}: quantize-out int8 differs away from a rounding tie")
    return float(diff.max()), (
        f"out bit-equal in {int(same.sum())}/{B} rows; quantize-out bit-equal "
        f"to quantize_act of the kernel's out; int8 off by 1 at "
        f"{int((dq > 0).sum())} of {dq.numel()} (at ties "
        f"{int(((dq > 0) & tie).sum())})")


def check_fused_decode(torch, dev, gen):
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.fused_decode.ref import fused_decode_ref

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kq = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, S, Hkv), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, S, Hkv), generator=gen, device=dev) * 0.02
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[1] = S                                    # a full ring
        idx = lens - 1
        idx[2] = S - 1                                 # write at the ring end
        lens[2] = S
        valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
        valid[3] = False                               # a fully masked row
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kn = (torch.randn((B, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
        vn = torch.randn((B, Hkv, hd), generator=gen, device=dev).to(dtype)
        idx32 = idx.to(torch.int32)

        leaves = [t.clone() for t in (kq, ks, vq, vs)]
        out, oq, os_ = fused_decode_cuda(q, *leaves, kn, vn, idx32, valid,
                                         quantize_out=True)
        ref_leaves = [t.clone() for t in (kq, ks, vq, vs)]
        (outr, oqr, osr), _ = fused_decode_ref(
            q, *ref_leaves, kn[:, None], vn[:, None], idx[:, None],
            valid=valid, out_dtype=dtype, quantize_out=True)
        torch.cuda.synchronize()
        for a, b_, name in zip(leaves, ref_leaves, ("k", "k_scale", "v",
                                                     "v_scale")):
            assert torch.equal(a, b_), f"fused_decode {dtype}: appended {name} differs"
        err, note = check_fused_out(torch, out, outr, oq, os_, oqr, osr,
                                    f"fused_decode {dtype}")
        assert float(out[3].float().abs().max()) == 0.0, "masked row not 0"
        log(f"  fused_decode {str(dtype)[6:]}: out max |diff| {err:.3g} "
            f"({OUT_TOL[str(dtype)[6:]]}); {note}; appended leaves bit-equal")

        n_live = int(valid.sum())
        e = q.element_size()
        bytes_moved = (2 * B * Hq * hd * e + n_live * Hkv * (hd + 4) * 2
                       + B * S + 2 * B * Hkv * hd * (e + 1) + 8 * B * Hkv
                       + B * Hq * hd + 4 * B)
        b, by = bound_ms(bytes_moved, 4 * Hq * n_live * hd, F32_OPS_S)
        run_leaves = [t.clone() for t in (kq, ks, vq, vs)]
        kern = lambda: fused_decode_cuda(q, *run_leaves, kn, vn, idx32, valid,
                                         quantize_out=True)
        rows.append({
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {str(dtype)[6:]}",
            "max_abs_err": err,
            "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
            "plain_ms": device_ms(lambda: fused_decode_ref(
                q, *run_leaves, kn[:, None], vn[:, None], idx[:, None],
                valid=valid, out_dtype=dtype, quantize_out=True), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None})
    return rows


# --------------------------------------------------------------- phase 3
def check_reference(torch, dev):
    """Smoke-size qwen2: the card (kernels) against the CPU (plain)."""
    from repro_torch import build_model, get_config
    from repro_torch.quantized import QTensor, quantize_for_serving

    cfg = get_config("qwen2-0.5b-smoke")
    model = build_model(cfg)
    params = quantize_for_serving(model.init(0, device="cpu"),
                                  model.weight_sites(), mode="w8a8")
    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        if isinstance(t, QTensor):
            return QTensor(t.q.to(dev), t.scale.to(dev), t.mode)
        return t.to(dev)

    params_dev = to_dev(params)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
    out = {}
    for name, d, p in (("cpu", "cpu", params), ("cuda", dev, params_dev)):
        m = build_model(cfg)
        cache = m.init_cache(4, 32, device=d)
        lg, cache = m.prefill(p, toks[:, :8].to(d), cache)
        steps = [lg]
        for t in range(8, 24):
            lg, cache = m.decode_step(p, toks[:, t:t + 1].to(d), cache)
            steps.append(lg)
        out[name] = torch.stack(steps).float().cpu()
    diff = float((out["cpu"] - out["cuda"]).abs().max())
    scale = float(out["cpu"].abs().max())
    agree = float((out["cpu"].argmax(-1) == out["cuda"].argmax(-1)).float().mean())
    log(f"  smoke qwen2 (2 layers, f32) card vs CPU plain versions, prefill 8 "
        f"+ 16 teacher-forced decode steps: max |logit diff| {diff:.3g} (max "
        f"|logit| {scale:.3g}), greedy agreement {agree:.3f}")
    assert all(torch.isfinite(v).all() for v in out.values())
    assert diff <= 0.05 * scale and agree >= 0.9, "card and CPU disagree"


# --------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device — this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    log("== phase 1: build")
    lib = _build.build()
    log(f"  built {lib.path.name} in {lib.seconds:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {"quantize_act": check_quantize_act(torch, dev, gen),
              "qmatmul_w8a8": check_qmatmul(torch, dev, gen),
              "fused_decode": check_fused_decode(torch, dev, gen)}
    for name, rows in tables.items():
        for r in rows:
            lib_ms = ("-" if r["library_ms"] is None
                      else f"{r['library_ms'] * 1e3:.2f}")
            log(f"  {name:13s} {r['shape']:34s} kernel "
                f"{r['ms'] * 1e3:8.2f} us (call {r['call_ms'] * 1e3:7.2f})  "
                f"plain {r['plain_ms'] * 1e3:9.2f} us  library {lib_ms:>6s} us"
                f"  bound {r['bound_ms'] * 1e3:7.3f} us ({r['bound_by']})"
                + (f"  [{r['library']}]" if "padded" in r.get("library", "")
                   else ""))

    log("== phase 3: small-input reference")
    check_reference(torch, dev)

    log("== phase 4: serve qwen2-0.5b (full width) through repro_torch.serve")
    config = repro_torch.ServeConfig(
        arch="qwen2-0.5b", seed=0, device="cuda",
        slots=8, max_len=512, prefill_chunk=32, trace=16, trace_seed=0,
        prompt_min=32, prompt_len=256, gen_min=32, gen_len=32)
    reset_launch_counts()
    run = repro_torch.serve(config)
    counts = launch_counts()
    assert len(run.results) == 16, f"{len(run.results)} of 16 requests served"
    for r in run.results.values():
        assert r.status == "ok", f"request {r.rid}: {r.status} (non-finite logits)"
        assert len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens"
    log(f"  16/16 requests finished with finite logits, "
        f"{run.generated_tokens} tokens in {run.seconds:.3f} s = "
        f"{run.tokens_per_second:.1f} tok/s (stepwise engine, 8 slots)")
    log(f"  kernel launches on the serving path: {json.dumps(counts)}")
    for name in tables:
        assert counts.get(name, 0) > 0, f"{name} was never launched while serving"

    main_shape = {"quantize_act": "x[8,896] bfloat16",
                  "qmatmul_w8a8": "M=8 K=896 N=4864 -> bf16",
                  "fused_decode": "B=8 Hq=14 Hkv=2 hd=64 S=512 bfloat16"}
    sources = {"quantize_act": ("src/repro_torch/csrc/quantize_act.cu",
                                "src/repro/kernels/quantize_act/kernel.py:27"),
               "qmatmul_w8a8": ("src/repro_torch/csrc/qmatmul_w8a8.cu",
                                "src/repro/kernels/qmatmul_w8a8/kernel.py:72"),
               "fused_decode": ("src/repro_torch/csrc/fused_decode.cu",
                                "src/repro/kernels/fused_decode/kernel.py:143")}
    kernels = []
    for name, rows in tables.items():
        row = next(r for r in rows if r["shape"] == main_shape[name])
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": counts[name], **row})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
