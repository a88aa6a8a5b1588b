#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing here catches a failure):

  1. build  — refuse to run with ``REPRO_KERNEL_BACKEND`` set (every tier
     here is picked by explicit argument), compile every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel) and print
     the build time, the registers/spills ptxas reports, and the card's
     name and power limit.
  2. kernels — call each of the seven kernels' wrappers on the card at the
     shapes the serving paths give it and hold it against its plain PyTorch
     version on the same inputs: quantize_act (also at bits 2, 4 and 6, on
     .5 ties and near-ties, ragged K and a row past its registers, timed
     beside a one-element launch, the launch floor) and qmatmul_w8a8
     bit-equal;
     qmatmul_w8a16 within ``W8A16_TOL`` (it applies the scale after the sum,
     the plain version before it); fused_decode's appended cache bit-equal,
     its output within ``OUT_TOL``, and its quantize-out bit-equal to
     quantize_act of that output and off the plain version's only at
     rounding ties; kv_attention within ``OUT_TOL`` at the decode shape, a
     ragged S, S below the plain version's block, GQA 4 and the JAX bench's
     long context, with and without v_err, a fully masked row exactly 0;
     fused_decode bit-equal to append_quantize + kv_attention (+
     quantize_act); the attention split sweep (both attention kernels under
     forced S splits at the decode shape and the long context, with rows
     whose splits are all masked but one: within ``OUT_TOL``, two calls and
     fused against unfused bit-equal at every split, each split timed); the
     three calls the CUDA tiers once refused (kv_attention's float32 out
     from bfloat16 q, fused_decode's shared idx [1] and float32 quantize-out
     from bfloat16 q, quantize_act at bits < 8), against the torch tier;
     the quantize-out GEMMs (one launch each) bit-equal to
     the stepwise pair of the port's own kernels (W8A8, and W8A16 with
     float32 a) and to the W8A8 plain version, W8A16 with bfloat16 a within
     one step of its plain version, at every path shape, the JAX benches'
     shapes and qwen2's vocabulary (N = 151936, the workspace route), on
     the route ``gemm_plan.q8_plan`` takes, at bits 4 and 8 and on the
     forced workspace route at one decode and one prefill shape, two calls
     of each bit-equal; each shape's route, tile, tickets and waiters are
     logged beside the q8 kernel, the pair and the GEMM alone (warm, and
     cold at M = 8). In float32 the W8A16 check also runs
     two controls that must fall outside its tolerance (TF32, and ``a``
     rounded to bf16). The split sweep runs both GEMMs at every path shape
     under forced K splits (1, 2, the planner's, the largest it allows):
     W8A8 bit-equal in both output types at M = 8, 64 and 256, W8A16 within
     ``W8A16_TOL`` in bf16 and f32, and two calls of each GEMM and each
     quantize-out variant bit-equal; it logs each split's time. The
     quantize-in W8A8 GEMM (qmatmul_w8a8_qin: quantize_act folded into its
     prologue) bit-equal to quantize_act + qmatmul_w8a8, and the int8 x it
     hands out to quantize_act's, at every path K x N and a ragged K, M 1-256,
     bf16/f32 x and out, every split whose slice fits, .5 ties, near-ties, a
     zero row and a row whose only large value lies in the last split;
     timed beside the pair, the GEMM alone and torch._int_mm, warm and (M =
     8) cold. Times each
     kernel (device time, queued behind a sleep kernel so the host's
     per-call cost is hidden, and the time of a back-to-back wrapper call,
     host included), its plain version, the stepwise pair a quantize-out GEMM
     replaces and, where one exists, the one PyTorch call computing the same
     function, all with CUDA events, and beside the attention rows
     ``scaled_dot_product_attention`` on a bfloat16 cache of the same shape
     (GQA heads expanded: a different function, a yardstick only). At M = 8
     the GEMMs and their library
     calls are also timed cold: rotating over 128 MB of weight copies, so
     each call reads its weight from HBM as the serving path does. One line
     sums the GEMMs' device time over a decode step and a prefill chunk, two
     more a W8A8 decode step's GEMMs + activation quantization, pair
     against fold. Then the geometries of the four other dense archs:
     fused_decode and kv_attention at B=8 S=512 with Hq/Hkv/hd 32/8/128
     (mistral-nemo-12b), 56/8/128 (yi-34b), 64/8/128 (chameleon-34b) and
     16/16/256 (gemma-7b), float32 and bfloat16, against their plain
     versions as above (the plan's splits and shared memory logged); and
     the three W8A8/W8A16 GEMMs at mistral-nemo-12b's decode projections
     and gemma-7b's K=24576 down projection, M = 8 and 256: qmatmul_w8a8
     bit-equal, qmatmul_w8a16 within ``W8A16_TOL``, qmatmul_w8a8_qin
     bit-equal to the pair where ``gemm_plan`` folds and refused with the
     plan's reason where it does not; every new row timed in the phase's
     row format (the kernels JSON line keeps qwen2's rows).
  3. reference — for each serving recipe, the paper's Fig. 4 recipes
     (``dfq-int8``, ``naive-int8``, ``cle-only``) and the bias-corrected
     w8a8 deployment (``BC_DEPLOY``), ``repro_torch.quantize`` of a
     smoke-size qwen2 (seeded weights that need every rewrite) on the card
     against the same call on the CPU, on the same calibration tokens:
     payloads, scales and weight leaves bit-equal, E[x] within
     ``STAT_TOL``, each corrected bias within ``correction_bounds`` (``bo``
     also within its absorption's matrix-product rounding bound); then
     that model on the card against the CPU's (plain versions):
     teacher-forced logits within tolerance. Then the JAX integration
     test's gate on the card: on those weights dfq-int8's logits SQNR
     above naive-int8's by 10 dB, greedy agreement above 0.9. Then the fp
     KV cache: serve-w8a16 and serve-w8a8 the same way over it; and
     ``repro_torch.serve`` at smoke size, fast (graphs) and stepwise on
     the card against the CPU, for serve-w8a16 and serve-w8a8 over the fp
     cache, ``--quantize none`` and each other dense arch under
     serve-w8a16-kv8 — fast equal to stepwise, launch counts exact, every
     request's first token the CPU's, and the same quantized weights'
     teacher-forced prefill and decode logits on the card within tolerance
     of the CPU's; and ``backend="torch"`` on the
     card: the CPU's tokens and ticks, no kernel launched.
  4. serve — qwen2-0.5b at full width (24 layers, seeded random weights
     through ``repro_torch.quantize``: norm folding, CLE and bias
     absorption on the card, then the int8 pack), the engine with 8 slots,
     max_len 512, prefill chunks of 32, 16 requests of 32-256 prompt
     tokens and 32 new tokens each. The fast path (the default: batched
     prefill, decode horizons of up to 8 steps, each dispatch a replayed
     CUDA graph, every graph captured by ``warmup`` before the timed
     loop) five times: ``repro_torch.serve`` under ``serve-w8a16-kv8``
     (the default) and ``serve-w8a8-kv8``, both again with
     ``REPRO_FUSED_DECODE=0`` (which must serve the fused runs' tokens,
     request by request), and ``serve-w8a8-kv8`` with the V bias
     correction (``kv_bias_correct``, a ``repro_torch.ServingEngine`` over
     the replaced config, ``engine.warmup()``). The stepwise path
     (``reference=True``) once for each recipe and for the V bias
     correction: each fast run must serve its stepwise run's tokens and
     finish ticks, request by request. Every request must finish with 32
     tokens and finite logits. The launch counts are reset just before
     each run and read just after, and each kernel must have launched
     exactly as often as the path's layers and forwards give
     (``expected_launches`` of the run's decode steps and prefill
     dispatches, its warmup's included: a replay counts the launches its
     graph holds; as ``gemm_plan`` folds: no quantize_act at a W8A8 decode
     step), every other kernel never. Each run logs its path, decode
     dispatches and mean horizon, host syncs a token, and for the fast
     path the graphs' capture seconds and pool memory; tok/s fast beside
     stepwise. One more, untimed fast run of the default recipe under
     ``torch.profiler`` logs the device busy share of the loop.
  5. DFQ at full width — qwen2-0.5b with ``hostile_params`` drawn on the
     card, through ``repro_torch.quantize`` under naive-int8, cle-only,
     fold → CLE → absorb → weight_quant (no correction) and dfq-int8: each
     stage's seconds, the sites bias_correct corrected, the per-site weight
     SQNR, logits SQNR and greedy agreement against fp on tokens of
     another seed than the calibration's, and the output mean error at
     every captured statistic without and with the correction; dfq-int8's
     SQNR must be above naive-int8's (the other orderings are logged).
     Then the bias-corrected w8a8 deployment of those weights is saved
     (``QuantizedModel.save`` under ``build/``, removed afterwards),
     loaded (every leaf bit-equal) and served by
     ``repro_torch.serve(ServeConfig(load=...))`` on phase 4's trace, fast
     and stepwise: every request finishes, the same tokens and ticks, the
     exact launch counts; its tok/s beside phase 4's serve-w8a8-kv8.
  6. serve mistral-nemo-12b — at full width (d_model 5120, 32 q / 8 kv
     heads of 128, d_ff 14336, vocab 131072, bf16), at every layer that
     leaves 8 GiB of the card free while ``repro_torch.quantize`` runs
     (the peak measured at 2 and 4 layers, extrapolated; the depth is
     logged), through ``repro_torch.serve`` on phase 4's trace:
     serve-w8a16 over the bf16 KV cache (the reference's default
     deployment) and serve-w8a8-kv8, each stepwise and fast (graphs
     captured by warmup): fast tokens and ticks equal stepwise, launch
     counts exact as ``gemm_plan`` plans them, tok/s, quantize and warmup
     seconds and peak memory logged beside the card's name and power
     limit, and the phase's wall seconds.
  7. the paper's CNN flow — no Pallas kernel lies on it, so no kernel row.
     7a: the JAX reference's recipe (``benchmarks/_cnn_pipeline.py``) on
     the repo's mobilenet_v2 config: ``MobileNetCNN.init(0)``, 300 AdamW
     steps at batch 128 on ``synthetic_image_batch`` (drawn on the host by
     4 threads), fold, the hostile rescale; then the rows of the paper's
     Tables 1 and 2 (``benchmarks.tables``: original, ReLU6 → ReLU, CLE,
     + absorption, per-channel, bias correction alone, clip@15 with and
     without it, full DFQ), 8-bit weights and data-free 8-bit activations
     on 6 held-out batches of 256, each beside the JAX reference's CPU
     number. Gates: the loss finite and falling, CLE's fp32 top-1 within
     0.2 points of the ReLU model's, full DFQ int8 at least the ReLU fp32
     top-1 − 5 and the original int8 + 30. 7b: MobileNetV2's published
     widths at 224 (``MOBILENET_V2_224``: no 1280 conv, ReLU), random
     weights with log-normal BN γ and normal β, running statistics from 30
     train-mode forwards at batch 32, folded and made hostile; fold, CLE,
     absorption, 8-bit weights and analytic correction on the card equal
     to the CPU's leaf by leaf (bit-equal, sums within ``CNN_SUM_TOL``);
     fp32 logits card against CPU within ``CNN_FWD_TOL`` and a TF32
     forward outside it; the fp32 logits after CLE within ``CNN_CLE_TOL``
     and after absorption within ``CNN_ABSORB_TOL`` of the hostile
     model's; full DFQ's logits SQNR above original int8's. Logged: the
     SQNRs, Fig. 2's depthwise range spread, each stage's seconds,
     images/s of the folded forward at batch 64 and 256 with and without
     activation fake-quant, and peak memory, beside the card's name and
     power limit.
  8. the paged pool — qwen2-0.5b at full width on phase 4's settings with
     pages of 32 positions (``PAGED``). 8a: ``repro_torch.serve`` under
     serve-w8a16 over the bf16 KV cache (the default deployment) and
     serve-w8a8-kv8, each fast after warmup four times in turns
     (contiguous, paged, paged, contiguous) and paged stepwise, and
     serve-w8a8-kv8 paged fast with REPRO_FUSED_DECODE=0 (kv_attention
     over the dense view): every request's tokens and finish tick the
     contiguous runs' (and phase 4's for serve-w8a8-kv8), launches exact;
     tok/s paged beside contiguous from the turns, the page pool's and the
     dense view's bytes. Then ``ServingEngine``s over
     one serve-w8a16 model: 8b a trace of 16 requests sharing a 192-token
     prefix, reuse on and off — the same tokens, no request later with
     reuse on, prefix hits, fewer prefill chunks, ``cow_copies`` logged;
     8c a pool of half the full capacity under two priority classes —
     preemptions, each resumed, every request ok with the full pool's
     tokens; 8e phase 4's trace with deadlines — fast and stepwise expire
     the same requests at the same ticks with the same tokens; each run's
     launches exact. 8d ``run_chaos`` under ``FaultPlan.seeded`` at the
     chaos CLI's settings (a smoke model under serve-w8a16, weights drawn
     on the host) on the card and on the CPU: the pool audited after
     every step, 0 leaked pages, the unfaulted requests the card's
     fault-free tokens, outcomes, counts and steps the CPU's, launches
     exact. Last, the dense view's memory and the device time of the
     gather and of a horizon's commit (each in a CUDA graph) for both
     caches beside the bytes bound, and the phase's wall seconds.

The line before the last is the kernel table as one JSON object; the last
line is the device record. Exits non-zero with no result when torch sees no
CUDA device, or when the port's sources are not beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 and bf16
# tensor-core operations/s, float32 (CUDA-core) operations/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12

# fused_decode's ``out`` against its plain version (expf and the order of the
# sums differ, so the float32 results are ~1e-7 apart): float32 within
# T = atol 1e-6 + rtol 1e-5; bfloat16 within T plus one bf16 ulp of
# |reference| + T, since two float32 values that close can round to
# neighbouring bf16 values. (One bf16 ulp alone does not hold near zero,
# where two float32 values within T may lie more than a bf16 ulp apart.)
OUT_TOL = {"float32": "T = atol 1e-6 + rtol 1e-5",
           "bfloat16": "T + 1 bf16 ulp"}

# qmatmul_w8a16 against its plain version: the kernel sums a·q in float32
# and scales after the sum; the plain version rounds q·s first and sums
# a·(q·s). Both are float32 sums of the same K products, rounded in other
# orders, and such rounding errors add like a random walk: about
# sqrt(K) · 2^-24 · ||a_m ⊙ w_n||, the products' 2-norm being
# sqrt(a² @ w_deq²). The float32 tolerance is 16 times that, plus the
# epilogue's roundings of the scale and the bias:
#   E = 16 · sqrt(K) · 2^-24 · sqrt(a² @ w_deq²) + 2^-22 · (|y| + |bias|).
# A product with 10-bit mantissas (TF32: about 2^-11 · ||a_m ⊙ w_n||) or
# with a rounded to bf16 lies well outside it, and phase 2 checks that both
# do. The bfloat16 output rounds the two float32 results once more: within
# E plus one bf16 ulp of |y| + E (one ulp alone fails where the sum cancels,
# |y| far below the products' norm).
W8A16_TOL = {"float32": "E = 16 sqrt(K) 2^-24 sqrt(a^2 @ w^2) + 2^-22 (|y|+|b|)",
             "bfloat16": "E + 1 bf16 ulp"}


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


# weight copies a cold timing rotates over: 2.5 times the H100's 50 MB L2
COLD_BYTES = 128 << 20


def cold_ms(torch, call, w, iters: int = 50) -> float:
    """``device_ms`` of ``call(w_i)`` rotating over copies of the K-major
    int8 weight ``w`` ([K, N] view of [N, K] storage) that together hold at
    least ``COLD_BYTES``: each call reads a weight that ~128 MB of other
    weights were read after, as the serving path reads 358 MB of weights a
    decode step, so it comes from HBM and not from the L2."""
    import itertools

    K, N = w.shape
    n = -(-COLD_BYTES // (K * N))
    copies = w.t().unsqueeze(0).expand(n, N, K).contiguous()
    views = [copies[i].t() for i in range(n)]
    turn = itertools.count()
    ms = device_ms(lambda: call(views[next(turn) % n]), iters)
    del views, copies
    return ms


# --------------------------------------------------------------- phase 2
def check_quantize_act(torch, dev, gen):
    """The standalone kernel at the serving shapes (timed), a ragged K (the
    element-wise loader) and a row too long for the registers (the re-read
    loop), with .5 ties and a row of near-ties: bit-equal to the plain
    version at 8 bits and at bits 2, 4 and 6.
    Each timed row carries the launch floor: the device time of a
    one-element ``fill_`` in the same phase."""
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    one = torch.zeros((1,), device=dev)
    floor = device_ms(lambda: one.fill_(1.0), 100)
    timed = ((8, 896), (8, 4864), (64, 896), (256, 896), (256, 4864))
    rows = []
    for M, K in timed + ((13, 77), (8, 4100), (2, 40000)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=gen, device=dev) * 3
            x[0, :7] = torch.tensor([0.5, 1.5, -2.5, 0, 0, 0, 0])  # ties
            x[1] = near_ties(torch, gen, dev, K)            # at scale 1
            x[1, 0] = 127.0
            x = x.to(dtype)
            for bits in (8, 2, 4, 6):
                q, s = quantize_act_cuda(x, bits)
                qr, sr = quantize_act_ref(x, bits)
                torch.cuda.synchronize()
                assert torch.equal(q, qr) and torch.equal(s, sr), (
                    f"quantize_act {M}x{K} {dtype} bits={bits}: not bit-equal "
                    f"to the plain version ({int((q != qr).sum())} payload "
                    f"mismatches)")
            if (M, K) not in timed:
                continue
            e = x.element_size()
            b, by = bound_ms(M * K * e + M * K + 4 * M, 5 * M * K, F32_OPS_S)
            rows.append({
                "shape": f"x[{M},{K}] {str(dtype)[6:]}", "max_abs_err": 0.0,
                "ms": device_ms(lambda: quantize_act_cuda(x), 100),
                "call_ms": call_ms(lambda: quantize_act_cuda(x), 100),
                "plain_ms": device_ms(lambda: quantize_act_ref(x), 20),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "floor_ms": floor})
    log(f"  quantize_act at 8 shapes x bf16/f32 x bits 8/2/4/6 (ragged K=77 "
        f"and 4100, K=40000 past the registers): bit-equal to the plain "
        f"version; launch floor (one-element fill_) {floor * 1e3:.2f} us")
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
            row = {
                "shape": f"M={M} K={K} N={N} -> bf16", "mkn": [M, K, N],
                "max_abs_err": 0.0,
                "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                    a, w, sa, sw, bias, torch.bfloat16), 10),
                "bound_ms": b, "bound_by": by, "library_ms": lib,
                "library": lib_call}
            if M == 8:
                # each call's weight from HBM, not from the L2
                row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_cuda(
                    a, wc, sa, sw, bias, out_dtype=torch.bfloat16), w)
                row["library_cold_ms"] = cold_ms(
                    torch, lambda wc: torch._int_mm(a_lib, wc), w)
            rows.append(row)
    return rows


def w8a16_tolerance(torch, a, w_q, w_scale, bias, y_ref):
    """``W8A16_TOL`` elementwise for the plain version's output ``y_ref``."""
    w_deq = w_q.float() * torch.atleast_1d(w_scale).float()[None, :]
    norm = torch.sqrt(a.float().square() @ w_deq.square())
    e = 16 * a.shape[1] ** 0.5 * 2.0 ** -24 * norm + 2.0 ** -22 * (
        y_ref.float().abs() + (0 if bias is None else bias.float().abs()))
    if y_ref.dtype == torch.bfloat16:
        e = e + bf16_ulp(torch, y_ref.float().abs() + e)
    return e


def check_qmatmul_w8a16(torch, dev, gen):
    """The W8A16 GEMM at the serving path's shapes: every projection at
    decode (M = 8) and at a prefill chunk (M = 8 slots x 32 = 256), a
    per-tensor [1] scale, a bias (bq, bk, bv, bo and bd have one), in bf16
    (scale and bias bf16, as the bf16 model casts them) and in float32. In
    float32 two controls must fall outside the tolerance: the plain version
    with TF32 allowed, and with ``a`` rounded to bf16."""
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    rows = []
    for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
        w = _kmajor_int8(torch, gen, dev, K, N)
        for M in (8, 256):
            for dtype in (torch.bfloat16, torch.float32):
                a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                sw = (torch.rand((1,), generator=gen, device=dev) * 0.01
                      + 1e-4).to(dtype)
                bias = torch.randn((N,), generator=gen, device=dev).to(dtype)
                y = qmatmul_w8a16_cuda(a, w, sw, bias)
                yr = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
                torch.cuda.synchronize()
                diff = (y.float() - yr.float()).abs()
                tol = w8a16_tolerance(torch, a, w, sw, bias, yr)
                name = str(dtype)[6:]
                worst = int((diff - tol).argmax())
                assert bool((diff <= tol).all()), (
                    f"qmatmul_w8a16 M={M} K={K} N={N} {name}: off the plain "
                    f"version at {int((diff > tol).sum())} values (max |diff| "
                    f"{float(diff.max())}, {W8A16_TOL[name]}; worst: kernel "
                    f"{float(y.flatten()[worst])!r}, plain "
                    f"{float(yr.flatten()[worst])!r}, tolerance "
                    f"{float(tol.flatten()[worst])!r})")
                note = f"max |diff|/tol {float((diff / tol).max()):.3g}"
                if dtype == torch.bfloat16:
                    ulp = bf16_ulp(torch, yr.float())
                    note += (f"; of {diff.numel()}: "
                             f"{int(((diff > 0) & (diff <= ulp)).sum())} one "
                             f"bf16 ulp off, {int((diff > ulp).sum())} more")
                if dtype == torch.float32:
                    # controls: a lower-precision product must fail E
                    torch.backends.cuda.matmul.allow_tf32 = True
                    y_tf32 = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
                    torch.backends.cuda.matmul.allow_tf32 = False
                    y_a16 = qmatmul_w8a16_ref(a.bfloat16(), w, sw, bias, dtype)
                    ctl = [float(((c - yr).abs() / tol).max())
                           for c in (y_tf32, y_a16)]
                    assert min(ctl) > 1, (
                        f"qmatmul_w8a16 M={M} K={K} N={N}: a control passed "
                        f"the float32 tolerance (max |diff|/tol: TF32 "
                        f"{ctl[0]}, a in bf16 {ctl[1]})")
                    note += (f"; controls max |diff|/tol: TF32 {ctl[0]:.3g}, "
                             f"a in bf16 {ctl[1]:.3g}")
                log(f"  qmatmul_w8a16 M={M} K={K} N={N} {name}: max |diff| "
                    f"{float(diff.max()):.3g} ({W8A16_TOL[name]}); {note}")
                e = a.element_size()
                b, by = bound_ms(M * K * e + K * N + e + N * e + M * N * e,
                                 2 * M * K * N,
                                 BF16_OPS_S if dtype == torch.bfloat16
                                 else F32_OPS_S)
                if has_lib:
                    # int8 weight [N, K] and a per-channel scale in a's type
                    wt, s_n = w.t(), sw.expand(N).contiguous()
                    lib_fn = lambda: torch._weight_int8pack_mm(a, wt, s_n)
                    lib_call = "torch._weight_int8pack_mm"
                else:
                    # the weight pre-dequantized to a's type: reads twice
                    # the int8 weight's bytes in bf16
                    w_deq_t = (w.float() * sw.float()).to(dtype).t().contiguous()
                    lib_fn = lambda: torch.nn.functional.linear(a, w_deq_t, bias)
                    lib_call = "F.linear on the pre-dequantized weight"
                kern = lambda: qmatmul_w8a16_cuda(a, w, sw, bias)
                row = {
                    "shape": f"M={M} K={K} N={N} {name}", "mkn": [M, K, N],
                    "max_abs_err": float(diff.max()),
                    "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
                    "plain_ms": device_ms(lambda: qmatmul_w8a16_ref(
                        a, w, sw, bias, dtype), 10),
                    "bound_ms": b, "bound_by": by,
                    "library_ms": device_ms(lib_fn, 50), "library": lib_call}
                if M == 8:
                    # each call's weight from HBM, not from the L2
                    row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a16_cuda(
                        a, wc, sw, bias), w)
                    if has_lib:
                        row["library_cold_ms"] = cold_ms(
                            torch, lambda wc: torch._weight_int8pack_mm(
                                a, wc.t(), s_n), w)
                rows.append(row)
    return rows


def bf16_ulp(torch, x):
    """Spacing of bfloat16 numbers at |x| (float32): 2**(e-8) for |x| in
    [2**(e-1), 2**e), the subnormal spacing 2**-133 below 2**-126."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_attention_out(torch, out, outr, what):
    """Hold a decode attention output (fused_decode's or kv_attention's)
    against its plain version within ``OUT_TOL``; return (|diff| [B, Hq·hd],
    a note on the values one bf16 ulp alone would refuse)."""
    B = out.shape[0]
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    diff = (o - r).abs()
    bf16 = out.dtype == torch.bfloat16
    tol = 1e-6 + 1e-5 * r.abs()
    if bf16:
        tol = tol + bf16_ulp(torch, r.abs() + tol)
    ok = diff <= tol
    worst = int((diff - tol).argmax())
    assert bool(ok.all()), (
        f"{what}: out off at {int((~ok).sum())} values (max |diff| "
        f"{float(diff.max())}; worst at row {worst // o.shape[1]} col "
        f"{worst % o.shape[1]}: kernel {float(o.flatten()[worst])!r}, plain "
        f"{float(r.flatten()[worst])!r}, tolerance {float(tol.flatten()[worst])!r})")
    past = ""
    if bf16:
        # the elements one bf16 ulp alone would not admit, and the worst one
        ulp = bf16_ulp(torch, r)
        over = diff > ulp
        if bool(over.any()):
            i = int(torch.where(over, diff - ulp, -1.0).argmax())
            past = (f"; beyond one bf16 ulp at {int(over.sum())} of "
                    f"{diff.numel()}, all at |plain| <= "
                    f"{float(r.abs()[over].max()):.3g} (worst: kernel "
                    f"{float(o.flatten()[i])!r}, plain {float(r.flatten()[i])!r}"
                    f", one ulp {float(ulp.flatten()[i])!r}, T + ulp "
                    f"{float(tol.flatten()[i])!r})")
        else:
            past = "; within one bf16 ulp everywhere"
    return diff, past


def check_fused_out(torch, out, outr, oq, os_, oqr, osr, what):
    """Hold fused_decode's ``out`` and its quantize-out epilogue against the
    plain version's; return (max |out diff|, a summary)."""
    from repro_torch.kernels.quantize_act.ref import quantize_act_ref

    B = out.shape[0]
    o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
    bf16 = out.dtype == torch.bfloat16
    diff, past = check_attention_out(torch, out, outr, what)
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
        f"{int(((dq > 0) & tie).sum())}){past}")


def sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, iters):
    """Device time of ``torch.nn.functional.scaled_dot_product_attention``
    for one query token over a bfloat16 K/V cache of the same shape, its
    GQA heads expanded to Hq (unmasked): a different function — it reads
    2 * Hq / Hkv times the int8 cache's payload bytes — timed as a
    yardstick of an unquantized cache's decode attention on this card,
    never as the library column."""
    key = (B, S, Hq, Hkv, hd)
    if key not in _SDPA_MS:
        F = torch.nn.functional
        G = Hq // Hkv
        q = torch.randn((B, Hq, 1, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, S, hd), generator=gen, device=dev)
                .bfloat16().repeat_interleave(G, dim=1) for _ in range(2))
        _SDPA_MS[key] = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), iters)
        del k, v
    return _SDPA_MS[key]


_SDPA_MS: dict = {}


def check_fused_decode(torch, dev, gen):
    from repro_torch.kernels import attention_plan
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
        # the W8A16 path's call: no quantize-out
        no_q8 = lambda: fused_decode_cuda(q, *run_leaves, kn, vn, idx32, valid)
        rows.append({
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {str(dtype)[6:]}",
            "max_abs_err": err,
            "ms": device_ms(kern, 50), "call_ms": call_ms(kern, 50),
            "plain_ms": device_ms(lambda: fused_decode_ref(
                q, *run_leaves, kn[:, None], vn[:, None], idx[:, None],
                valid=valid, out_dtype=dtype, quantize_out=True), 5),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "no_q8_ms": device_ms(no_q8, 50),
            "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
            "splits": attention_plan.plan(B, S, Hq, Hkv, hd).splits})
    return rows


# (label, B, Hq, Hkv, hd, S, the plain version's blk, a fully masked row)
KV_CASES = (("main decode", 8, 14, 2, 64, 512, 512, True),
            ("S=33 blk=32", 4, 14, 2, 64, 33, 32, True),
            ("S<blk", 4, 14, 2, 64, 100, 512, False),
            ("GQA 4", 4, 8, 2, 64, 300, 512, False),
            # the JAX bench's long context (benchmarks/kernels_bench.py)
            ("long context", 8, 32, 8, 128, 32768, 512, False))


def _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens):
    """Random int8 K/V and scales, the scales zero past each row's length
    (the invalid marker the attention masks on); the live mask [B, S]."""
    live = torch.arange(S, device=dev)[None, :] < lens[:, None]
    leaves = []
    for _ in range(2):
        leaves.append(torch.randint(-127, 128, (B, S, Hkv, hd), generator=gen,
                                    device=dev, dtype=torch.int8))
        leaves.append(torch.rand((B, S, Hkv), generator=gen, device=dev)
                      * 0.02 * live[..., None])
    return leaves, live


def check_kv_attention(torch, dev, gen):
    """The unfused decode attention at every KV_CASES shape, float32 and
    bfloat16, with and without v_err (zero where the scales are, as the
    decode route passes it), within ``OUT_TOL`` of the plain version; a row
    whose scales are all 0 gives exactly 0."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref

    rows = []
    for label, B, Hq, Hkv, hd, S, blk, masked in KV_CASES:
        long = S > 4096
        lens = (torch.full((B,), S, device=dev) if long else
                torch.randint(1, S + 1, (B,), generator=gen, device=dev))
        lens[0] = S
        if masked:
            lens[B - 1] = 0
        (kq, ks, vq, vs), live = _int8_cache(torch, dev, gen, B, S, Hkv, hd,
                                             lens)
        v_err = (torch.randn((B, S, Hkv), generator=gen, device=dev) * 1e-3
                 * live[..., None])
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
            for ve in (None, v_err):
                out = kv_attention_cuda(q, kq, ks, vq, vs, ve)
                ref = kv_attention_ref(q, kq, ks, vq, vs, dtype, blk=blk,
                                       v_err=ve)
                torch.cuda.synchronize()
                name = str(dtype)[6:]
                what = (f"kv_attention {label} B={B} Hq={Hq} Hkv={Hkv} "
                        f"hd={hd} S={S} {name}" + (" v_err" if ve is not None
                                                   else ""))
                diff, past = check_attention_out(torch, out, ref, what)
                if masked:
                    assert float(out[B - 1].float().abs().max()) == 0.0, (
                        f"{what}: the fully masked row is not 0")
                log(f"  {what} (plain blk={blk}): max |diff| "
                    f"{float(diff.max()):.3g} ({OUT_TOL[name]}){past}"
                    + ("; masked row exactly 0" if masked else ""))
                if label not in ("main decode", "long context"):
                    continue
                n_live = int(live.sum())
                e = q.element_size()
                bytes_moved = (2 * B * Hq * hd * e + B * S * Hkv * 4
                               + n_live * Hkv * (2 * hd + 4)
                               + (n_live * Hkv * 4 if ve is not None else 0))
                b, by = bound_ms(bytes_moved, 4 * Hq * n_live * hd,
                                 F32_OPS_S)
                iters = 5 if long else 50
                kern = (lambda q=q, ve=ve:
                        kv_attention_cuda(q, kq, ks, vq, vs, ve))
                plain = (lambda q=q, ve=ve: kv_attention_ref(
                    q, kq, ks, vq, vs, dtype, blk=blk, v_err=ve))
                rows.append({
                    "shape": f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name}"
                             + (" v_err" if ve is not None else ""),
                    "max_abs_err": float(diff.max()),
                    "ms": device_ms(kern, iters),
                    "call_ms": call_ms(kern, iters),
                    # at the long context the plain version's ~1,300
                    # launches a call fill the launch queue behind the
                    # sleep of device_ms: time it back to back instead
                    "plain_ms": (call_ms(plain, 2, warmup=1) if long
                                 else device_ms(plain, 5)),
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd,
                                       iters),
                    "splits": attention_plan.plan(B, S, Hq, Hkv, hd,
                                                  ve is not None).splits})
    return rows


def check_fused_equals_unfused(torch, dev, gen):
    """fused_decode against the unfused composition (append_quantize, the
    kv_attention kernel, the quantize_act kernel) at the main decode shape:
    the shared attention body gives the same bits — out, quantize-out and
    the appended cache."""
    from repro_torch.kernels.fused_decode.ops import fused_decode
    from repro_torch.kernels.kv_attention.ops import kv_attention_decode
    from repro_torch.kernels.quantize_act.ops import quantize_act

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    for dtype in (torch.float32, torch.bfloat16):
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[1] = S
        leaves, valid = _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens)
        valid[3] = False                              # a fully masked row
        idx = (lens - 1)[:, None]
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kn = (torch.randn((B, 1, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
        vn = torch.randn((B, 1, Hkv, hd), generator=gen, device=dev).to(dtype)
        fused = [t.clone() for t in leaves]
        comp = [t.clone() for t in leaves]
        (out, oq, os_), _ = fused_decode(q, *fused, kn, vn, idx, valid=valid,
                                         out_dtype=dtype, quantize_out=True)
        outc, _ = kv_attention_decode(q, *comp, kn, vn, idx, valid=valid,
                                      out_dtype=dtype)
        oqc, osc = quantize_act(outc.reshape(B, -1))
        torch.cuda.synchronize()
        for a, b_, name in zip(fused, comp, ("k", "k_scale", "v", "v_scale")):
            assert torch.equal(a, b_), f"fused vs unfused {dtype}: {name} differs"
        assert torch.equal(out, outc), (
            f"fused vs unfused {dtype}: out differs at "
            f"{int((out != outc).sum())} values")
        assert torch.equal(oq, oqc) and torch.equal(os_, osc), (
            f"fused vs unfused {dtype}: quantize-out differs")
        assert float(out[3].float().abs().max()) == 0.0
        log(f"  fused_decode vs append_quantize + kv_attention + quantize_act, "
            f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {str(dtype)[6:]}: out, "
            f"quantize-out and the appended cache bit-equal")


def _decode_inputs(torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens):
    """A decode step's operands: the int8 cache (scales zero past each
    row's length), the live mask (also each row's new position), q, the
    new token's K/V and its ring offset (the last live position; 0 in a
    row of length 0, where the mask hides it)."""
    leaves, valid = _int8_cache(torch, dev, gen, B, S, Hkv, hd, lens)
    idx = (lens - 1).clamp_min(0)
    valid[torch.arange(B, device=dev), idx] |= lens > 0
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
    kn = (torch.randn((B, Hkv, hd), generator=gen, device=dev) * 2).to(dtype)
    vn = torch.randn((B, Hkv, hd), generator=gen, device=dev).to(dtype)
    return leaves, valid, q, kn, vn, idx


# the attention split sweep's shapes: the serving decode step and the JAX
# bench's long context (B, Hq, Hkv, hd, S)
SWEEP_SHAPES = ((8, 14, 2, 64, 512), (8, 32, 8, 128, 32768))


def check_attention_sweep(torch, dev, gen):
    """Both decode attention kernels under forced S splits (the wrappers'
    private ``_splits``) at the serving decode shape and the long context:
    splits in {1, 2, 4, 6, the plan's, 8, 12, 16} as far as the tiles
    allow. Rows:
    0 full, 1 of length 1 (every split but the first fully masked), 2 of
    length 65 (all but two), 3 fully masked, the rest random. At every
    split, in float32 and bfloat16: kv_attention within ``OUT_TOL`` of the
    plain version, row 3 exactly 0, two calls the same bits; fused_decode
    (with quantize-out) equal to append_quantize + the kv_attention kernel
    at the same split + the quantize_act kernel, bit for bit (out,
    quantize-out, cache). Logs each split's device time (bf16) beside the
    bound."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ops import append_quantize
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    for B, Hq, Hkv, hd, S in SWEEP_SHAPES:
        plan = attention_plan.plan(B, S, Hq, Hkv, hd)
        top = attention_plan.max_splits(plan.tiles)
        splits = sorted({s for s in (1, 2, 4, 6, plan.splits, 8, 12, 16)
                         if s <= top})
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[0], lens[1], lens[2], lens[3] = S, 1, 65, 0
        long = S > 4096
        times = []
        for dtype in (torch.float32, torch.bfloat16):
            leaves, valid, q, kn, vn, idx = _decode_inputs(
                torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens)
            kq, ks, vq, vs = leaves
            ref = kv_attention_ref(q, kq, ks, vq, vs, dtype)
            comp = [t.clone() for t in leaves]
            append_quantize(*comp, kn[:, None], vn[:, None], idx[:, None])
            live = valid[..., None]
            ks_eff = torch.where(live, comp[1], 0.0)
            vs_eff = torch.where(live, comp[3], 0.0)
            idx32 = idx.to(torch.int32)
            name = str(dtype)[6:]
            for sp in splits:
                what = f"attention sweep B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name} splits={sp}"
                out = kv_attention_cuda(q, kq, ks, vq, vs, _splits=sp)
                again = kv_attention_cuda(q, kq, ks, vq, vs, _splits=sp)
                torch.cuda.synchronize()
                assert torch.equal(out, again), f"{what}: two calls differ"
                check_attention_out(torch, out, ref, what)
                assert float(out[3].float().abs().max()) == 0.0, (
                    f"{what}: the fully masked row is not 0")
                fused = [t.clone() for t in leaves]
                fo, foq, fos = fused_decode_cuda(q, *fused, kn, vn, idx32, valid,
                                                 quantize_out=True, _splits=sp)
                uo = kv_attention_cuda(q, comp[0], ks_eff, comp[2], vs_eff,
                                       _splits=sp)
                uoq, uos = quantize_act_cuda(uo.reshape(B, -1))
                torch.cuda.synchronize()
                for a, b_, leaf in zip(fused, comp, ("k", "k_scale", "v", "v_scale")):
                    assert torch.equal(a, b_), f"{what}: fused appended {leaf} differs"
                assert torch.equal(fo, uo), (
                    f"{what}: fused out differs from unfused at "
                    f"{int((fo != uo).sum())} values")
                assert torch.equal(foq, uoq) and torch.equal(fos, uos), (
                    f"{what}: fused quantize-out differs from unfused")
                if dtype == torch.bfloat16:
                    iters = 10 if long else 100
                    run = [t.clone() for t in leaves]
                    times.append((sp, device_ms(lambda: kv_attention_cuda(
                        q, kq, ks, vq, vs, _splits=sp), iters) * 1e3,
                        device_ms(lambda: fused_decode_cuda(
                            q, *run, kn, vn, idx32, valid, quantize_out=True,
                            _splits=sp), iters) * 1e3))
            del comp, ks_eff, vs_eff
        n_bytes = B * S * Hkv * (2 * hd + 8)
        log(f"  attention split sweep B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} "
            f"({plan.tiles} tiles of {attention_plan.TS}; * the plan's; cache "
            f"bound {n_bytes / HBM_BYTES_S * 1e6:.2f} us), us kv_attention / "
            f"fused_decode bf16: " + ", ".join(
                f"{sp}{'*' if sp == plan.splits else ''} {tk:.2f} / {tf:.2f}"
                for sp, tk, tf in times))
    log(f"  attention split sweep: every split within {OUT_TOL['float32']} "
        f"(+1 bf16 ulp in bf16) of the plain version, fully masked row 0, two "
        f"calls bit-equal, fused == unfused (out, quantize-out, cache) bit for bit")


def check_queue_c(torch, dev, gen):
    """The three calls the CUDA tiers refused before (ROADMAP Queue C), on
    the card through the public ops, against the torch tier: kv_attention
    with bfloat16 q and the default out_dtype=float32 (within OUT_TOL of
    the plain version; its bf16 cast bit-equal to the kernel's own bfloat16
    output); fused_decode with one shared ring offset idx [1] (bit-equal to
    the same call with that offset per slot, its appended cache bit-equal
    to the plain version's); fused_decode with bfloat16 q, out_dtype=float32
    and the W8A8 quantize-out (the epilogue bit-equal to quantize_act of the
    float32 out, out within OUT_TOL); quantize_act at bits 2, 4 and 6
    (bit-equal to the plain version)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
    from repro_torch.kernels.kv_attention import kv_attention, kv_attention_ref
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    B, Hq, Hkv, hd, S = 8, 14, 2, 64, 512
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lens[3] = 0
    leaves, valid, q, kn, vn, idx = _decode_inputs(
        torch, dev, gen, B, S, Hq, Hkv, hd, torch.bfloat16, lens)
    kq, ks, vq, vs = leaves
    reset_launch_counts()
    out = kv_attention(q, kq, ks, vq, vs)              # out_dtype=float32
    out16 = kv_attention(q, kq, ks, vq, vs, out_dtype=torch.bfloat16)
    assert launch_counts()["kv_attention"] == 2
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    check_attention_out(torch, out, kv_attention_ref(q, kq, ks, vq, vs), "kv_attention bf16 q -> f32")
    assert torch.equal(out.bfloat16(), out16), "f32 out cast to bf16 differs"
    # one shared ring offset against the same offset per slot
    shared = torch.tensor([S - 1], device=dev)
    mask = valid.clone()
    mask[:, S - 1] = True
    mine = [t.clone() for t in leaves]
    slot = [t.clone() for t in leaves]
    plain = [t.clone() for t in leaves]
    (o1, q1, s1), _ = fused_decode(q, *mine, kn[:, None], vn[:, None], shared,
                                   valid=mask, quantize_out=True)
    (o2, q2, s2), _ = fused_decode(q, *slot, kn[:, None], vn[:, None],
                                   shared.expand(B)[:, None], valid=mask,
                                   quantize_out=True)
    (o3, q3, s3), _ = fused_decode_ref(q, *plain, kn[:, None], vn[:, None], shared,
                                       valid=mask, quantize_out=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(q1, q2) and torch.equal(s1, s2)
    for a, b_, c in zip(mine, slot, plain):
        assert torch.equal(a, b_) and torch.equal(a, c), "shared idx: cache differs"
    check_fused_out(torch, o1, o3, q1, s1, q3, s3, "fused_decode shared idx")
    # bf16 q, float32 out, quantize-out (the fused W8A8 route's epilogue)
    mine = [t.clone() for t in leaves]
    plain = [t.clone() for t in leaves]
    (o1, q1, s1), _ = fused_decode(q, *mine, kn[:, None], vn[:, None], idx[:, None],
                                   valid=valid, out_dtype=torch.float32,
                                   quantize_out=True)
    (o3, q3, s3), _ = fused_decode_ref(q, *plain, kn[:, None], vn[:, None],
                                       idx[:, None], valid=valid,
                                       out_dtype=torch.float32, quantize_out=True)
    torch.cuda.synchronize()
    assert o1.dtype == torch.float32
    assert float(o1[3].abs().max()) == 0.0
    for a, c in zip(mine, plain):
        assert torch.equal(a, c), "bf16 q f32 out: cache differs"
    _, note = check_fused_out(torch, o1, o3, q1, s1, q3, s3,
                              "fused_decode bf16 q -> f32 quantize-out")
    for bits in (2, 4, 6):
        x = torch.randn((8, 896), generator=gen, device=dev) * 3
        got, want = quantize_act(x, bits=bits), quantize_act_ref(x, bits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), bits
    log(f"  Queue C on the card: kv_attention(bf16 q) -> float32 within "
        f"{OUT_TOL['float32']}, its bf16 cast = the bf16 kernel bit for bit; "
        f"fused_decode shared idx [1] = per-slot bit for bit, cache = plain; "
        f"fused_decode bf16 q -> float32 + quantize-out: {note}; quantize_act "
        f"bits 2/4/6 bit-equal")


# every K x N of the serving path: wq and wo, wk and wv, wg and wu, wd
PATH_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896))


def near_ties(torch, gen, dev, n):
    """n values k/2 + within 1e-5 relative of it, |k/2| < 127: at scale 1
    some lie inside quantize16's 2^-13 band around a half-integer (the
    IEEE division decides them) and some outside (the reciprocal's integer
    must be the division's)."""
    k = torch.randint(-253, 254, (n,), generator=gen, device=dev).float() / 2
    return k * (1 + (torch.rand((n,), generator=gen, device=dev) - 0.5) * 2e-5)


def _qin_input(torch, gen, dev, M, K, dtype):
    """x [M, K] for the quantize-in GEMM: randn * 3; row 0 holds .5 ties
    (0.5, 1.5, -2.5, 2.5, -0.5) and its only large value, 127 (so its
    scale is exactly 1), in its last element — the last split's K range,
    which only the cluster's max carries to the other splits; row 1 all
    zero (the 1e-8 floor); row 2 near-ties at scale 1 (its max, 127, in
    its first element)."""
    x = torch.randn((M, K), generator=gen, device=dev) * 3
    x[0, :5] = torch.tensor([0.5, 1.5, -2.5, 2.5, -0.5])
    x[0, K - 1] = 127.0
    if M > 1:
        x[1] = 0.0
    if M > 2:
        x[2] = near_ties(torch, gen, dev, K)
        x[2, 0] = 127.0
    return x.to(dtype)


def check_qmatmul_w8a8_qin(torch, dev, gen):
    """The quantize-in W8A8 GEMM (quantize_act folded into the GEMM, one
    launch) bit-equal to the pair of the port's own kernels
    (``quantize_act_cuda`` then ``qmatmul_w8a8_cuda``) and to the plain
    version, and the quantized x it hands out bit-equal to quantize_act's:
    every path K x N and a ragged K (K % 16 != 0: the element-wise
    loaders; K = 4100 split), the decode tile's M in {1, 8, 16} (ragged
    5, 8, 13), bf16 and f32 x, bf16 and f32 out, at every split the
    planner allows (forced by ``_splits``; splits whose int8 slice does
    not fit are refused by the wrapper, and counted). A 64-row tile (M in
    {64, 256}; ragged 70), which the plan never folds, is refused. Timed at
    the path shapes on the bf16 x it checked (bf16 out): the fold, the
    pair (timed together), the GEMM alone on pre-quantized A,
    ``torch._int_mm`` on that A (M padded to 32), beside the bound (W
    bytes + A bytes in x's type + out)."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_qin_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    cases = [(K, N, (1, 8, 16), (64, 256)) for K, N in PATH_KN]
    cases += [(900, 130, (5, 8, 13), (70,)), (4100, 70, (5, 8, 13), (70,))]
    rows, checked, refused, tiles_refused = [], 0, 0, 0
    for K, N, Ms, wide in cases:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in wide:
            assert not gemm_plan.plan(M, N, K).fold
            try:
                qmatmul_w8a8_qin_cuda(_qin_input(torch, gen, dev, M, K,
                                                 torch.bfloat16), w, sw, bias)
            except ValueError as e:
                assert "decode tile" in str(e), e
                tiles_refused += 1
            else:
                raise AssertionError(f"qmatmul_w8a8_qin M={M} K={K} N={N}: "
                                     f"a {gemm_plan.plan(M, N, K).bm}-row "
                                     f"tile launched")
        for M in Ms:
            p = gemm_plan.plan(M, N, K)
            assert p.fold, f"M={M} K={K} N={N}: the plan does not fold"
            top = gemm_plan.max_splits(p.k_steps)
            for xdt in (torch.bfloat16, torch.float32):
                x = _qin_input(torch, gen, dev, M, K, xdt)
                if xdt == torch.bfloat16:
                    x_timed = x  # checked below, then timed
                a_q, a_s = quantize_act_cuda(x)
                for od in (torch.bfloat16, torch.float32):
                    what = (f"qmatmul_w8a8_qin M={M} K={K} N={N} "
                            f"{str(xdt)[6:]} -> {str(od)[6:]}")
                    pair = qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias, out_dtype=od)
                    plain = qmatmul_w8a8_qin_ref(x, w, sw, bias, od)
                    torch.cuda.synchronize()
                    assert torch.equal(pair, plain), f"{what}: pair != plain"
                    for S in range(1, top + 1):
                        if not gemm_plan.plan(M, N, K, splits=S).fold:
                            refused += 1
                            continue
                        y, xq, xs = qmatmul_w8a8_qin_cuda(
                            x, w, sw, bias, out_dtype=od, quantized=True,
                            _splits=S)
                        torch.cuda.synchronize()
                        assert torch.equal(y, pair), (
                            f"{what} S={S}: not bit-equal to quantize_act + "
                            f"qmatmul_w8a8 ({int((y != pair).sum())} values, "
                            f"max |diff| "
                            f"{float((y.float() - pair.float()).abs().max())})")
                        assert torch.equal(xq, a_q) and torch.equal(xs, a_s), (
                            f"{what} S={S}: the quantized x it hands out is "
                            f"not quantize_act's")
                        assert bool(torch.isfinite(y).all()), f"{what} S={S}"
                        checked += 1
            if (K, N) not in PATH_KN:
                continue
            x = x_timed
            a_q, a_s = quantize_act_cuda(x)
            fold = lambda: qmatmul_w8a8_qin_cuda(x, w, sw, bias,
                                                 out_dtype=torch.bfloat16)

            def pair():
                aq, asc = quantize_act_cuda(x)
                return qmatmul_w8a8_cuda(aq, w, asc, sw, bias,
                                         out_dtype=torch.bfloat16)

            gemm = lambda: qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias,
                                             out_dtype=torch.bfloat16)
            a_lib = torch.cat([a_q, a_q.new_zeros((32 - M, K))])
            b, by = bound_ms(K * N + 2 * M * K + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            err = float((fold().float() - pair().float()).abs().max())
            assert err == 0.0, f"M={M} K={K} N={N}: the timed fold is off the pair by {err}"
            row = {
                "shape": f"M={M} K={K} N={N} bf16 -> bf16", "mkn": [M, K, N],
                "max_abs_err": err, "splits": p.splits, "share": p.share,
                "ms": device_ms(fold, 50), "call_ms": call_ms(fold, 50),
                "pair_ms": device_ms(pair, 50), "gemm_ms": device_ms(gemm, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_qin_ref(
                    x, w, sw, bias, torch.bfloat16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lambda: torch._int_mm(a_lib, w), 50),
                "library": (f"torch._int_mm on quantize_act's A, M "
                            f"zero-padded {M}->32")}
            if M == 8:
                # each call's weight from HBM, as on the serving path

                def pair_on(wc):
                    aq, asc = quantize_act_cuda(x)
                    return qmatmul_w8a8_cuda(aq, wc, asc, sw, bias,
                                             out_dtype=torch.bfloat16)

                row["cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_qin_cuda(
                    x, wc, sw, bias, out_dtype=torch.bfloat16), w)
                row["pair_cold_ms"] = cold_ms(torch, pair_on, w)
                row["gemm_cold_ms"] = cold_ms(torch, lambda wc: qmatmul_w8a8_cuda(
                    a_q, wc, a_s, sw, bias, out_dtype=torch.bfloat16), w)
            rows.append(row)
    log(f"  qmatmul_w8a8_qin: {checked} results (path K x N and ragged K, "
        f"M 1-16, bf16/f32 x, bf16/f32 out, every split that fits) bit-equal "
        f"to quantize_act + qmatmul_w8a8, with the quantized x they hand out "
        f"equal to quantize_act's, and the pair to the plain version; "
        f"{refused} forced splits refused (int8 slice over "
        f"{gemm_plan.QIN_SMEM_MAX} bytes); {tiles_refused} calls at M 64-256 "
        f"(64-row tiles) refused")
    for r in rows:
        log(f"  qmatmul_w8a8_qin {r['shape']:30s} fold {r['ms'] * 1e3:7.2f} us"
            f"  pair {r['pair_ms'] * 1e3:7.2f}  GEMM alone "
            f"{r['gemm_ms'] * 1e3:7.2f}  _int_mm {r['library_ms'] * 1e3:7.2f}"
            f"  bound {r['bound_ms'] * 1e3:6.3f}"
            + (f"  cold: fold {r['cold_ms'] * 1e3:.2f}, pair "
               f"{r['pair_cold_ms'] * 1e3:.2f}, GEMM alone "
               f"{r['gemm_cold_ms'] * 1e3:.2f}" if "cold_ms" in r else "")
            + f"  (S={r['splits']}, share {r['share']})")
    return rows


# the quantize-out GEMMs' shapes: every path K x N at a decode step and a
# prefill chunk, then qwen2's vocabulary at a decode step (9,496 N tiles:
# more than the card keeps resident, so the workspace route)
Q8_PATH = [(M, K, N) for K, N in PATH_KN for M in (8, 256)]
Q8_VOCAB = (8, 896, 151936)
# the shapes where each q8 kernel also runs at bits 4 and under the forced
# workspace route (one decode, one prefill)
Q8_BITS_SHAPES = ((8, 896, 4864), (256, 896, 4864))


def check_q8(torch, what, plan, kern, pair, gemm, plain, equal, w, big):
    """One quantize-out GEMM at one shape: ``kern(bits, route, w)`` (route
    None: the plan's) against ``pair(bits, w)`` (the port's GEMM to float32,
    then quantize_act) and ``plain(bits)`` by ``equal(q8, pair, plain,
    bits)``, which asserts and returns the largest payload step off the
    plain version; two calls of each route bit-equal. At ``Q8_BITS_SHAPES``
    also bits 4, and the workspace route forced (bits 4 and 8). Returns the
    row: the plan's route and tickets, the kernel, the pair and the GEMM
    alone (``gemm(w)``) timed warm and, at M = 8, cold; the forced
    workspace route's time where it ran, and where the plan takes the
    workspace route but an M tile's N tiles fit the card, the resident route
    by ticket (forced), checked and timed."""
    def twice(bits, route):
        first, second = kern(bits, route, w), kern(bits, route, w)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]), (
            f"{what} bits={bits} route={route or plan.q8_route}: two calls "
            f"gave different bits")
        return first

    bits_shape = (plan.M, plan.K, plan.N) in Q8_BITS_SHAPES
    runs = [(8, None)]
    if bits_shape:
        runs += [(4, None), (8, "workspace"), (4, "workspace")]
    err = 0.0
    for bits, route in runs:
        err = max(err, equal(twice(bits, route), pair(bits, w), plain(bits), bits))
    iters = 10 if big else 50
    row = {"q8_route": plan.q8_route, "bm": plan.bm, "residency": plan.residency,
           "tickets": plan.tiles if plan.q8_ticketed else 0,
           "waiters": plan.q8_waiters,
           "max_abs_err": err,
           "ms": device_ms(lambda: kern(8, None, w), iters),
           "call_ms": call_ms(lambda: kern(8, None, w), iters),
           "stepwise_ms": device_ms(lambda: pair(8, w), iters),
           "gemm_ms": device_ms(lambda: gemm(w), iters),
           "plain_ms": device_ms(lambda: plain(8), 3 if big else 10)}
    if bits_shape:
        row["workspace_ms"] = device_ms(lambda: kern(8, "workspace", w), iters)
    if plan.q8_route == "workspace" and plan.n_tiles <= plan.residency:
        # the resident route by ticket, which the plan declines here
        equal(twice(8, "resident"), pair(8, w), plain(8), 8)
        row["resident_ms"] = device_ms(lambda: kern(8, "resident", w), iters)
    if plan.M == 8:
        # each call's weight from HBM, as a serving path would read it
        row["cold_ms"] = cold_ms(torch, lambda wc: kern(8, None, wc), w)
        row["stepwise_cold_ms"] = cold_ms(torch, lambda wc: pair(8, wc), w)
        row["gemm_cold_ms"] = cold_ms(torch, gemm, w)
    return row


def log_q8(name, r):
    log(f"  {name} {r['shape']:32s} {r['q8_route']:9s} bm {r['bm']:3d} residency "
        f"{r['residency']:4d} tickets {r['tickets']:5d} waiters {r['waiters']:4d}"
        f"  q8 {r['ms'] * 1e3:8.2f} us"
        f"  pair {r['stepwise_ms'] * 1e3:8.2f}  "
        f"GEMM alone {r['gemm_ms'] * 1e3:8.2f}"
        + (f"  forced workspace {r['workspace_ms'] * 1e3:.2f}"
           if "workspace_ms" in r else "")
        + (f"  forced resident (tickets) {r['resident_ms'] * 1e3:.2f}"
           if "resident_ms" in r else "")
        + (f"  cold: q8 {r['cold_ms'] * 1e3:.2f}, pair "
           f"{r['stepwise_cold_ms'] * 1e3:.2f}, GEMM alone "
           f"{r['gemm_cold_ms'] * 1e3:.2f}" if "cold_ms" in r else ""))


def check_qmatmul_w8a8_q8(torch, dev, gen):
    """qmatmul_w8a8 with the quantize-out epilogue, one launch: payload and
    scale bit-equal to the plain version and to the stepwise pair of the
    port's own kernels (the W8A8 GEMM to float32, then quantize_act), at
    every path shape, the JAX bench's 4096^3 and the vocabulary (the
    workspace route); at ``Q8_BITS_SHAPES`` also at bits 4 and on the
    forced workspace route; two calls bit-equal at each."""
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_q8_cuda,
        qmatmul_w8a8_q8_plan,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_q8_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    shapes = Q8_PATH + [(4096, 4096, 4096), Q8_VOCAB]  # 4096^3: the JAX bench's
    rows = []
    for M, K, N in shapes:
        what = f"qmatmul_w8a8 q8 M={M} K={K} N={N}"
        big = M * K * N > 1e10
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4

        def equal(got, pair_out, plain_out, bits):
            q, s = got
            for name, (qo, so) in (("the plain version", plain_out),
                                   ("the stepwise pair", pair_out)):
                assert torch.equal(q, qo) and torch.equal(s, so), (
                    f"{what} bits={bits}: not bit-equal to {name} "
                    f"({int((q != qo).sum())} payloads, "
                    f"{int((s != so).sum())} scales)")
            return 0.0

        row = check_q8(
            torch, what, qmatmul_w8a8_q8_plan(M, N, K, dev),
            lambda bits, route, wc: qmatmul_w8a8_q8_cuda(
                a, wc, sa, sw, bias, bits=bits, _route=route),
            lambda bits, wc: quantize_act_cuda(
                qmatmul_w8a8_cuda(a, wc, sa, sw, bias), bits),
            lambda wc: qmatmul_w8a8_cuda(a, wc, sa, sw, bias),
            lambda bits: qmatmul_w8a8_q8_ref(a, w, sa, sw, bias, bits),
            equal, w, big)
        b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + M * N + 4 * M,
                         2 * M * K * N, INT8_OPS_S)
        rows.append({"shape": f"M={M} K={K} N={N}", "mkn": [M, K, N], **row,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
        log_q8("qmatmul_w8a8_q8", rows[-1])
        del w
    log(f"  qmatmul_w8a8 q8 at {len(shapes)} shapes: payload and scale "
        f"bit-equal to the plain version and to the stepwise pair, two calls "
        f"bit-equal; bits 4 and the forced workspace route at "
        f"{len(Q8_BITS_SHAPES)} shapes")
    return rows


def check_qmatmul_w8a16_q8(torch, dev, gen):
    """qmatmul_w8a16 with the quantize-out epilogue, one launch. float32 a:
    payload and scale bit-equal to the stepwise pair of the port's own
    kernels (the W8A16 GEMM to float32, then quantize_act). bfloat16 a:
    against the plain version (float32 sums in another order), no payload
    more than one step apart (the count of one-step payloads printed), the
    scale within E/qmax + one float32 ulp, E the float32 ``W8A16_TOL``
    bound at the row's largest value. Shapes, bits and routes as the W8A8
    check, with the JAX bench's decode (M=8 K=N=8192) in place of 4096^3;
    two calls bit-equal at each."""
    from repro_torch.kernels.qmatmul_w8a16.kernel import (
        qmatmul_w8a16_cuda,
        qmatmul_w8a16_q8_cuda,
        qmatmul_w8a16_q8_plan,
    )
    from repro_torch.kernels.qmatmul_w8a16.ref import (
        qmatmul_w8a16_q8_ref,
        qmatmul_w8a16_ref,
    )
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    shapes = Q8_PATH + [(8, 8192, 8192), Q8_VOCAB]  # the JAX bench's decode
    rows, one_step = [], {}
    for M, K, N in shapes:
        w = _kmajor_int8(torch, gen, dev, K, N)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            what = f"qmatmul_w8a16 q8 M={M} K={K} N={N} {name}"
            a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            sw = (torch.rand((1,), generator=gen, device=dev) * 0.01
                  + 1e-4).to(dtype)
            bias = torch.randn((N,), generator=gen, device=dev).to(dtype)
            y32 = qmatmul_w8a16_ref(a, w, sw, bias, torch.float32)
            e_row = w8a16_tolerance(torch, a, w, sw, bias, y32).amax(1)
            del y32

            def equal(got, pair_out, plain_out, bits):
                q, s = got
                if dtype == torch.float32:
                    qp, sp = pair_out
                    assert torch.equal(q, qp) and torch.equal(s, sp), (
                        f"{what} bits={bits}: not bit-equal to the stepwise "
                        f"pair ({int((q != qp).sum())} payloads, "
                        f"{int((s != sp).sum())} scales)")
                qr, sr = plain_out
                steps = (q.int() - qr.int()).abs()
                s_tol = e_row / (2 ** (bits - 1) - 1) + sr * 2.0 ** -23
                assert int(steps.max()) <= 1, (
                    f"{what} bits={bits}: a payload {int(steps.max())} steps "
                    f"off the plain version")
                assert bool(((s - sr).abs() <= s_tol).all()), (
                    f"{what} bits={bits}: scale off the plain version by "
                    f"{float((s - sr).abs().max())} (bound "
                    f"{float(s_tol.min())})")
                if dtype == torch.bfloat16 and bits == 8:
                    one_step.setdefault((M, K, N), f"M={M} K={K} N={N}: "
                                        f"{int((steps > 0).sum())} of {q.numel()}")
                return float(steps.max())

            row = check_q8(
                torch, what, qmatmul_w8a16_q8_plan(M, N, K, dtype, dev),
                lambda bits, route, wc: qmatmul_w8a16_q8_cuda(
                    a, wc, sw, bias, bits=bits, _route=route),
                lambda bits, wc: quantize_act_cuda(
                    qmatmul_w8a16_cuda(a, wc, sw, bias), bits),
                lambda wc: qmatmul_w8a16_cuda(a, wc, sw, bias),
                lambda bits: qmatmul_w8a16_q8_ref(a, w, sw, bias, bits),
                equal, w, False)
            e = a.element_size()
            b, by = bound_ms(M * K * e + K * N + e + N * e + M * N + 4 * M,
                             2 * M * K * N,
                             BF16_OPS_S if dtype == torch.bfloat16
                             else F32_OPS_S)
            rows.append({"shape": f"M={M} K={K} N={N} {name}",
                         "mkn": [M, K, N], **row, "bound_ms": b,
                         "bound_by": by, "library_ms": None})
            log_q8("qmatmul_w8a16_q8", rows[-1])
        del w
    log(f"  qmatmul_w8a16 q8 at {len(shapes)} shapes: float32 a bit-equal to "
        f"the stepwise pair; bfloat16 a within one step and E/qmax of the "
        f"plain version; two calls bit-equal; bits 4 and the forced "
        f"workspace route at {len(Q8_BITS_SHAPES)} shapes; payloads one step "
        f"apart (bf16, bits 8): " + "; ".join(one_step.values()))
    return rows


def check_split_sweep(torch, dev, gen):
    """Both GEMMs at every path K x N under forced K splits (the wrappers'
    private ``_splits``): S in {1, 2, the plan's, the largest the planner
    allows}, M in {8, 64, 256} for W8A8 and {8, 256} for W8A16. W8A8
    bit-equal to its plain version in bfloat16 and float32; W8A16 within
    ``W8A16_TOL`` in bfloat16 and float32. At the plan's S and the largest,
    two calls of each GEMM and of each quantize-out variant give the same
    bits. Logs each S's device time (bfloat16 out): the planner's evidence."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import qmatmul_w8a8_ref
    from repro_torch.kernels.qmatmul_w8a16.kernel import (
        qmatmul_w8a16_cuda,
        qmatmul_w8a16_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    def same_twice(fn):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if isinstance(first, tuple):
            return all(torch.equal(x, y) for x, y in zip(first, second))
        return torch.equal(first, second)

    checked = 0
    for K, N in PATH_KN:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (8, 64, 256):
            p = gemm_plan.plan(M, N, K)
            top = gemm_plan.max_splits(p.k_steps)
            a_q = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                                dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            a16 = {dt: torch.randn((M, K), generator=gen, device=dev).to(dt)
                   for dt in (torch.bfloat16, torch.float32)}
            sw16 = {dt: (sw[:1] * 10).to(dt) for dt in a16}
            b16 = {dt: bias.to(dt) for dt in a16}
            times = []
            for S in sorted({1, min(2, top), p.splits, top}):
                what = f"M={M} K={K} N={N} S={S}"
                for od in (torch.bfloat16, torch.float32):
                    y = qmatmul_w8a8_cuda(a_q, w, sa, sw, bias, out_dtype=od,
                                          _splits=S)
                    yr = qmatmul_w8a8_ref(a_q, w, sa, sw, bias, od)
                    torch.cuda.synchronize()
                    assert torch.equal(y, yr), (
                        f"qmatmul_w8a8 {what} {od}: not bit-equal to the "
                        f"plain version ({int((y != yr).sum())} values)")
                    checked += 1
                t8 = device_ms(lambda: qmatmul_w8a8_cuda(
                    a_q, w, sa, sw, bias, out_dtype=torch.bfloat16,
                    _splits=S), 20)
                t16 = None
                if M != 64:
                    for dt, a in a16.items():
                        y = qmatmul_w8a16_cuda(a, w, sw16[dt], b16[dt],
                                               _splits=S)
                        yr = qmatmul_w8a16_ref(a, w, sw16[dt], b16[dt], dt)
                        torch.cuda.synchronize()
                        diff = (y.float() - yr.float()).abs()
                        tol = w8a16_tolerance(torch, a, w, sw16[dt], b16[dt], yr)
                        assert bool((diff <= tol).all()), (
                            f"qmatmul_w8a16 {what} {dt}: off the plain "
                            f"version at {int((diff > tol).sum())} values "
                            f"({W8A16_TOL[str(dt)[6:]]})")
                        checked += 1
                    t16 = device_ms(lambda: qmatmul_w8a16_cuda(
                        a16[torch.bfloat16], w, sw16[torch.bfloat16],
                        b16[torch.bfloat16], _splits=S), 20)
                if S in (p.splits, top):
                    runs = [lambda: qmatmul_w8a8_cuda(
                                a_q, w, sa, sw, bias, _splits=S),
                            lambda: qmatmul_w8a8_q8_cuda(
                                a_q, w, sa, sw, bias, _splits=S)]
                    if M != 64:
                        for dt, a in a16.items():
                            runs.append(lambda a=a, dt=dt: qmatmul_w8a16_cuda(
                                a, w, sw16[dt], b16[dt], _splits=S))
                            runs.append(lambda a=a, dt=dt: qmatmul_w8a16_q8_cuda(
                                a, w, sw16[dt], b16[dt], _splits=S))
                    for fn in runs:
                        assert same_twice(fn), (
                            f"{what}: two calls gave different bits")
                times.append(f"S={S}{'*' if S == p.splits else ''} "
                             f"{t8 * 1e3:.2f}" + ("" if t16 is None
                                                  else f" / {t16 * 1e3:.2f}"))
            log(f"  split sweep M={M} K={K} N={N} ({p.tiles} tiles, "
                f"{p.k_steps} K steps; * the plan's), us w8a8"
                + ("" if M == 64 else " / w8a16") + " bf16: "
                + ", ".join(times))
    log(f"  split sweep: {checked} W8A8 results bit-equal to the plain "
        f"version and W8A16 within {W8A16_TOL['float32']} (+1 bf16 ulp in "
        f"bf16); two calls of each GEMM and quantize-out variant at the "
        f"plan's and the largest S bit-equal")


# the serving path's projections a layer: (K, N) and how many of each —
# q and o, k and v, gate and up, down
LAYER_GEMMS = (((896, 896), 2), ((896, 128), 2), ((896, 4864), 2),
               ((4864, 896), 1))


def log_step_sums(tables):
    """One line with the device time of one decode step's GEMMs (24 layers x
    the seven projections at M = 8, warm and cold) and of one prefill
    chunk's (M = 256), each beside the bound's sum and, for W8A8,
    ``torch._int_mm``'s; two lines (GEMMs warm, cold) with the W8A8 decode
    step's GEMMs plus activation quantization on the fused route: the pair —
    quantize_act of the qkv, gate/up and down inputs and the seven int8
    GEMMs — against the fold — q, gate and down quantize-in GEMMs, and k, v,
    up (on the fold's quantized input) and wo (on fused_decode's
    quantize-out) int8 GEMMs."""
    def total(name, M, key, suffix=""):
        rows = {tuple(r["mkn"][1:]): r for r in tables[name]
                if r["mkn"][0] == M and r["shape"].endswith(suffix)}
        return 24 * sum(n * rows[kn][key] for kn, n in LAYER_GEMMS)

    qa = {r["shape"]: r["ms"] for r in tables["quantize_act"]}
    quant = 24 * (2 * qa["x[8,896] bfloat16"] + qa["x[8,4864] bfloat16"])
    def at(name, K, N, key):
        return next(r[key] for r in tables[name] if r["mkn"] == [8, K, N])

    for temp, key in (("warm", "ms"), ("cold", "cold_ms")):
        gemms = total("qmatmul_w8a8", 8, key)
        fold = 24 * sum(at("qmatmul_w8a8_qin", K, N, key)
                        for K, N in ((896, 896), (896, 4864), (4864, 896)))
        int8 = 24 * sum(at("qmatmul_w8a8", K, N, key) for K, N in
                        ((896, 128), (896, 128), (896, 896), (896, 4864)))
        log(f"  W8A8 device ms per decode step, GEMMs + activation "
            f"quantization (24 layers, M=8, GEMMs {temp}): pair "
            f"{gemms + quant:.4f} (GEMMs {gemms:.4f} + quantize_act 72 x = "
            f"{quant:.4f}); fold {fold + int8:.4f} (72 qmatmul_w8a8_qin "
            f"{fold:.4f} + 96 qmatmul_w8a8 {int8:.4f})")

    w16, w8 = "qmatmul_w8a16", "qmatmul_w8a8"
    log(f"  GEMM device ms per decode step (24 layers x 7 projections, M=8): "
        f"{w16} bf16 warm {total(w16, 8, 'ms', 'bfloat16'):.4f}, cold "
        f"{total(w16, 8, 'cold_ms', 'bfloat16'):.4f} (bound "
        f"{total(w16, 8, 'bound_ms', 'bfloat16'):.4f}); {w8} warm "
        f"{total(w8, 8, 'ms'):.4f}, cold {total(w8, 8, 'cold_ms'):.4f} (bound "
        f"{total(w8, 8, 'bound_ms'):.4f}; torch._int_mm, M padded to 32, warm "
        f"{total(w8, 8, 'library_ms'):.4f}, cold "
        f"{total(w8, 8, 'library_cold_ms'):.4f})")
    log(f"  GEMM device ms per prefill chunk (M=256): {w16} bf16 "
        f"{total(w16, 256, 'ms', 'bfloat16'):.4f} (bound "
        f"{total(w16, 256, 'bound_ms', 'bfloat16'):.4f}); {w8} "
        f"{total(w8, 256, 'ms'):.4f} (bound {total(w8, 256, 'bound_ms'):.4f}; "
        f"torch._int_mm {total(w8, 256, 'library_ms'):.4f})")


# the decode attention geometries of the four dense archs besides qwen2:
# (arch, Hq, Hkv, hd), each at B = 8 slots and S = 512 positions
NEW_ATTENTION = (("mistral-nemo-12b", 32, 8, 128), ("yi-34b", 56, 8, 128),
                 ("chameleon-34b", 64, 8, 128), ("gemma-7b", 16, 16, 256))


def check_new_attention(torch, dev, gen):
    """fused_decode (with its quantize-out) and kv_attention at the decode
    geometry of each new arch (``NEW_ATTENTION``), float32 and bfloat16,
    against their plain versions as at qwen2's shape: the appended cache
    bit-equal, ``out`` within ``OUT_TOL``, the quantize-out as
    ``check_fused_out`` holds it, a row of length 0 exactly 0; each
    geometry's plan (splits, shared memory a CTA) logged, and the bf16
    calls timed beside the plain versions, the bound and SDPA (logged in
    the rows' format; the kernels JSON line keeps qwen2's rows)."""
    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.fused_decode.ref import fused_decode_ref
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref

    B, S = 8, 512
    for arch, Hq, Hkv, hd in NEW_ATTENTION:
        plan = attention_plan.plan(B, S, Hq, Hkv, hd)
        log(f"  attention plan {arch} B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S}: "
            f"group {plan.group}, {plan.splits} splits, {plan.ctas} CTAs, "
            f"{plan.smem} bytes of shared memory a CTA")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lens[0], lens[B - 1] = S, 0
            leaves, valid, q, kn, vn, idx = _decode_inputs(
                torch, dev, gen, B, S, Hq, Hkv, hd, dtype, lens)
            idx32 = idx.to(torch.int32)
            fused = [t.clone() for t in leaves]
            out, oq, os_ = fused_decode_cuda(q, *fused, kn, vn, idx32, valid,
                                             quantize_out=True)
            ref = [t.clone() for t in leaves]
            (outr, oqr, osr), _ = fused_decode_ref(
                q, *ref, kn[:, None], vn[:, None], idx[:, None], valid=valid,
                out_dtype=dtype, quantize_out=True)
            torch.cuda.synchronize()
            what = f"fused_decode {arch} Hq={Hq} Hkv={Hkv} hd={hd} {name}"
            for a, b_, leaf in zip(fused, ref, ("k", "k_scale", "v",
                                                "v_scale")):
                assert torch.equal(a, b_), f"{what}: appended {leaf} differs"
            err, note = check_fused_out(torch, out, outr, oq, os_, oqr, osr,
                                        what)
            assert float(out[B - 1].float().abs().max()) == 0.0, (
                f"{what}: the row of length 0 is not 0")
            log(f"  {what}: out max |diff| {err:.3g} ({OUT_TOL[name]}); "
                f"{note}; appended leaves bit-equal")
            # the unfused kernel over the appended cache, the stepwise
            # route's masking (the scales zero where a position is dead)
            live = valid[..., None]
            kq, ks, vq, vs = fused
            ks, vs = ks * live, vs * live
            kv = kv_attention_cuda(q, kq, ks, vq, vs, None)
            kvr = kv_attention_ref(q, kq, ks, vq, vs, dtype)
            torch.cuda.synchronize()
            kwhat = f"kv_attention {arch} Hq={Hq} Hkv={Hkv} hd={hd} {name}"
            diff, past = check_attention_out(torch, kv, kvr, kwhat)
            assert float(kv[B - 1].float().abs().max()) == 0.0
            log(f"  {kwhat}: max |diff| {float(diff.max()):.3g} "
                f"({OUT_TOL[name]}){past}")
            if dtype != torch.bfloat16:
                continue
            n_live = int(valid.sum())
            e = q.element_size()
            shape = f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} {name} ({arch})"
            run = [t.clone() for t in leaves]
            fb, fby = bound_ms(
                2 * B * Hq * hd * e + n_live * Hkv * (hd + 4) * 2 + B * S
                + 2 * B * Hkv * hd * (e + 1) + 8 * B * Hkv + B * Hq * hd
                + 4 * B, 4 * Hq * n_live * hd, F32_OPS_S)
            kern = lambda: fused_decode_cuda(q, *run, kn, vn, idx32, valid,
                                             quantize_out=True)
            log_row("fused_decode", {
                "shape": shape, "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: fused_decode_ref(
                    q, *run, kn[:, None], vn[:, None], idx[:, None],
                    valid=valid, out_dtype=dtype, quantize_out=True), 5),
                "bound_ms": fb, "bound_by": fby, "library_ms": None,
                "no_q8_ms": device_ms(lambda: fused_decode_cuda(
                    q, *run, kn, vn, idx32, valid), 50),
                "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
                "splits": plan.splits})
            kb, kby = bound_ms(2 * B * Hq * hd * e + B * S * Hkv * 4
                               + n_live * Hkv * (2 * hd + 4),
                               4 * Hq * n_live * hd, F32_OPS_S)
            kern = lambda: kv_attention_cuda(q, kq, ks, vq, vs, None)
            log_row("kv_attention", {
                "shape": shape, "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: kv_attention_ref(
                    q, kq, ks, vq, vs, dtype), 5),
                "bound_ms": kb, "bound_by": kby, "library_ms": None,
                "sdpa_ms": sdpa_ms(torch, dev, gen, B, S, Hq, Hkv, hd, 50),
                "splits": plan.splits})


# mistral-nemo-12b's decode projections (K, N) and gemma-7b's down
# projection, the longest K of the new archs
NEW_GEMMS = (("nemo q", 5120, 4096), ("nemo k/v", 5120, 1024),
             ("nemo o", 4096, 5120), ("nemo gate/up", 5120, 14336),
             ("nemo down", 14336, 5120), ("gemma down", 24576, 3072))


def check_new_gemms(torch, dev, gen):
    """The three GEMMs of the W8A16 and W8A8 paths at ``NEW_GEMMS``, M = 8
    (a decode step of 8 slots) and 256 (a prefill chunk): qmatmul_w8a8
    bit-equal to its plain version (bf16 out), qmatmul_w8a16 (bf16) within
    ``W8A16_TOL``, and qmatmul_w8a8_qin bit-equal to quantize_act +
    qmatmul_w8a8 (and its int8 x to quantize_act's) where ``gemm_plan``
    folds, refused with the plan's reason where it does not (the model
    then takes the pair). Each logged with its plan and timed in the rows'
    format beside its plain version, the library call and the bound."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_qin_ref,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_cuda
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    bf16 = torch.bfloat16
    has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    folded, refused = 0, 0
    for label, K, N in NEW_GEMMS:
        w = _kmajor_int8(torch, gen, dev, K, N)
        sw = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev)
        for M in (8, 256):
            p = gemm_plan.plan(M, N, K)
            shape = f"M={M} K={K} N={N} ({label})"
            log(f"  gemm plan {shape}: {p.bm}-row tiles, {p.splits} K "
                f"split(s), {p.ctas} CTAs, quantize-in "
                + ("folds" if p.fold else
                   f"refused ({p.bm}-row tile)" if p.bm not in
                   gemm_plan.FOLD_BM else
                   f"refused ({p.qin_smem} bytes of shared memory > "
                   f"{gemm_plan.QIN_SMEM_MAX})"))
            # W8A8 (the int8 GEMM on a quantized activation)
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            sa = torch.rand((M,), generator=gen, device=dev) * 0.05 + 1e-4
            y = qmatmul_w8a8_cuda(a, w, sa, sw, bias, out_dtype=bf16)
            yr = qmatmul_w8a8_ref(a, w, sa, sw, bias, bf16)
            torch.cuda.synchronize()
            assert torch.equal(y, yr), f"qmatmul_w8a8 {shape}: not bit-equal"
            a_lib = a if M > 16 else torch.cat([a, a.new_zeros((32 - M, K))])
            b, by = bound_ms(M * K + K * N + 4 * M + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_cuda(a, w, sa, sw, bias,
                                             out_dtype=bf16)
            log_row("qmatmul_w8a8", {
                "shape": shape + " -> bf16", "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_ref(
                    a, w, sa, sw, bias, bf16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lambda: torch._int_mm(a_lib, w), 50),
                "library": "torch._int_mm" + ("" if M > 16 else
                                              f", M zero-padded {M}->32")})
            # W8A16 (bf16 activation, per-tensor bf16 scale, as the path)
            x = torch.randn((M, K), generator=gen, device=dev).to(bf16)
            s1 = (torch.rand((1,), generator=gen, device=dev) * 0.01
                  + 1e-4).to(bf16)
            b16 = bias.to(bf16)
            y = qmatmul_w8a16_cuda(x, w, s1, b16)
            yr = qmatmul_w8a16_ref(x, w, s1, b16, bf16)
            torch.cuda.synchronize()
            diff = (y.float() - yr.float()).abs()
            tol = w8a16_tolerance(torch, x, w, s1, b16, yr)
            assert bool((diff <= tol).all()), (
                f"qmatmul_w8a16 {shape}: off the plain version at "
                f"{int((diff > tol).sum())} values ({W8A16_TOL['bfloat16']})")
            b, by = bound_ms(M * K * 2 + K * N + 2 + N * 2 + M * N * 2,
                             2 * M * K * N, BF16_OPS_S)
            if has_lib:
                wt, s_n = w.t(), s1.expand(N).contiguous()
                lib_fn = lambda: torch._weight_int8pack_mm(x, wt, s_n)
                lib_call = "torch._weight_int8pack_mm"
            else:
                w_deq_t = (w.float() * s1.float()).to(bf16).t().contiguous()
                lib_fn = lambda: torch.nn.functional.linear(x, w_deq_t, b16)
                lib_call = "F.linear on the pre-dequantized weight"
            kern = lambda: qmatmul_w8a16_cuda(x, w, s1, b16)
            log_row("qmatmul_w8a16", {
                "shape": shape + " bfloat16", "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a16_ref(
                    x, w, s1, b16, bf16), 10),
                "bound_ms": b, "bound_by": by,
                "library_ms": device_ms(lib_fn, 50), "library": lib_call})
            log(f"  qmatmul_w8a16 {shape} bfloat16: max |diff| "
                f"{float(diff.max()):.3g}, max |diff|/tol "
                f"{float((diff / tol).max()):.3g} ({W8A16_TOL['bfloat16']})")
            # W8A8 quantize-in (the fold), or the plan's refusal
            xq = _qin_input(torch, gen, dev, M, K, bf16)
            if not p.fold:
                try:
                    qmatmul_w8a8_qin_cuda(xq, w, sw, bias, out_dtype=bf16)
                except ValueError as e:
                    refused += 1
                    log(f"  qmatmul_w8a8_qin {shape}: refused by the plan "
                        f"({str(e)[:120]}...); the model takes quantize_act "
                        f"+ qmatmul_w8a8")
                    continue
                raise AssertionError(f"qmatmul_w8a8_qin {shape}: launched "
                                     f"where the plan does not fold")
            a_q, a_s = quantize_act_cuda(xq)
            pair = qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias, out_dtype=bf16)
            y, x_q, x_s = qmatmul_w8a8_qin_cuda(xq, w, sw, bias,
                                                out_dtype=bf16,
                                                quantized=True)
            torch.cuda.synchronize()
            assert torch.equal(y, pair), (
                f"qmatmul_w8a8_qin {shape}: not bit-equal to quantize_act + "
                f"qmatmul_w8a8")
            assert torch.equal(x_q, a_q) and torch.equal(x_s, a_s)
            folded += 1
            b, by = bound_ms(M * K * 2 + K * N + 8 * N + 2 * M * N,
                             2 * M * K * N, INT8_OPS_S)
            kern = lambda: qmatmul_w8a8_qin_cuda(xq, w, sw, bias,
                                                 out_dtype=bf16)

            def pair_call():
                q_, s_ = quantize_act_cuda(xq)
                return qmatmul_w8a8_cuda(q_, w, s_, sw, bias, out_dtype=bf16)

            log_row("qmatmul_w8a8_qin", {
                "shape": shape + " bf16 -> bf16", "ms": device_ms(kern, 50),
                "call_ms": call_ms(kern, 50),
                "plain_ms": device_ms(lambda: qmatmul_w8a8_qin_ref(
                    xq, w, sw, bias, bf16), 10),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "stepwise_ms": device_ms(pair_call, 50)})
    log(f"  the new shapes: qmatmul_w8a8_qin folded and bit-equal at {folded}, "
        f"refused by the plan at {refused}")


# --------------------------------------------------------------- phase 3
def hostile_params(torch, model, device="cpu"):
    """Seeded weights that give every rewrite work: log-normal norm gains,
    random q/k/v/o biases, and the MLP's hidden channels spread over two
    decades each way (up times s, down divided by s: the same function).
    Drawn on ``device`` from a generator there: the smoke model's on the
    CPU (the card's quantize moves them), the full-width one's on the
    card."""
    gen = torch.Generator(device=device).manual_seed(2)
    params = model.init(0, device=device)
    blocks, mlp = params["blocks"], params["blocks"]["mlp"]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    for norm in ("attn_norm", "mlp_norm"):
        blocks[norm]["w"] = torch.exp(randn(blocks[norm]["w"].shape) * 0.5)
    for k in ("bq", "bk", "bv", "bo"):
        blocks["attn"][k] = randn(blocks["attn"][k].shape) * 0.5
    L, _, F = mlp["wu"].shape
    s = torch.exp(randn((L, F)) * 2.3)
    mlp["wu"] = mlp["wu"] * s[:, None, :]
    mlp["wd"] = mlp["wd"] / s[:, :, None]
    return params


def _leaves(tree, path=()):
    from repro_torch.quantized import QTensor

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, QTensor):
        yield path + ("q",), tree.q
        yield path + ("scale",), tree.scale
    else:
        yield path, tree


# the bias-corrected int8 deployment: the serve-w8a8-kv8 stages with the
# paper's weight bias correction before the pack (whose symmetric int8
# quantizer ε then targets)
BC_DEPLOY = ["fold_norm", "cle", "bias_absorb", "bias_correct",
             ("pack", {"mode": "w8a8"}), ("kv_cache", {"bits": 8})]
# E[x] of the card's calibration forward against the CPU's, per stat key:
# within STAT_TOL · max |E[x]| (tests/test_torch_bias_correction.py's bound
# for the port against the JAX package: two float32 forwards summing in
# other orders)
STAT_TOL = 2.0 ** -16


def recipe_label(recipe) -> str:
    return recipe if isinstance(recipe, str) else "bias-corrected w8a8"


def recording(calibrate, into):
    """``calibrate`` that also keeps the E[x] it returned in ``into``."""
    def hook(params):
        into.update(calibrate(params))
        return into
    return hook


def correction_bounds(torch, model, params, recipe, e_cpu, e_card):
    """{bias path: bound} of a recipe's bias correction, card against CPU:
    |δ| @ |ε| + 2·D·2^-24·(|E[x]| @ |ε|), δ the gap between the two sides'
    E[x] and ε the quantization error of the equalized weights under the
    spec the recipe's bias_correct used (plus one ulp of |b|, added by the
    caller)."""
    import repro_torch
    from repro_torch.core import DFQConfig, weight_quant_error
    from repro_torch.core.tree import get_path
    from repro_torch.pipeline.api import _fold_weight_spec_overrides
    from repro_torch.pipeline.recipes import resolve_recipe

    r = resolve_recipe(recipe)
    stages = r.stage_names()
    spec = _fold_weight_spec_overrides(r, DFQConfig()).weight_spec
    eq = repro_torch.quantize(model, params, calibration=None, device="cpu",
                              recipe=list(r.steps[:stages.index("bias_correct")])
                              ).params
    out = {}
    for site in model.dfq_plan().sites:
        eps = weight_quant_error(get_path(eq, site.w), spec).abs().double()
        e = e_cpu[site.stat_key].double()
        delta = (e_card[site.stat_key].cpu().double() - e).abs()
        D = eps.shape[-2]
        out[site.b] = (torch.einsum("...i,...io->...o", delta, eps)
                       + 2 * D * 2.0 ** -24
                       * torch.einsum("...i,...io->...o", e.abs(), eps))
    return out


def check_dfq_on_card(torch, dev, model, params, recipe):
    """``repro_torch.quantize`` on the card against the same call on the
    CPU, on the same calibration tokens (drawn on the host): every int8
    payload, scale and weight leaf bit-equal, since quantization reads the
    weights only; E[x] within ``STAT_TOL``; a bias the recipe corrected
    within ``correction_bounds`` plus one float32 ulp; ``bo``'s value-bias
    shift, a matrix product summed in another order, within that product's
    rounding bound n · 2^-23 · (|c| @ |wo|) (added to its correction's,
    where the recipe absorbs); the stage records equal and the per-site
    SQNR within 1e-4 dB. Returns (CPU, card) QuantizedModels."""
    import repro_torch
    from repro_torch.pipeline import default_calibration
    from repro_torch.pipeline.recipes import resolve_recipe

    cfg = model.cfg
    e_cpu, e_card = {}, {}
    hook = default_calibration(model, cfg)
    cpu = repro_torch.quantize(model, params, recipe=recipe, device="cpu",
                               calibration=recording(hook, e_cpu))
    card = repro_torch.quantize(model, params, recipe=recipe, device=dev,
                                calibration=recording(hook, e_card))
    name = recipe_label(recipe)
    stages = resolve_recipe(recipe).stage_names()
    tol = {}
    if "bias_absorb" in stages:
        attn = repro_torch.quantize(model, params, recipe=["fold_norm", "cle"],
                                    device="cpu").params["blocks"]["attn"]
        group = cfg.n_heads // cfg.n_kv_heads
        L = attn["bv"].shape[0]
        c = attn["bv"].reshape(L, cfg.n_kv_heads, 1, cfg.head_dim).expand(
            L, cfg.n_kv_heads, group, cfg.head_dim).reshape(L, -1)
        tol[("blocks", "attn", "bo")] = c.shape[-1] * 2.0 ** -23 * torch.einsum(
            "ln,lno->lo", c.abs(), attn["wo"].abs()).double()
    stat_err = 0.0
    if "bias_correct" in stages:
        assert sorted(e_cpu) == sorted(e_card) and e_cpu, name
        for k, e in e_cpu.items():
            err = float((e_card[k].cpu() - e).abs().max())
            assert err <= STAT_TOL * float(e.abs().max()), (
                f"{name}: E[x] {k} on the card off the CPU's by {err}")
            stat_err = max(stat_err, err / float(e.abs().max()))
        for path, b in correction_bounds(torch, model, params, recipe, e_cpu,
                                         e_card).items():
            tol[path] = tol.get(path, 0) + b
    want, got = dict(_leaves(cpu.params)), dict(_leaves(card.params))
    assert sorted(want) == sorted(got), f"{name}: card tree differs"
    worst = {}
    for path, t in want.items():
        g = got[path].cpu()
        assert g.dtype == t.dtype and g.shape == t.shape, path
        if path in tol:
            diff = (g - t).abs().double()
            ulp = (torch.nextafter(torch.maximum(t.abs(), g.abs()),
                                   torch.tensor(float("inf"))) - t.abs()
                   ).abs().double()
            assert bool((diff <= tol[path] + ulp).all()), (
                f"{name}: {'/'.join(path)} on the card off the CPU's by "
                f"{float(diff.max())}")
            worst[path[-1]] = float(diff.max())
        else:
            assert torch.equal(g, t), (
                f"{name}: {'/'.join(path)} on the card differs from the "
                f"CPU's at {int((g != t).sum())} of {t.numel()}")
    snr = {}
    for rc, rg in zip(cpu.report, card.report):
        mc, mg = dict(rc["metrics"]), dict(rg["metrics"])
        assert rc["stage"] == rg["stage"], name
        sc, sg = mc.pop("sqnr_db", {}), mg.pop("sqnr_db", {})
        for k in ("sqnr_min_db", "sqnr_mean_db"):
            if k in mc:
                snr[k] = abs(mc.pop(k) - mg.pop(k))
        assert mc == mg, f"{name}: stage {rc['stage']} records differ"
        assert sorted(sc) == sorted(sg), name
        snr.update({k: abs(sc[k] - sg[k]) for k in sc})
    assert max(snr.values()) <= 1e-4, f"{name}: per-site SQNR differs"
    log(f"  {name} on the card vs the CPU (smoke, weights that need every "
        f"rewrite): {len(want) - len(worst)} leaves bit-equal, "
        + (f"E[x] max |diff| {stat_err:.3g} of max |E[x]|, " if stat_err else "")
        + ("bounded max |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in sorted(worst.items())) + ", "
           if worst else "")
        + f"stage records equal, per-site SQNR max |diff| "
        f"{max(snr.values()):.3g} dB")
    return cpu, card


def check_reference(torch, dev, recipe, kv_bits=8):
    """Smoke-size qwen2 under ``recipe``: DFQ on the card against DFQ on
    the CPU, then the model on the card (kernels) against the CPU (plain
    versions), over the int8 KV cache (``kv_bits`` 8) or the fp one."""
    import repro_torch

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    cpu, card = check_dfq_on_card(torch, dev, model,
                                  hostile_params(torch, model), recipe)
    teacher_forced(torch, dev, model.cfg, cpu.params, card.params, kv_bits,
                   f"smoke qwen2 (2 layers, f32) under "
                   f"{recipe_label(recipe)}")


def teacher_forced(torch, dev, cfg, cpu_params, card_params, kv_bits, what):
    """The model at ``cfg`` on the card (kernels) against the CPU (plain
    versions), over the int8 KV cache (``kv_bits`` 8) or the fp one: prefill
    8 tokens, then 16 teacher-forced decode steps, every step's logits
    within 5 % of the largest |logit| and greedy agreement at least 0.9."""
    import repro_torch

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
    out = {}
    for name, d, p in (("cpu", "cpu", cpu_params), ("cuda", dev, card_params)):
        m = repro_torch.build_model(cfg)
        cache = m.init_cache(4, 32, device=d, kv_bits=kv_bits)
        lg, cache = m.prefill(p, toks[:, :8].to(d), cache)
        steps = [lg]
        for t in range(8, 24):
            lg, cache = m.decode_step(p, toks[:, t:t + 1].to(d), cache)
            steps.append(lg)
        out[name] = torch.stack(steps).float().cpu()
    diff = float((out["cpu"] - out["cuda"]).abs().max())
    scale = float(out["cpu"].abs().max())
    agree = float((out["cpu"].argmax(-1) == out["cuda"].argmax(-1)).float().mean())
    log(f"  {what}, {'int8' if kv_bits == 8 else 'fp'} KV cache, card vs "
        f"CPU plain versions, prefill 8 + 16 teacher-forced decode steps: "
        f"max |logit diff| {diff:.3g} (max |logit| {scale:.3g}), greedy "
        f"agreement {agree:.3f}")
    assert all(torch.isfinite(v).all() for v in out.values())
    assert diff <= 0.05 * scale and agree >= 0.9, "card and CPU disagree"


def check_hostile_gate(torch, dev):
    """``tests/test_dfq_integration.py``'s gate, on the card: on the hostile
    smoke weights per-tensor INT8 (naive-int8) collapses and dfq-int8
    recovers — logits SQNR above naive-int8's by 10 dB, greedy agreement
    with fp above 0.9, on synthetic tokens of another seed than the
    calibration's."""
    import repro_torch
    from repro_torch.core import sqnr_db
    from repro_torch.data import calibration_tokens

    from repro_torch.quantized import map_leaves

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    params = hostile_params(torch, model)
    toks = calibration_tokens(0, 2, 16, model.cfg.vocab_size, device=dev)
    y_fp = model.apply(map_leaves(lambda t: t.to(dev), params), toks)
    snr, agree = {}, {}
    for recipe in ("naive-int8", "dfq-int8"):
        y = model.apply(repro_torch.quantize(model, params, recipe=recipe,
                                             device=dev).params, toks)
        snr[recipe] = float(sqnr_db(y_fp, y))
        agree[recipe] = float((y.argmax(-1) == y_fp.argmax(-1)).float().mean())
    log(f"  hostile smoke gate on the card: logits SQNR naive-int8 "
        f"{snr['naive-int8']:.2f} dB, dfq-int8 {snr['dfq-int8']:.2f} dB; "
        f"greedy agreement with fp {agree['naive-int8']:.3f} / "
        f"{agree['dfq-int8']:.3f}")
    assert snr["dfq-int8"] > snr["naive-int8"] + 10.0, snr
    assert agree["dfq-int8"] > 0.9, agree


# the serving run of phase 4: qwen2-0.5b at full width, 8 slots, 16 requests
SERVE = dict(arch="qwen2-0.5b", seed=0, device="cuda", slots=8, max_len=512,
             prefill_chunk=32, trace=16, trace_seed=0, prompt_min=32,
             prompt_len=256, gen_min=32, gen_len=32)


def layer_inputs(cfg):
    """The inputs of a layer's projections, each (K, the N of every
    projection reading it): qkv, wo, gate/up (up alone without a gate),
    down."""
    D, F, A, KV = cfg.d_model, cfg.d_ff, cfg.attn_dim, cfg.kv_dim
    return ((D, (A, KV, KV)), (A, (D,)),
            (D, (F, F) if cfg.act.endswith("_glu") else (F,)), (F, (D,)))


def expected_launches(quantize, fused, steps, chunks, *, cfg=None,
                      kv_bits=8, slots=None, chunk=None):
    """{kernel: launches} of one serve run: per decode step (M = slots) and
    per prefill chunk (M = slots x chunk), every layer's projections
    (``layer_inputs``; ``cfg`` defaults to qwen2-0.5b's, the slots and
    chunk to ``SERVE``'s). Over the int8 cache (``kv_bits`` 8) the fused
    decode once a layer per decode step, or kv_attention on the unfused
    route; over the fp cache no attention kernel (plain maths, as in the
    reference). W8A16: one qmatmul_w8a16 a projection. W8A8, as
    ``gemm_plan`` says for each input of a layer: where the plan folds for
    every projection reading it, the first is one qmatmul_w8a8_qin, which
    hands its quantized input to the others (an int8 GEMM each);
    elsewhere one quantize_act and an int8 GEMM each; except wo at a fused
    decode step, an int8 GEMM on the fused kernel's quantize-out.
    ``quantize="none"``: no GEMM kernel."""
    import repro_torch
    from repro_torch.kernels import gemm_plan

    cfg = cfg or repro_torch.get_config(SERVE["arch"])
    slots = slots or SERVE["slots"]
    chunk = chunk or SERVE["prefill_chunk"]
    L = cfg.n_layers
    inputs = layer_inputs(cfg)
    want = {}
    if kv_bits == 8:
        want["fused_decode" if fused else "kv_attention"] = L * steps
    if quantize == "w8a16":
        want["qmatmul_w8a16"] = (sum(len(Ns) for _, Ns in inputs) * L
                                 * (steps + chunks))
    if quantize != "w8a8":
        return want
    want.update(quantize_act=0, qmatmul_w8a8=0, qmatmul_w8a8_qin=0)
    for M, n, decode in ((slots, steps, True), (slots * chunk, chunks, False)):
        for i, (K, Ns) in enumerate(inputs):
            if decode and i == 1 and kv_bits == 8 and fused:
                want["qmatmul_w8a8"] += L * n
            elif all(gemm_plan.plan(M, N, K).fold for N in Ns):
                want["qmatmul_w8a8_qin"] += L * n
                want["qmatmul_w8a8"] += (len(Ns) - 1) * L * n
            else:
                want["quantize_act"] += L * n
                want["qmatmul_w8a8"] += len(Ns) * L * n
    return want


def forwards(run):
    """(decode steps, prefill dispatches) a serve run made on the card: its
    timed loop's, plus its warmup's (the throwaway traffic and the masked
    dispatch before each capture), one forward each."""
    warm = run.warmup or {}
    return (run.stats["decode_steps"] + warm.get("decode_steps", 0),
            run.stats["prefill_dispatches"] + warm.get("prefill_dispatches", 0))


def check_served(run, counts, label, want):
    """Every request finished with 32 tokens and finite logits; the launch
    counts (reset just before the run, read just after) are ``want``'s, and
    0 for every other kernel."""
    assert len(run.results) == 16, f"{label}: {len(run.results)} of 16 served"
    for r in run.results.values():
        assert r.status == "ok", f"{label}: request {r.rid}: {r.status}"
        assert len(r.tokens) == 32, f"{label}: request {r.rid}: {len(r.tokens)} tokens"
    st = run.stats
    warm = run.warmup or {}
    graphs = (f", {warm['graphs']} graphs captured in "
              f"{warm['capture_seconds']:.2f} s (warmup {warm['seconds']:.2f} s),"
              f" graph pool {warm['graph_pool_bytes'] / 2**20:.1f} MiB"
              if "graphs" in warm else "")
    log(f"  {label}: 16/16 requests finished with 32 tokens and finite "
        f"logits, {run.generated_tokens} tokens in {run.seconds:.3f} s = "
        f"{run.tokens_per_second:.1f} tok/s ({run.path} path, "
        f"{SERVE['slots']} slots, {st['decode_steps']} decode steps in "
        f"{st['decode_dispatches']} dispatches (mean horizon "
        f"{st['decode_steps'] / st['decode_dispatches']:.2f}), "
        f"{st['prefill_chunks']} prefill chunks in "
        f"{st['prefill_dispatches']} dispatches, "
        f"{st['host_syncs'] / st['generated_tokens']:.3f} host syncs/token"
        f"{graphs})")
    log(f"  kernel launches on the {label} path: {json.dumps(counts)}")
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")


def same_tokens(run, ref, what):
    """Every request of ``run`` got ``ref``'s tokens and finish tick."""
    for rid, r in ref.results.items():
        got = run.results[rid]
        assert got.tokens == r.tokens, f"{what}: request {rid}: other tokens"
        assert got.finished_at == r.finished_at, (
            f"{what}: request {rid}: finished at tick {got.finished_at}, "
            f"not {r.finished_at}")


def counted_serve(config, fused=True):
    """``repro_torch.serve(config)`` with the launch counts reset just
    before and read just after; ``fused=False`` sets REPRO_FUSED_DECODE=0
    for this run only. Returns (run, counts)."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    saved = os.environ.get("REPRO_FUSED_DECODE")
    if not fused:
        os.environ["REPRO_FUSED_DECODE"] = "0"
    try:
        reset_launch_counts()
        run = repro_torch.serve(config)
        return run, launch_counts()
    finally:
        if saved is None:
            os.environ.pop("REPRO_FUSED_DECODE", None)
        else:
            os.environ["REPRO_FUSED_DECODE"] = saved


def serve_full_width(torch, quantize, *, fused=True, reference=False,
                     profile=False):
    """``repro_torch.serve`` of qwen2-0.5b at full width under
    ``serve-<quantize>-kv8``: the fast path with every graph captured by
    ``warmup`` before the timed loop, or the stepwise path
    (``reference``); ``fused=False`` sets REPRO_FUSED_DECODE=0 for this
    run only."""
    import repro_torch

    config = repro_torch.ServeConfig(quantize=quantize, kv_bits=8,
                                     reference=reference,
                                     warmup=not reference, profile=profile,
                                     **SERVE)
    run, counts = counted_serve(config, fused)
    label = (f"serve-{quantize}-kv8" + ("" if fused else " unfused")
             + (" stepwise" if reference else "")
             + (" profiled" if profile else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, fused, *forwards(run)))
    if fused and not reference and not profile:
        sqnr = next(r for r in run.report
                    if r["stage"] == "pack")["metrics"]["sqnr_db"]
        log("  pack stage per-site weight SQNR (dB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sqnr.items()))
    return run, counts


def serve_bias_corrected(torch):
    """The same serve with the V bias correction: the model built from a
    ``kv_bias_correct`` config, quantized by ``repro_torch.quantize`` under
    ``serve-w8a8-kv8`` and served by a fast ``ServingEngine`` (graphs
    captured by ``engine.warmup()`` before the timed loop), whose cache then
    carries the v_err leaf; decode runs kv_attention, never fused_decode.
    A stepwise engine over the same weights must serve the same tokens."""
    import dataclasses
    import time

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import ServeRun
    from repro_torch.serving import ServingEngine, synthetic_trace

    cfg = dataclasses.replace(repro_torch.get_config(SERVE["arch"]),
                              kv_bias_correct=True)
    model = repro_torch.build_model(cfg)
    qm = repro_torch.quantize(model, model.init(SERVE["seed"], device="cuda"),
                              recipe="serve-w8a8-kv8", device="cuda")
    runs = {}
    for fast in (True, False):
        engine = ServingEngine(model, qm.params, cfg, fast=fast, kv_bits=8,
                               num_slots=SERVE["slots"],
                               max_len=SERVE["max_len"],
                               prefill_chunk=SERVE["prefill_chunk"],
                               device="cuda")
        assert "v_err" in engine.pool.cache
        requests = synthetic_trace(
            SERVE["trace_seed"], SERVE["trace"], vocab_size=cfg.vocab_size,
            prompt_lens=(SERVE["prompt_min"], SERVE["prompt_len"]),
            gen_lens=(SERVE["gen_min"], SERVE["gen_len"]),
            mean_interarrival=1.0)
        reset_launch_counts()
        warm = engine.warmup() if fast else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        run = ServeRun(results=results, stats=dict(engine.stats),
                       seconds=seconds,
                       generated_tokens=engine.stats["generated_tokens"],
                       report=qm.report, warmup=warm,
                       path="fast (decode horizon 8)" if fast else "stepwise")
        label = "serve-w8a8-kv8 kv_bias_correct" + ("" if fast else " stepwise")
        check_served(run, counts, label,
                     expected_launches("w8a8", False, *forwards(run)))
        assert float(engine.pool.cache["v_err"].abs().max()) > 0
        runs[fast] = run, counts
    same_tokens(runs[True][0], runs[False][0],
                "serve-w8a8-kv8 kv_bias_correct fast against stepwise")
    log("  serve-w8a8-kv8 kv_bias_correct: every request's tokens and finish "
        "tick equal the stepwise run's")
    return runs[True], runs[False]


# the smoke serving runs of phase 3: 3 slots, 6 requests
SMOKE_SERVE = dict(smoke=True, seed=0, slots=3, max_len=32, prefill_chunk=8,
                   trace=6, trace_seed=0, prompt_min=4, prompt_len=20,
                   gen_min=4, gen_len=8)


def _smoke_run(torch, device, **kw):
    """``repro_torch.serve`` at smoke size on ``device`` (the fast path's
    graphs captured by warmup on the card); returns (run, launch counts)."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    fast = not kw.get("reference", False)
    run = repro_torch.serve(repro_torch.ServeConfig(
        device=device, warmup=fast and device != "cpu",
        **{**SMOKE_SERVE, **kw}))
    return run, launch_counts()


def _smoke_engine_run(torch, arch, quantize, kv_bits, device, backend=None):
    """The stepwise engine on ``device`` over a smoke model whose weights
    are drawn on the host (the same on every device) and quantized there
    by ``serve-<quantize>[-kv8]`` (``quantize="none"``: as drawn); returns
    (results, launch counts, (model, params))."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quantized import map_leaves
    from repro_torch.serving import ServingEngine, synthetic_trace

    model = repro_torch.build_model(repro_torch.get_config(arch, smoke=True))
    params = model.init(0, device="cpu")
    if quantize == "none":
        params = map_leaves(lambda t: t.to(device), params)
    else:
        kv8 = "-kv8" if kv_bits == 8 else ""
        qm = repro_torch.quantize(model, params, device=device,
                                  recipe=f"serve-{quantize}{kv8}")
        model, params = qm.model, qm.params
    engine = ServingEngine(model, params, model.cfg, fast=False,
                           kv_bits=kv_bits, device=device, backend=backend,
                           num_slots=SMOKE_SERVE["slots"],
                           max_len=SMOKE_SERVE["max_len"],
                           prefill_chunk=SMOKE_SERVE["prefill_chunk"])
    reset_launch_counts()
    results = engine.run(synthetic_trace(
        0, SMOKE_SERVE["trace"], vocab_size=model.cfg.vocab_size,
        prompt_lens=(SMOKE_SERVE["prompt_min"], SMOKE_SERVE["prompt_len"]),
        gen_lens=(SMOKE_SERVE["gen_min"], SMOKE_SERVE["gen_len"]),
        mean_interarrival=1.0))
    return results, launch_counts(), (model, params)


def check_smoke_serving(torch, arch, quantize, kv_bits):
    """A smoke model served on the card: ``repro_torch.serve`` fast
    (graphs) and stepwise — the fast path's tokens and finish ticks equal
    the stepwise path's, the launch counts exact (``expected_launches`` of
    the arch, its KV precision and its forwards); then the stepwise
    engine on the same host-drawn weights, quantized on the card and on
    the CPU: every request's first token (the one no earlier difference
    can move) the CPU's, the share of equal tokens logged; and the two
    quantized models' teacher-forced prefill and decode logits
    (``teacher_forced``), so the decode path past the first token is held
    to the CPU's too."""
    import repro_torch

    label = (f"smoke {arch} --quantize {quantize} --kv-bits "
             f"{kv_bits or 16}")
    kw = dict(arch=arch, quantize=quantize, kv_bits=kv_bits)
    cfg = repro_torch.get_config(arch, smoke=True)
    for reference in (True, False):
        run, counts = _smoke_run(torch, "cuda", reference=reference, **kw)
        steps, chunks = forwards(run)
        want = expected_launches(quantize, True, steps, chunks, cfg=cfg,
                                 kv_bits=kv_bits or 16,
                                 slots=SMOKE_SERVE["slots"],
                                 chunk=SMOKE_SERVE["prefill_chunk"])
        for name, n in counts.items():
            assert n == want.get(name, 0), (
                f"{label}: {name} launched {n} times, expected "
                f"{want.get(name, 0)}")
        if reference:
            stepwise = run
            continue
        same_tokens(run, stepwise, f"{label} fast against stepwise")
    cpu, _, (model, cpu_params) = _smoke_engine_run(torch, arch, quantize,
                                                    kv_bits, "cpu")
    card, _, (_, card_params) = _smoke_engine_run(torch, arch, quantize,
                                                  kv_bits, "cuda")
    firsts = sum(card[r].tokens[0] == c.tokens[0] for r, c in cpu.items())
    equal = sum(a == b for r, c in cpu.items()
                for a, b in zip(card[r].tokens, c.tokens))
    total = sum(len(c.tokens) for c in cpu.values())
    assert firsts == len(cpu), (
        f"{label}: first tokens equal the CPU's in {firsts} of {len(cpu)} "
        f"requests")
    log(f"  {label} (kv cache {'int8' if run.kv_bits == 8 else 'fp'}): "
        f"repro_torch.serve fast = stepwise, request by request, launches "
        f"exact ({json.dumps({k: v for k, v in counts.items() if v})}); the "
        f"engine on the CPU's weights: every first token the CPU's, {equal} "
        f"of {total} tokens equal")
    teacher_forced(torch, torch.device("cuda"), model.cfg, cpu_params,
                   card_params, run.kv_bits, f"{label} ({cfg.n_layers} "
                   f"layers, {cfg.dtype})")


def check_torch_tier_on_card(torch):
    """``backend="torch"`` (an explicit argument: the engine's tier scope)
    on the card, over the CPU's weights quantized on the card: the plain
    versions through the model — the CPU's tokens and ticks, and no
    kernel launched; the default tier on the same weights launches."""
    kw = dict(arch="qwen2-0.5b", quantize="w8a8", kv_bits=8)
    cpu, _, _ = _smoke_engine_run(torch, device="cpu", **kw)
    card, counts, _ = _smoke_engine_run(torch, device="cuda",
                                        backend="torch", **kw)
    assert not any(counts.values()), f"torch tier launched kernels: {counts}"
    for rid, r in cpu.items():
        assert card[rid].tokens == r.tokens, f"request {rid}: other tokens"
        assert card[rid].finished_at == r.finished_at, rid
    _, kcounts, _ = _smoke_engine_run(torch, device="cuda", **kw)
    assert all(kcounts[k] for k in ("fused_decode", "qmatmul_w8a8")), kcounts
    log(f"  backend='torch' on the card (smoke qwen2, serve-w8a8-kv8, "
        f"stepwise engine): the CPU's tokens and finish ticks, 0 kernel "
        f"launches (the default tier on the same weights: "
        f"{sum(kcounts.values())} launches)")


# --------------------------------------------------------------- phase 5
# the recipes phase 5 quantizes qwen2-0.5b with at full width: the
# collapse baseline, the equalization ablation, the function-preserving
# rewrites then fake-quant without correction, and the paper's full flow
FULL_WIDTH_RECIPES = (
    ("naive-int8", "naive-int8"),
    ("cle-only", "cle-only"),
    ("fold-cle-absorb-wq", ["fold_norm", "cle", "bias_absorb", "weight_quant"]),
    ("dfq-int8", "dfq-int8"),
)
# the evaluation tokens' seed: not the calibration's (1)
EVAL_SEED = 7


def dfq_full_width(torch, dev):
    """qwen2-0.5b at full width, ``hostile_params`` drawn on the card:
    ``repro_torch.quantize`` under each of ``FULL_WIDTH_RECIPES``, with each
    stage's seconds, the sites bias_correct corrected, the per-site weight
    SQNR, and the logits SQNR and greedy agreement against fp on synthetic
    tokens of another seed; the output mean error (``output_bias_error``
    of the captured per-channel means against fp's, at every stat key,
    ``final_h`` included) without and with the correction. dfq-int8's
    logits SQNR must be above naive-int8's; the other orderings are logged,
    not asserted (a one-shot correction on random weights: a finding, not
    a gate). Returns the model and its fp weights."""
    import time

    import repro_torch
    from repro_torch.core import output_bias_error, sqnr_db
    from repro_torch.data import calibration_tokens

    cfg = repro_torch.get_config(SERVE["arch"])
    model = repro_torch.build_model(cfg)
    params = hostile_params(torch, model, device=dev)
    toks = calibration_tokens(EVAL_SEED, 2, 32, cfg.vocab_size, device=dev)
    y_fp = model.apply(params, toks).float()
    stats_fp = model.calibration_stats(params, toks)
    snr, stats = {}, {}
    for label, recipe in FULL_WIDTH_RECIPES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qm = repro_torch.quantize(model, params, recipe=recipe, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        y = model.apply(qm.params, toks).float()
        assert bool(torch.isfinite(y).all()), label
        snr[label] = float(sqnr_db(y_fp, y))
        agree = float((y.argmax(-1) == y_fp.argmax(-1)).float().mean())
        stats[label] = model.calibration_stats(qm.params, toks)
        rec = qm.stage_record("bias_correct")
        site = qm.site_sqnr_db()
        log(f"  {label}: quantized in {seconds:.3f} s ("
            + ", ".join(f"{r['stage']} {r['seconds']:.3f} s" for r in qm.report)
            + f"); logits SQNR {snr[label]:.2f} dB, greedy agreement "
            f"{agree:.3f} on {toks.numel()} tokens of seed {EVAL_SEED}"
            + (f"; bias_correct corrected {rec['metrics']['sites_corrected']}"
               if rec else ""))
        log(f"    per-site weight SQNR (dB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in site.items()))
    for key in stats_fp:
        err = {label: output_bias_error(stats_fp[key].float()[None],
                                        stats[label][key].float()[None]).abs()
               for label in ("fold-cle-absorb-wq", "dfq-int8")}
        log(f"  output mean error at {key} (mean / max |E[ỹ] − E[y]| over "
            f"{err['dfq-int8'].numel()} channels): without correction "
            f"{float(err['fold-cle-absorb-wq'].mean()):.4g} / "
            f"{float(err['fold-cle-absorb-wq'].max()):.4g}, with "
            f"{float(err['dfq-int8'].mean()):.4g} / "
            f"{float(err['dfq-int8'].max()):.4g}")
    order = sorted(snr, key=snr.get, reverse=True)
    log("  logits SQNR ordering: " + " > ".join(
        f"{k} ({snr[k]:.2f} dB)" for k in order))
    assert snr["dfq-int8"] > snr["naive-int8"], snr
    return model, params


def serve_saved_deployment(torch, dev, model, params):
    """The bias-corrected w8a8 deployment (``BC_DEPLOY``) of the full-width
    weights: ``QuantizedModel.save``, ``load`` (every leaf bit-equal to
    the saved), then ``repro_torch.serve(ServeConfig(load=...))`` on the
    fast path (graphs captured by warmup) and the stepwise path, phase 4's
    trace. Every request finishes, the fast path gives the stepwise tokens
    and ticks, and each kernel launches exactly ``expected_launches``
    times. Returns the fast run."""
    import shutil
    import time

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.pipeline import QuantizedModel

    qm = repro_torch.quantize(model, params, recipe=BC_DEPLOY, device=dev)
    bias = qm.params["blocks"]["mlp"]
    assert float(bias["bg"].abs().max()) > 0 and float(bias["bu"].abs().max()) > 0
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_artifact")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        qm.save(directory)
        t1 = time.perf_counter()
        loaded = QuantizedModel.load(directory, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want, got = dict(_leaves(qm.params)), dict(_leaves(loaded.params))
        assert sorted(want) == sorted(got), "the loaded tree differs"
        for path, t in want.items():
            assert got[path].dtype == t.dtype and torch.equal(got[path], t), path
        size = sum(os.path.getsize(os.path.join(directory, "step_0", f))
                   for f in os.listdir(os.path.join(directory, "step_0")))
        log(f"  bias-corrected w8a8 deployment: saved {size / 2**20:.1f} MiB in "
            f"{t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s, {len(want)} leaves "
            f"bit-equal to the saved, kv_bits {loaded.kv_bits}")
        del loaded
        runs = {}
        for reference in (True, False):
            config = repro_torch.ServeConfig(
                load=directory, reference=reference, warmup=not reference,
                **{k: v for k, v in SERVE.items() if k not in ("arch", "seed")})
            reset_launch_counts()
            run = repro_torch.serve(config)
            counts = launch_counts()
            label = "bias-corrected w8a8 --load" + (" stepwise" if reference
                                                    else "")
            check_served(run, counts, label,
                         expected_launches("w8a8", True, *forwards(run)))
            runs[reference] = run
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    same_tokens(runs[False], runs[True],
                "bias-corrected w8a8 --load fast against stepwise")
    log("  bias-corrected w8a8 --load: every request's tokens and finish tick "
        "equal the stepwise run's")
    return runs[False], runs[True]


def log_row(name, r):
    """One kernel row of phase 2: device and call time, the plain version,
    the library call, the bound and what else the row measured."""
    lib_ms = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f}"
    log(f"  {name:16s} {r['shape']:40s} kernel "
        f"{r['ms'] * 1e3:9.2f} us (call {r['call_ms'] * 1e3:7.2f})  "
        f"plain {r['plain_ms'] * 1e3:9.2f} us  library {lib_ms:>6s} us"
        f"  bound {r['bound_ms'] * 1e3:8.3f} us ({r['bound_by']})"
        + (f"  stepwise pair {r['stepwise_ms'] * 1e3:8.2f} us"
           if "stepwise_ms" in r else "")
        + (f"  cold {r['cold_ms'] * 1e3:8.2f} us" if "cold_ms" in r else "")
        + (f" (library {r['library_cold_ms'] * 1e3:.2f})"
           if "library_cold_ms" in r else "")
        + (f"  [{r['library']}]" if "library" in r else "")
        + (f"  without quantize-out {r['no_q8_ms'] * 1e3:.2f} us"
           if "no_q8_ms" in r else "")
        + (f"  splits {r['splits']}, SDPA bf16 (GQA expanded) "
           f"{r['sdpa_ms'] * 1e3:.2f} us" if "sdpa_ms" in r else "")
        + (f"  launch floor {r['floor_ms'] * 1e3:.2f} us"
           if "floor_ms" in r else ""))


# --------------------------------------------------------------- phase 6
# the serving runs of phase 6: phase 4's trace at mistral-nemo-12b's width
NEMO = dict(SERVE, arch="mistral-nemo-12b")
# device memory quantize must leave free (of the card's total)
FREE_BYTES = 8 << 30


def nemo_depth(torch, dev):
    """The depth phase 6 serves mistral-nemo-12b at: all its layers if
    ``repro_torch.quantize``'s peak (``torch.cuda.max_memory_allocated``,
    serve-w8a16: the float32 weights and the copies the flow makes) leaves
    ``FREE_BYTES`` of the card free, else the deepest that does. The peak
    is linear in the depth (the embedding and the head, then the same
    blocks a layer): measured at 2 and 4 layers and extrapolated; each
    run checks its own peak."""
    import dataclasses
    import gc

    import repro_torch

    cfg = repro_torch.get_config(NEMO["arch"])
    peaks = {}
    for L in (2, 4):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        qm = repro_torch.quantize(
            repro_torch.build_model(dataclasses.replace(cfg, n_layers=L)),
            None, recipe="serve-w8a16", device=dev)
        torch.cuda.synchronize(dev)
        peaks[L] = torch.cuda.max_memory_allocated(dev) - base
        del qm
    per_layer = (peaks[4] - peaks[2]) / 2
    fixed = peaks[2] - 2 * per_layer
    total = torch.cuda.get_device_properties(dev).total_memory
    room = total - FREE_BYTES - torch.cuda.memory_allocated(dev)
    fits = int((room - fixed) // per_layer)
    depth = max(1, min(cfg.n_layers, fits))
    log(f"  quantize peak of serve-w8a16 at 2 / 4 layers: "
        f"{peaks[2] / 2**30:.2f} / {peaks[4] / 2**30:.2f} GiB -> "
        f"{per_layer / 2**30:.3f} GiB a layer + {fixed / 2**30:.2f} GiB; the "
        f"card holds {total / 2**30:.2f} GiB: {fits} layers leave "
        f"{FREE_BYTES / 2**30:.0f} GiB free -> serving "
        f"{depth} of {cfg.n_layers} layers")
    return depth


def serve_nemo(torch, depth, quantize, kv_bits, *, reference):
    """``repro_torch.serve`` of mistral-nemo-12b (full width, ``depth``
    layers) on phase 4's trace: the fast path with every graph captured by
    warmup, or the stepwise path; checked as phase 4's runs, the launch
    counts from the plan."""
    import dataclasses
    import gc

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    config = repro_torch.ServeConfig(
        quantize=quantize, kv_bits=kv_bits, layers=depth,
        reference=reference, warmup=not reference, **NEMO)
    reset_launch_counts()
    run = repro_torch.serve(config)
    counts = launch_counts()
    cfg = dataclasses.replace(repro_torch.get_config(NEMO["arch"]),
                              n_layers=depth)
    kv = kv_bits or 16
    label = (f"mistral-nemo-12b ({depth} layers) serve-{quantize}"
             + ("-kv8" if kv == 8 else " (bf16 KV cache)")
             + (" stepwise" if reference else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, True, *forwards(run), cfg=cfg,
                                   kv_bits=kv))
    total = torch.cuda.get_device_properties(0).total_memory
    free = total - run.quantize_peak_bytes
    log(f"  {label}: {run.tokens_per_second:.1f} tok/s; quantize "
        f"{run.quantize_seconds:.2f} s (peak {run.quantize_peak_bytes / 2**30:.2f}"
        f" GiB, {free / 2**30:.2f} GiB of {total / 2**30:.2f} free)"
        + (f", warmup {run.warmup['seconds']:.2f} s" if run.warmup else "")
        + f"; peak from then to the loop's end {run.peak_bytes / 2**30:.2f} "
          f"GiB ({smi_line()})")
    assert free >= FREE_BYTES, (
        f"{label}: quantize left {free / 2**30:.2f} GiB free")
    return run


# --------------------------------------------------------------- phase 7
# the reference's top-1 (%) on the same recipe: the JAX package on the CPU
# (jax 0.9.0, benchmarks.tables.table1_cle and table2_bias_correction, 1536
# held-out images); the card's rows are logged beside them, and the gates
# are relative to the card's own rows
CNN_REFERENCE_CPU = {
    "original_fp32": 55.1, "original_int8": 18.9, "replace_relu6_fp32": 73.7,
    "replace_relu6_int8": 20.2, "cle_int8": 74.5, "cle_absorb_int8": 74.5,
    "per_channel_int8": 49.7, "bias_corr_int8": 17.3, "clip15_int8": 18.2,
    "clip15_bias_corr_int8": 12.2, "full_dfq_int8": 74.7}
# the reference recipe (benchmarks/_cnn_pipeline.py): 8 classes of 32x32
# gratings, 300 AdamW steps at batch 128, lr 3e-3, weight decay 1e-4; the
# evaluation: 6 held-out batches of 256 (seed 99, steps 10000+)
CNN_TRAIN = dict(steps=300, batch=128, seed=0, lr=3e-3, weight_decay=1e-4)
CNN_CLASSES, CNN_IMG = 8, 32
CNN_EVAL = dict(seed=99, batches=6, batch=256)
# MobileNetV2 1.0 at 224 (Sandler et al. 2018, Table 2): the stem of 32,
# then each (t, c, n, s) row of the table as n blocks, the first at stride
# s; CNNConfig has no field for the 1280-wide last 1x1 conv, so it is left
# out and the classifier reads the 320 channels. The activation is ReLU:
# the paper swaps ReLU6 for ReLU before CLE (§5.1.1), and here the swap
# comes before the BN statistics are set — with random BN moments many
# pre-activations pass 6, and statistics taken under ReLU6 do not describe
# the ReLU model (its logits reached ~1e9 at 224 px in a chip probe)
MOBILENET_V2_224 = dict(
    name="mobilenet_v2-1.0-224 (no 1280 conv)", in_channels=3,
    num_classes=1000, width=32,
    blocks=((1, 16, 1), (6, 24, 2), (6, 24, 1), (6, 32, 2), (6, 32, 1),
            (6, 32, 1), (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
            (6, 96, 1), (6, 96, 1), (6, 96, 1), (6, 160, 2), (6, 160, 1),
            (6, 160, 1), (6, 320, 1)),
    img_size=224, act_clip=None)
# fp32 logits, card against CPU on the same folded weights and images:
# float32 convolutions summing in other orders, through every layer —
# within CNN_FWD_TOL of the largest |logit|; a TF32 forward (inputs of
# every product rounded to 10 mantissa bits, ~2^-11 relative) must fall
# outside it
CNN_FWD_TOL = 1e-4
# the transforms' leaves, card against CPU: bit-equal where the arithmetic
# is elementwise (fold, CLE, weight quantization); where a leaf is a sum
# (absorption's shifted biases, bias correction's), within CNN_SUM_TOL of
# the leaf's largest magnitude
CNN_SUM_TOL = 1e-6
# fp32 logits after a function-preserving rewrite against before it, on
# the card, relative to the largest |logit|. CLE rescales whole channels:
# only rounding through 1.5 decades of hostile scales. High-bias absorption
# assumes each absorbed channel's pre-activation stays above c = β − 3γ,
# which the BN moments of random weights describe only roughly, and a 3x3
# window at the padding border sums fewer taps of c: CPU rehearsals at
# 64-128 px moved the logits by 3-7 % of the largest |logit|, the chip run
# at 224 px by 11.3 %
CNN_CLE_TOL = 1e-3
CNN_ABSORB_TOL = 0.15


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (i,))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _tree_leaves(v, path + (k,))
    else:
        yield path, tree


def merge_bn(trained, with_stats):
    """benchmarks/_cnn_pipeline.py's ``_merge_bn``: the running mean and
    var from the forward's tree, everything else from AdamW's."""
    if isinstance(trained, dict):
        if set(trained) == {"gamma", "beta", "mean", "var"}:
            return {"gamma": trained["gamma"], "beta": trained["beta"],
                    "mean": with_stats["mean"], "var": with_stats["var"]}
        return {k: merge_bn(trained[k], with_stats[k]) for k in trained}
    if isinstance(trained, list):
        return [merge_bn(a, b) for a, b in zip(trained, with_stats)]
    return trained


def cnn_train_step(torch, model, params, opt, batch, lr, weight_decay):
    """One step of the reference recipe: the loss's gradients (zeros for
    the running statistics, which the loss does not read — JAX's gradient
    there), AdamW, then the forward's running statistics merged in."""
    from repro_torch.models.cnn import fp32
    from repro_torch.optim import adamw_update

    live = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = [t for _, t in _tree_leaves(live)]
    with fp32():
        loss, new_params = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    upd, opt, _ = adamw_update(_tree_map(lambda t: by_leaf[id(t)], live), opt,
                               params, lr=lr, weight_decay=weight_decay)
    return merge_bn(upd, new_params), opt, loss.detach()


def image_batches(torch, dev, seed, steps, batch, size, classes, workers=4):
    """``synthetic_image_batch(seed, step, ...)`` for each step, drawn on
    the host by ``workers`` threads ahead of the consumer (numpy releases
    the interpreter lock) and moved to ``dev`` in order."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data import synthetic_image_batch

    def draw(step):
        return synthetic_image_batch(seed, step, batch, size, 3, classes,
                                     device="cpu")

    with ThreadPoolExecutor(workers) as pool:
        for b in pool.map(draw, steps):
            yield {k: v.to(dev) for k, v in b.items()}


def adversarial_rescale(torch, folded, seed=0, decades=1.5):
    """benchmarks/_cnn_pipeline.py's hostile-ranges injector: a
    function-preserving log-normal per-channel rescale over each inverted
    residual's expand → dw and dw → project interfaces, with the JAX
    package's draws for the seed (``prng.normal``, within 4 ulp)."""
    import numpy as np

    from repro_torch.core.cle import ConvLayer, _scale_in, _scale_out
    from repro_torch.data import prng

    folded = _tree_map(lambda t: t, folded)
    key = prng.PRNGKey(seed)
    for blk in folded["blocks"]:
        for src, dst, dst_kind in (("expand", "dw", "depthwise"),
                                   ("dw", "project", "conv")):
            key, k = prng.split(key)
            n = prng.normal(k, (blk[src].w.shape[-1],))
            s = torch.from_numpy(np.exp(n * np.float32(decades))).to(
                blk[src].w.device)
            l1s = _scale_out(ConvLayer(blk[src].w, blk[src].b,
                                       "depthwise" if src == "dw" else "conv"),
                             s)
            l2s = _scale_in(ConvLayer(blk[dst].w, blk[dst].b, dst_kind), s)
            blk[src] = blk[src]._replace(w=l1s.w, b=l1s.b,
                                         act_mean=blk[src].act_mean / s,
                                         act_std=blk[src].act_std / s)
            blk[dst] = blk[dst]._replace(w=l2s.w)
    return folded


def clip_weights(torch, folded, clip=15.0):
    """The paper's §5.1.2 weight-clipping baseline (every conv, not the
    head)."""
    q = _tree_map(lambda t: t, folded)
    q["stem"] = q["stem"]._replace(w=torch.clamp(q["stem"].w, -clip, clip))
    for blk in q["blocks"]:
        for k in ("expand", "dw", "project"):
            blk[k] = blk[k]._replace(w=torch.clamp(blk[k].w, -clip, clip))
    return q


def act_quantizer(torch, act_clip, bits=8, n_sigma=6.0):
    """benchmarks' data-free activation fake-quant: the range max(β ± 6γ)
    over the layer's channels, its low end clamped to 0 (post-ReLU) and the
    high end capped at the clip."""
    from repro_torch.core import (QuantSpec, fake_quant_with_qparams,
                                  qparams_from_range)

    spec = QuantSpec(bits=bits, symmetric=False)

    def act_quant(h, name, mean, std):
        lo = torch.clamp_min(torch.clamp_max(
            torch.min(mean - n_sigma * std), 0.0), 0.0)
        hi = torch.max(mean + n_sigma * std)
        if act_clip is not None:
            hi = torch.clamp_max(hi, act_clip)
        return fake_quant_with_qparams(h, qparams_from_range(lo, hi, spec))

    return act_quant


def cnn_accuracy(torch, model, folded, batches, act_clip=None, w_bits=None,
                 per_channel=False, bias_correct=False, act_bits=None):
    """Top-1 (%) over the held-out batches — benchmarks' ``eval_accuracy``
    on the tree ``_acc`` makes: weights fake-quantized to ``w_bits`` (and
    bias-corrected), activations to ``act_bits`` with data-free ranges."""
    from repro_torch.core import QuantSpec

    q = folded
    if w_bits:
        spec = QuantSpec(bits=w_bits, per_channel_axis=-1 if per_channel
                         else None)
        q = model.quantize_weights(folded, spec)
        if bias_correct:
            q = model.bias_correct_analytic(folded, q, spec, act_clip=act_clip)
    act_quant = act_quantizer(torch, act_clip) if act_bits else None
    correct = total = 0
    for b in batches:
        logits = model.apply_folded(q, b["x"], act_clip=act_clip,
                                    act_quant=act_quant)
        correct = correct + (logits.argmax(-1) == b["y"]).sum()
        total += b["y"].numel()
    return 100.0 * float(correct) / total


def timed(torch, secs, name, fn):
    """``fn()``, its seconds on the card (synchronized) put in ``secs``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    return out


def cnn_rows(torch, model, hostile, batches, secs):
    """The rows of tables.table1_cle and table2_bias_correction, on the
    hostile model; each transform's seconds go in ``secs``."""
    eq = timed(torch, secs, "equalize", lambda: model.equalize(hostile))
    ab = timed(torch, secs, "absorb_high_bias",
               lambda: model.absorb_high_bias(eq))
    clipped = clip_weights(torch, hostile, 15.0)

    def acc(tree, act_clip, **kw):
        if kw:
            kw.setdefault("act_bits", 8)
        return cnn_accuracy(torch, model, tree, batches, act_clip=act_clip,
                            **kw)

    rows = {
        "original_fp32": acc(hostile, 6.0),
        "original_int8": acc(hostile, 6.0, w_bits=8),
        "replace_relu6_fp32": acc(hostile, None),
        "replace_relu6_int8": acc(hostile, None, w_bits=8),
        "cle_fp32": acc(eq, None),
        "cle_int8": acc(eq, None, w_bits=8),
        "cle_absorb_fp32": acc(ab, None),
        "cle_absorb_int8": acc(ab, None, w_bits=8),
        "per_channel_int8": acc(hostile, 6.0, w_bits=8, per_channel=True),
        "bias_corr_int8": acc(hostile, 6.0, w_bits=8, bias_correct=True),
        "clip15_fp32": acc(clipped, 6.0),
        "clip15_int8": acc(clipped, 6.0, w_bits=8),
        "clip15_bias_corr_int8": acc(clipped, 6.0, w_bits=8,
                                     bias_correct=True),
        "full_dfq_int8": acc(ab, None, w_bits=8, bias_correct=True),
    }
    return rows


def cnn_paper_tables(torch, dev, smi):
    """Phase 7a: the reference's recipe on the repo's mobilenet_v2 config,
    trained and quantized on the card; the rows of the paper's Tables 1
    and 2 beside the reference's."""
    import math

    from repro_torch.configs.mobilenet_v2 import CONFIG
    from repro_torch.models import MobileNetCNN
    from repro_torch.optim import adamw_init

    tr, cfg = CNN_TRAIN, CONFIG
    assert (cfg.num_classes, cfg.img_size) == (CNN_CLASSES, CNN_IMG)
    model = MobileNetCNN(cfg)
    params = model.init(tr["seed"], device=dev)
    opt = adamw_init(params)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # cuDNN's deterministic algorithms: the same trained weights every run,
    # so that the rows below (the collapsed int8 ones moved 12.6 → 31.8 %
    # between two runs without it) are reproducible
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for b in image_batches(torch, dev, tr["seed"], range(tr["steps"]),
                               tr["batch"], CNN_IMG, CNN_CLASSES):
            params, opt, loss = cnn_train_step(torch, model, params, opt, b,
                                               tr["lr"], tr["weight_decay"])
            losses.append(loss)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    losses = [float(x) for x in torch.stack(losses).cpu()]
    train_s = time.perf_counter() - t0
    log(f"  7a {cfg.name} (width {cfg.width}, {len(cfg.blocks)} blocks, "
        f"{CNN_IMG}x{CNN_IMG}, {CNN_CLASSES} classes): {tr['steps']} AdamW "
        f"steps at batch {tr['batch']} in {train_s:.2f} s, "
        f"{tr['steps'] / train_s:.1f} steps/s (host drawing included); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({smi})")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses

    secs = {}
    hostile = timed(torch, secs, "fold + hostile rescale",
                    lambda: adversarial_rescale(torch, model.fold(params)))
    ev = CNN_EVAL
    batches = list(image_batches(
        torch, dev, ev["seed"], range(10_000, 10_000 + ev["batches"]),
        ev["batch"], CNN_IMG, CNN_CLASSES))
    rows = timed(torch, secs, "rows",
                 lambda: cnn_rows(torch, model, hostile, batches, secs))
    for name, top1 in rows.items():
        ref = CNN_REFERENCE_CPU.get(name)
        log(f"  7a {name:24s} top-1 {top1:6.2f} %  (reference, JAX on the "
            f"CPU: " + ("none given" if ref is None else f"{ref:.1f} %")
            + ")")
    log("  7a seconds on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f" ({smi})")
    assert abs(rows["cle_fp32"] - rows["replace_relu6_fp32"]) <= 0.2, rows
    assert rows["full_dfq_int8"] >= rows["replace_relu6_fp32"] - 5.0, rows
    assert rows["full_dfq_int8"] >= rows["original_int8"] + 30.0, rows


def _max_rel(torch, a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / b.double().abs().max())


def check_leaves_card_cpu(torch, name, card, cpu, summed):
    """A transform's tree on the card against the same transform's on the
    CPU: every leaf bit-equal, or for the leaves ``summed(path)`` marks
    within CNN_SUM_TOL of the leaf's largest magnitude."""
    worst, n = 0.0, 0
    cpu_leaves = dict(_tree_leaves(cpu))
    for path, t in _tree_leaves(card):
        want = cpu_leaves[path]
        if isinstance(t, int):
            assert t == want, (name, path)
            continue
        n += 1
        if summed(path):
            rel = _max_rel(torch, t, want)
            worst = max(worst, rel)
            assert rel <= CNN_SUM_TOL, (name, path, rel)
        else:
            assert torch.equal(t.cpu(), want), (name, path)
    return n, worst


def _blocks_b(*parts):
    def summed(path):
        return path[0] == "blocks" and path[2] in parts and path[3] == "b"
    return summed


def fig2_spread(torch, folded):
    """Fig. 2's per-channel range spread of the depthwise kernels: max over
    median of each block's channel ranges, averaged over the blocks."""
    from repro_torch.core import channel_ranges

    vals = []
    for blk in folded["blocks"]:
        r = torch.clamp_min(channel_ranges(blk["dw"].w, -1), 1e-9)
        vals.append(float(r.max() / torch.quantile(r, 0.5)))
    return sum(vals) / len(vals)


def mobilenet_v2_published(torch, dev, smi):
    """Phase 7b: MobileNetV2's published widths at 224x224 (random
    weights from the seed, BN γ log-normal and β normal, running statistics
    from train-mode forwards), folded, made hostile and taken through CLE,
    absorption, 8-bit weights and analytic bias correction on the card."""
    import numpy as np

    from repro_torch.core import QuantSpec, sqnr_db
    from repro_torch.data import prng
    from repro_torch.models import CNNConfig, MobileNetCNN

    cfg = CNNConfig(**MOBILENET_V2_224)
    model = MobileNetCNN(cfg)
    secs = {}
    torch.cuda.reset_peak_memory_stats()
    log(f"  7b {cfg.name}: width {cfg.width}, {len(cfg.blocks)} blocks, "
        f"{cfg.img_size}x{cfg.img_size}, {cfg.num_classes} classes; the "
        f"1280-wide last 1x1 conv of the published model is left out "
        f"(CNNConfig has no field for it)")
    params = timed(torch, secs, "init", lambda: model.init(0, device=dev))
    keys = iter(prng.split(prng.fold_in(prng.PRNGKey(0), 1),
                           2 * (1 + 3 * len(cfg.blocks))))

    def random_bn(bn):
        c = bn["gamma"].shape[0]
        gamma = np.exp(prng.normal(next(keys), (c,)) * np.float32(0.5))
        beta = prng.normal(next(keys), (c,))
        return dict(bn, gamma=torch.from_numpy(gamma).to(dev),
                    beta=torch.from_numpy(beta).to(dev))

    params["stem"]["bn"] = random_bn(params["stem"]["bn"])
    for blk in params["blocks"]:
        for k in ("expand", "dw", "project"):
            blk[k]["bn"] = random_bn(blk[k]["bn"])
    images = list(image_batches(torch, dev, 0, range(30), 32, cfg.img_size,
                                cfg.num_classes, workers=8))

    def stats(p):
        with torch.no_grad():
            for b in images:
                _, p = model.apply_train(p, b["x"])
        return p

    params = timed(torch, secs, "bn_stats", lambda: stats(params))
    folded = timed(torch, secs, "fold", lambda: model.fold(params))
    hostile = timed(torch, secs, "hostile",
                    lambda: adversarial_rescale(torch, folded))
    eq = timed(torch, secs, "equalize", lambda: model.equalize(hostile))
    ab = timed(torch, secs, "absorb_high_bias",
               lambda: model.absorb_high_bias(eq))
    spec = QuantSpec(bits=8)
    q = timed(torch, secs, "quantize_weights",
              lambda: model.quantize_weights(ab, spec))
    bc = timed(torch, secs, "bias_correct_analytic",
               lambda: model.bias_correct_analytic(ab, q, spec))
    log("  7b seconds on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f" ({smi})")

    # the same transforms on the CPU, from the card's params moved across
    cpu = _tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, params)
    c_fold = model.fold(cpu)
    c_host = adversarial_rescale(torch, c_fold)
    c_eq = model.equalize(c_host)
    c_ab = model.absorb_high_bias(c_eq)
    c_q = model.quantize_weights(c_ab, spec)
    c_bc = model.bias_correct_analytic(c_ab, c_q, spec)
    none = _blocks_b()
    report = []
    for name, card, host, summed in (
            ("fold", folded, c_fold, none), ("hostile", hostile, c_host, none),
            ("equalize", eq, c_eq, none),
            ("absorb_high_bias", ab, c_ab, _blocks_b("dw", "project")),
            ("quantize_weights", q, c_q, _blocks_b("dw", "project")),
            ("bias_correct_analytic", bc, c_bc,
             _blocks_b("expand", "dw", "project"))):
        n, worst = check_leaves_card_cpu(torch, name, card, host, summed)
        report.append(f"{name} {n} leaves" + (
            f" (sums within {worst:.2g})" if worst else ""))
    log("  7b card = CPU, leaf by leaf: " + "; ".join(report))

    x = images[0]["x"][:8]
    y_fp = model.apply_folded(hostile, x)
    y_cpu = model.apply_folded(c_host, x.cpu())
    y_tf32 = model.apply_folded(hostile, x, allow_tf32=True)
    fp_err, tf32_err = (_max_rel(torch, y_fp, y_cpu),
                        _max_rel(torch, y_tf32, y_cpu))
    log(f"  7b fp32 logits card against CPU: max |diff| {fp_err:.3g} of max "
        f"|logit| (tolerance {CNN_FWD_TOL:g}); a TF32 forward on the card: "
        f"{tf32_err:.3g}, outside it")
    assert fp_err <= CNN_FWD_TOL, fp_err
    assert tf32_err > CNN_FWD_TOL, tf32_err

    cle_err = _max_rel(torch, model.apply_folded(eq, x), y_fp)
    ab_err = _max_rel(torch, model.apply_folded(ab, x), y_fp)
    log(f"  7b fp32 logits against the hostile model's: after CLE "
        f"{cle_err:.3g} (tolerance {CNN_CLE_TOL:g}), after CLE + absorption "
        f"{ab_err:.3g} (tolerance {CNN_ABSORB_TOL:g}: exact only above c "
        f"and away from the padding borders)")
    assert cle_err <= CNN_CLE_TOL, cle_err
    assert ab_err <= CNN_ABSORB_TOL, ab_err

    aq = act_quantizer(torch, None)
    snr = {name: float(sqnr_db(y_fp, model.apply_folded(tree, x,
                                                         act_quant=aq)))
           for name, tree in (
               ("original int8", model.quantize_weights(hostile, spec)),
               ("CLE + BA int8", q), ("full DFQ int8", bc))}
    log("  7b logits SQNR against fp32 (8-bit weights and activations): "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items()))
    assert snr["full DFQ int8"] > snr["original int8"], snr
    log(f"  7b Fig. 2 depthwise range spread (max/median, mean over blocks): "
        f"hostile {fig2_spread(torch, hostile):.2f}, after CLE "
        f"{fig2_spread(torch, eq):.2f}")

    pool = torch.cat([b["x"] for b in images])
    for n in (64, 256):
        xb = pool[:n]
        for label, tree, kw in (("fp32", hostile, {}),
                                ("int8 fake-quant", bc, {"act_quant": aq})):
            def fwd():
                with torch.no_grad():
                    return model.apply_folded(tree, xb, **kw)

            ms = call_ms(fwd, 10, warmup=2)
            log(f"  7b folded forward at batch {n} ({label}): {ms:.2f} ms, "
                f"{n / ms * 1e3:.0f} images/s ({smi})")
    log(f"  7b peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")


# --------------------------------------------------------------- main
# --------------------------------------------------------------- phase 8
# the paged runs of phase 8: phase 4's settings, pages of 32 positions (the
# prefill chunk)
PAGED = dict(SERVE, page_size=32)
# phase 4's engine from the paged runs' ServingEngine
ENGINE = dict(num_slots=SERVE["slots"], max_len=SERVE["max_len"],
              prefill_chunk=SERVE["prefill_chunk"], decode_horizon=8,
              page_size=PAGED["page_size"], device="cuda")
# 8b: 16 requests sharing a 192-token prompt prefix (6 pages), each with
# 8-64 tokens of its own; the first at tick 0, the others from tick 7 on,
# when its prefix is published
SHARED_PREFIX = 192
# 8c: half the full page capacity (8 slots x 16 pages), and a trace of
# long prompts in two priority classes that overflows it
STARVED_PAGES = 64
STARVED_TRACE = dict(seed=2, n=16, prompt_lens=(224, 256), gen_lens=(32, 32),
                     mean_interarrival=1.0, priority_levels=2)
# 8e: phase 4's trace with a deadline 16-64 ticks after each arrival
DEADLINE_SLACK = (16.0, 64.0)
# 8d: the chaos CLI's engine (repro_torch.serving.chaos), its starved pool
# and its seeded plan
CHAOS = dict(num_slots=4, max_len=48, prefill_chunk=8, decode_horizon=4,
             page_size=8)
CHAOS_PAGES = 2 * (48 // 8)


def serve_paged(torch, quantize, kv_bits, *, fused=True, reference=False,
                **kw):
    """``repro_torch.serve`` of qwen2-0.5b at full width on phase 4's
    trace from the paged pool (``PAGED``; ``page_size=None`` the contiguous
    pool), fast after warmup or stepwise, checked as phase 4's runs (every
    request ok with 32 tokens, launches exact); ``fused=False`` sets
    REPRO_FUSED_DECODE=0 for this run only. Returns (run, counts)."""
    import repro_torch

    config = repro_torch.ServeConfig(quantize=quantize, kv_bits=kv_bits,
                                     reference=reference,
                                     warmup=not reference, **{**PAGED, **kw})
    run, counts = counted_serve(config, fused)
    label = (f"serve-{quantize}" + ("-kv8" if kv_bits == 8 else " (bf16 KV)")
             + (f" paged (page {config.page_size})" if config.page_size
                else " contiguous")
             + ("" if fused else " unfused") + (" stepwise" if reference
                                                else ""))
    check_served(run, counts, label,
                 expected_launches(quantize, fused, *forwards(run),
                                   kv_bits=kv_bits or 16))
    return run, counts


def check_paged_serving(torch, runs, stepwise):
    """8a: serve-w8a16 over the bf16 KV cache (the default deployment) and
    serve-w8a8-kv8, each fast four times in turns — contiguous, paged,
    paged, contiguous, so that the tok/s compare within one stretch of the
    card's time — then paged stepwise; serve-w8a8-kv8 paged fast once more
    with REPRO_FUSED_DECODE=0 (kv_attention over the dense view). Every
    request's tokens and finish tick equal the first contiguous run's, and
    for serve-w8a8-kv8 phase 4's fast and stepwise runs'; launches exact."""
    pg = PAGED["page_size"]
    for quantize, kv_bits in (("w8a16", None), ("w8a8", 8)):
        label = f"serve-{quantize}" + ("-kv8" if kv_bits else " (bf16 KV)")
        turns = [serve_paged(torch, quantize, kv_bits, page_size=size)[0]
                 for size in (None, pg, pg, None)]
        for run in turns[1:]:
            same_tokens(run, turns[0], f"{label} against its first "
                                       f"contiguous run")
        step = serve_paged(torch, quantize, kv_bits, reference=True)[0]
        same_tokens(step, turns[0], f"{label} paged stepwise against fast")
        if kv_bits:
            same_tokens(turns[0], runs[quantize][0],
                        f"{label} against phase 4's run")
            same_tokens(step, stepwise[quantize],
                        f"{label} paged stepwise against phase 4's")
            unfused = serve_paged(torch, quantize, kv_bits, fused=False)[0]
            same_tokens(unfused, turns[1], f"{label} paged unfused against "
                                           f"fused")
        tps = [run.tokens_per_second for run in turns]
        flat, paged = (tps[0] + tps[3]) / 2, (tps[1] + tps[2]) / 2
        log(f"  8a {label}: every paged request's tokens and finish tick "
            f"equal the contiguous runs'; tok/s in turns (contiguous, paged,"
            f" paged, contiguous) " + ", ".join(f"{t:.1f}" for t in tps)
            + f": paged {paged:.1f} / contiguous {flat:.1f} "
            f"({(paged / flat - 1) * 100:+.1f} %); paged stepwise "
            f"{step.tokens_per_second:.1f}"
            + (f", paged unfused {unfused.tokens_per_second:.1f}"
               if kv_bits else "")
            + f"; page pool {turns[1].pool_bytes / 2**20:.2f} MiB (the "
            f"contiguous pool's bytes), dense view "
            f"{turns[1].view_bytes / 2**20:.2f} MiB ({smi_line()})")


def served_engine(torch, engine, requests, label, *, warm=True):
    """Run ``requests`` through ``engine`` (its graphs captured by warmup
    first when ``warm``), launches reset before and read after and held to
    ``expected_launches`` of serve-w8a16 over the fp cache; returns
    (results, seconds)."""
    import time

    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    warmup = engine.warmup() if warm else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    steps = engine.stats["decode_steps"] + warmup.get("decode_steps", 0)
    chunks = (engine.stats["prefill_dispatches"]
              + warmup.get("prefill_dispatches", 0))
    want = expected_launches("w8a16", True, steps, chunks, kv_bits=16)
    for name, n in counts.items():
        assert n == want.get(name, 0), (
            f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")
    return results, seconds


def shared_prefix_trace(vocab):
    """8b's trace (see ``SHARED_PREFIX``)."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, size=SHARED_PREFIX)
    out = []
    for i in range(SERVE["trace"]):
        own = rng.randint(0, vocab, size=int(rng.randint(8, 65)))
        out.append(Request(rid=i, prompt=np.concatenate([base, own]),
                           max_new_tokens=SERVE["gen_len"],
                           arrival=0.0 if i == 0 else 6.0 + i))
    return out


def check_prefix_reuse(torch, model, params, cfg):
    """8b: the shared-prefix trace with reuse on and off (serve-w8a16,
    bf16 KV, fast after warmup): the same tokens, no request later with
    reuse on, prefix hits, fewer prefill chunks; cow_copies logged."""
    from repro_torch.serving import ServingEngine

    out = {}
    for reuse in (True, False):
        engine = ServingEngine(model, params, cfg, prefix_reuse=reuse,
                               **ENGINE)
        label = f"8b reuse {'on' if reuse else 'off'}"
        res, secs = served_engine(torch, engine, shared_prefix_trace(
            cfg.vocab_size), label)
        assert all(r.status == "ok" and len(r.tokens) == SERVE["gen_len"]
                   for r in res.values()), label
        out[reuse] = engine, res, secs
    (on, res_on, s_on), (off, res_off, s_off) = out[True], out[False]
    for rid, r in res_off.items():
        assert res_on[rid].tokens == r.tokens, f"8b: request {rid}: tokens"
        assert res_on[rid].finished_at <= r.finished_at, (
            f"8b: request {rid} finished later with reuse on")
    hits = on.prefix_index.hits
    assert hits > 0, "8b: no prefix hit"
    assert on.stats["prefill_chunks"] < off.stats["prefill_chunks"], (
        "8b: reuse saved no prefill chunk")
    gen = sum(len(r.tokens) for r in res_on.values())
    log(f"  8b shared {SHARED_PREFIX}-token prefix, 16 requests: the same "
        f"tokens with reuse on and off; prefix hits {hits}, prefill chunks "
        f"{on.stats['prefill_chunks']} / {off.stats['prefill_chunks']} "
        f"(on / off), engine ticks {on.stats['engine_steps']} / "
        f"{off.stats['engine_steps']}, cow_copies {on.pool.cow_copies}, "
        f"{gen / s_on:.1f} / {gen / s_off:.1f} tok/s ({smi_line()})")
    return on


def check_starved_pool(torch, model, params, cfg):
    """8c: a pool of ``STARVED_PAGES`` pages against the full one on a
    trace of long prompts in two priority classes: preemptions, every one
    resumed, every request ok with the full pool's tokens."""
    from repro_torch.serving import ServingEngine, synthetic_trace

    tr = dict(STARVED_TRACE)
    trace = lambda: synthetic_trace(tr["seed"], tr["n"],
                                    vocab_size=cfg.vocab_size,
                                    **{k: v for k, v in tr.items()
                                       if k not in ("seed", "n")})
    full = ServingEngine(model, params, cfg, **ENGINE)
    res_full, _ = served_engine(torch, full, trace(), "8c full pool")
    starved = ServingEngine(model, params, cfg, num_pages=STARVED_PAGES,
                            **ENGINE)
    res, secs = served_engine(torch, starved, trace(), "8c starved pool")
    st = starved.stats
    assert st["preempted"] > 0, "8c: nothing was preempted"
    assert st["resumed"] == st["preempted"], (
        f"8c: {st['resumed']} of {st['preempted']} preempted resumed")
    for rid, r in res_full.items():
        assert res[rid].status == "ok", f"8c: request {rid}: {res[rid].status}"
        assert res[rid].tokens == r.tokens, f"8c: request {rid}: tokens"
    starved.check_invariants()
    log(f"  8c starved pool ({STARVED_PAGES} of {full.pool.num_pages} pages): "
        f"{st['preempted']} preempted, {st['resumed']} resumed, 16/16 ok "
        f"with the full pool's tokens; engine ticks {st['engine_steps']} / "
        f"{full.stats['engine_steps']} (starved / full), "
        f"{st['generated_tokens'] / secs:.1f} tok/s")


def check_deadlines(torch, model, params, cfg):
    """8e: phase 4's trace with deadlines, fast and stepwise: the same
    requests expire at the same ticks with the same tokens."""
    from repro_torch.serving import ServingEngine, synthetic_trace

    out = {}
    for fast in (True, False):
        engine = ServingEngine(model, params, cfg, fast=fast, **ENGINE)
        trace = synthetic_trace(
            SERVE["trace_seed"], SERVE["trace"], vocab_size=cfg.vocab_size,
            prompt_lens=(SERVE["prompt_min"], SERVE["prompt_len"]),
            gen_lens=(SERVE["gen_min"], SERVE["gen_len"]),
            mean_interarrival=1.0, deadline_slack=DEADLINE_SLACK)
        out[fast] = served_engine(torch, engine, trace,
                                  f"8e fast={fast}", warm=fast)[0]
    for rid, r in out[False].items():
        got = out[True][rid]
        assert (got.status, got.finished_at, got.tokens) == (
            r.status, r.finished_at, r.tokens), f"8e: request {rid}"
    expired = sorted(rid for rid, r in out[True].items()
                     if r.status == "expired")
    assert expired, "8e: no request expired"
    log(f"  8e deadlines {DEADLINE_SLACK[0]:g}-{DEADLINE_SLACK[1]:g} ticks "
        f"after arrival: fast and stepwise expire the same {len(expired)} "
        f"requests ({expired}) at the same ticks with the same tokens")


def check_chaos(torch):
    """8d: ``run_chaos`` under ``FaultPlan.seeded`` at the chaos CLI's
    settings (serve-w8a16 over the smoke model's weights drawn on the
    host), on the card and on the CPU: invariants checked after every step,
    0 leaked pages, the unfaulted requests the card's fault-free tokens,
    and outcomes, counters and steps the CPU's; launches exact."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (FaultPlan, ServingEngine,
                                     assert_unfaulted_parity, run_chaos,
                                     synthetic_trace)

    cfg = dataclasses.replace(repro_torch.get_config("qwen2-0.5b", smoke=True),
                              name="qwen2-chaos-smoke")
    model = repro_torch.build_model(cfg)
    params = model.init(0, device="cpu")
    trace = synthetic_trace(0, 24, vocab_size=cfg.vocab_size,
                            prompt_lens=(4, 16), gen_lens=(4, 16),
                            mean_interarrival=1.0, priority_levels=2)
    plan = lambda: FaultPlan.seeded(0, [r.rid for r in trace], n_steps=40)
    reports = {}
    for device in ("cpu", "cuda"):
        qm = repro_torch.quantize(model, params, device=device,
                                  recipe="serve-w8a16")
        kw = dict(CHAOS, device=device)
        clean = ServingEngine(qm.model, qm.params, qm.cfg, **kw).run(
            [dataclasses.replace(r) for r in trace])
        engine = ServingEngine(qm.model, qm.params, qm.cfg,
                               num_pages=CHAOS_PAGES, **kw)
        reset_launch_counts()
        report = run_chaos(engine, [dataclasses.replace(r) for r in trace],
                           plan())
        counts = launch_counts()
        compared = assert_unfaulted_parity(report, clean,
                                           plan().faulted_rids())
        assert report.leaked_pages == 0, f"8d {device}: pages leaked"
        reports[device] = report
        if device == "cuda":
            masked = engine._masked_forwards
            want = expected_launches(
                "w8a16", True, engine.stats["decode_steps"]
                + masked["decode_steps"], engine.stats["prefill_dispatches"]
                + masked["prefill_dispatches"], cfg=cfg, kv_bits=16,
                slots=CHAOS["num_slots"], chunk=CHAOS["prefill_chunk"])
            for name, n in counts.items():
                assert n == want.get(name, 0), (
                    f"8d: {name} launched {n} times, expected "
                    f"{want.get(name, 0)}")
            assert counts["qmatmul_w8a16"] > 0
    card, cpu = reports["cuda"], reports["cpu"]
    drop = lambda c: {k: v for k, v in c.items() if k != "straggler_steps"}
    assert card.outcomes == cpu.outcomes, "8d: outcomes differ from the CPU's"
    assert drop(card.counts) == drop(cpu.counts), (
        f"8d: counts {card.counts} against the CPU's {cpu.counts}")
    assert card.steps == cpu.steps, "8d: steps differ from the CPU's"
    log(f"  8d chaos (the CLI's settings, {CHAOS_PAGES}-page pool, "
        f"FaultPlan.seeded(0)): {card.steps} steps, invariants held every "
        f"step, {compared} unfaulted requests with the fault-free tokens, "
        f"0 leaked pages; outcomes, counts and steps the CPU's: "
        f"{json.dumps(drop(card.counts))}")


def graph_ms(torch, fn, iters: int = 50) -> float:
    """Device time of ``fn`` captured in a CUDA graph, as the fast path
    runs it (one replay a call: the host enqueues ahead of the card)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return device_ms(graph.replay, iters)


def time_gather(torch):
    """The dense view's memory and the device time of the gather and of a
    horizon's commit at phase 4's shape (8 slots x 512 positions, 24
    layers, pages of 32), each captured in a graph as the fast path runs
    it, for the bf16 and the int8 cache, beside the bytes bound (the view
    read from the pages and written once)."""
    import repro_torch
    from repro_torch.serving import CachePool
    from repro_torch.serving.engine import _paged_commit, _paged_view

    model = repro_torch.build_model(repro_torch.get_config(SERVE["arch"]))
    B, S, pg = SERVE["slots"], SERVE["max_len"], PAGED["page_size"]
    for kv_bits in (16, 8):
        pool = CachePool(model, B, S, device="cuda", kv_bits=kv_bits,
                         page_size=pg)
        for slot in range(B):
            pool.allocate_pages(S)
        dense = {n: torch.empty((s.shape[0], B, S) + tuple(s.shape[3:]),
                                dtype=s.dtype, device="cuda")
                 for n, s in pool.storage.items()}
        view = sum(t.numel() * t.element_size() for t in dense.values())
        gather = graph_ms(torch, lambda: _paged_view(pool, dense))
        rows = torch.arange(8, device="cuda").repeat(B, 1)
        commit = graph_ms(torch, lambda: _paged_commit(pool, dense, rows))
        bound = 2 * view / HBM_BYTES_S * 1e3
        log(f"  paged gather, {'bf16' if kv_bits == 16 else 'int8'} cache: "
            f"dense view {view / 2**20:.2f} MiB (pool "
            f"{pool.cache_bytes() / 2**20:.2f} MiB), gather {gather * 1e3:.1f}"
            f" us [bound {bound * 1e3:.1f} us, bytes], a horizon's commit "
            f"(8 x 8 positions) {commit * 1e3:.1f} us ({smi_line()})")


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if os.environ.get("REPRO_KERNEL_BACKEND"):
        print("chip_smoke: REPRO_KERNEL_BACKEND is set "
              f"({os.environ['REPRO_KERNEL_BACKEND']!r}); this script picks "
              "every kernel tier by explicit argument — unset it",
              file=sys.stderr)
        return 2
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
    from repro_torch.kernels import _build

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
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Function properties for" in line):
            log("  " + line.strip())

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {"quantize_act": check_quantize_act(torch, dev, gen),
              "qmatmul_w8a8": check_qmatmul(torch, dev, gen),
              "qmatmul_w8a16": check_qmatmul_w8a16(torch, dev, gen),
              "fused_decode": check_fused_decode(torch, dev, gen),
              "kv_attention": check_kv_attention(torch, dev, gen)}
    check_fused_equals_unfused(torch, dev, gen)
    check_attention_sweep(torch, dev, gen)
    check_queue_c(torch, dev, gen)
    tables["qmatmul_w8a8_q8"] = check_qmatmul_w8a8_q8(torch, dev, gen)
    tables["qmatmul_w8a16_q8"] = check_qmatmul_w8a16_q8(torch, dev, gen)
    tables["qmatmul_w8a8_qin"] = check_qmatmul_w8a8_qin(torch, dev, gen)
    check_split_sweep(torch, dev, gen)
    for name, rows in tables.items():
        if name == "qmatmul_w8a8_qin":
            continue  # logged by its check, fold beside pair
        for r in rows:
            log_row(name, r)
    log_step_sums(tables)
    check_new_attention(torch, dev, gen)
    check_new_gemms(torch, dev, gen)

    log("== phase 3: small-input reference")
    for recipe in ("serve-w8a16-kv8", "serve-w8a8-kv8", "dfq-int8",
                   "naive-int8", "cle-only", BC_DEPLOY):
        check_reference(torch, dev, recipe)
    check_hostile_gate(torch, dev)
    # the fp KV cache (the reference's default deployment), the
    # unquantized model, every new arch through serve-w8a16-kv8, and the
    # plain tier on the card by explicit argument
    for recipe in ("serve-w8a16", "serve-w8a8"):
        check_reference(torch, dev, recipe, kv_bits=16)
    check_smoke_serving(torch, "qwen2-0.5b", "w8a16", None)
    check_smoke_serving(torch, "qwen2-0.5b", "w8a8", None)
    check_smoke_serving(torch, "qwen2-0.5b", "none", None)
    for arch in ("yi-34b", "mistral-nemo-12b", "gemma-7b", "chameleon-34b"):
        check_smoke_serving(torch, arch, "w8a16", 8)
    check_torch_tier_on_card(torch)

    log("== phase 4: serve qwen2-0.5b (full width) through repro_torch.serve")
    log(f"  {smi}")
    runs, stepwise = {}, {}
    for quantize in ("w8a16", "w8a8"):
        stepwise[quantize] = serve_full_width(torch, quantize,
                                              reference=True)[0]
        runs[quantize] = serve_full_width(torch, quantize)
        same_tokens(runs[quantize][0], stepwise[quantize],
                    f"serve-{quantize}-kv8 fast against stepwise")
        log(f"  serve-{quantize}-kv8: every request's tokens and finish tick "
            f"equal the stepwise run's")
    for quantize in ("w8a16", "w8a8"):
        run, counts = serve_full_width(torch, quantize, fused=False)
        same_tokens(run, runs[quantize][0],
                    f"serve-{quantize}-kv8 unfused against fused")
        log(f"  serve-{quantize}-kv8 unfused: every request's tokens equal "
            f"the fused run's")
        runs[quantize + " unfused"] = run, counts
    runs["w8a8 kv_bias_correct"], bc_stepwise = serve_bias_corrected(torch)
    stepwise["w8a8 kv_bias_correct"] = bc_stepwise[0]
    speeds = [f"{label} {run.tokens_per_second:.1f}"
              for label, (run, _) in runs.items()]
    log("  fast tok/s in run order: " + ", ".join(speeds) + f" ({smi})")
    log("  tok/s fast / stepwise: " + ", ".join(
        f"{label} {runs[label][0].tokens_per_second:.1f} / "
        f"{run.tokens_per_second:.1f}" for label, run in stepwise.items())
        + f" ({smi})")
    # an extra, untimed fast run of the default recipe under torch.profiler:
    # the device busy share of the serving loop
    prof_run, _ = serve_full_width(torch, "w8a16", profile=True)
    busy = prof_run.busy_share
    log(f"  device busy share of the profiled fast w8a16 loop: "
        + ("not measured (the profiler recorded no device time)"
           if busy is None else f"{busy * 100:.1f} %")
        + f" over {prof_run.seconds:.3f} s ({smi})")

    log("== phase 5: DFQ of qwen2-0.5b (full width) and its bias-corrected "
        "w8a8 deployment saved, loaded and served")
    log(f"  {smi}")
    model, params = dfq_full_width(torch, dev)
    bc_fast, bc_stepwise = serve_saved_deployment(torch, dev, model, params)
    del model, params
    log(f"  tok/s fast / stepwise: bias-corrected w8a8 --load "
        f"{bc_fast.tokens_per_second:.1f} / {bc_stepwise.tokens_per_second:.1f}"
        f", phase 4's serve-w8a8-kv8 {runs['w8a8'][0].tokens_per_second:.1f} / "
        f"{stepwise['w8a8'].tokens_per_second:.1f} ({smi})")

    log("== phase 6: serve mistral-nemo-12b (full width) through "
        "repro_torch.serve")
    log(f"  {smi}")
    t6 = time.perf_counter()
    depth = nemo_depth(torch, dev)
    nemo = {}
    for quantize, kv_bits in (("w8a16", None), ("w8a8", 8)):
        step = serve_nemo(torch, depth, quantize, kv_bits, reference=True)
        fast = serve_nemo(torch, depth, quantize, kv_bits, reference=False)
        label = f"serve-{quantize}" + ("-kv8" if kv_bits else " (bf16 KV)")
        same_tokens(fast, step, f"mistral-nemo-12b {label} fast against "
                                f"stepwise")
        nemo[label] = fast, step
        log(f"  mistral-nemo-12b {label}: every request's tokens and finish "
            f"tick equal the stepwise run's")
    log("  mistral-nemo-12b tok/s fast / stepwise: " + ", ".join(
        f"{label} {f.tokens_per_second:.1f} / {s.tokens_per_second:.1f}"
        for label, (f, s) in nemo.items())
        + f" ({depth} layers; {smi})")
    log(f"  phase 6 took {time.perf_counter() - t6:.1f} s")

    log("== phase 7: the paper's CNN flow (BN folding, CLE, high-bias "
        "absorption, bias correction) trained and quantized on the card")
    log(f"  {smi}")
    t7 = time.perf_counter()
    cnn_paper_tables(torch, dev, smi)
    mobilenet_v2_published(torch, dev, smi)
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    log("== phase 8: serve qwen2-0.5b (full width) from the paged pool: "
        "prefix reuse, preemption, chaos, deadlines")
    log(f"  {smi}")
    t8 = time.perf_counter()
    check_paged_serving(torch, runs, stepwise)
    import repro_torch

    qm = repro_torch.quantize(repro_torch.build_model(
        repro_torch.get_config(SERVE["arch"])), None, init_seed=SERVE["seed"],
        device="cuda", recipe="serve-w8a16")
    check_prefix_reuse(torch, qm.model, qm.params, qm.cfg)
    check_starved_pool(torch, qm.model, qm.params, qm.cfg)
    check_deadlines(torch, qm.model, qm.params, qm.cfg)
    del qm
    check_chaos(torch)
    time_gather(torch)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s ({smi})")

    # each kernel's launches come from the run of the path it serves; the
    # fused decode from the default (w8a16) path, kv_attention from the
    # default recipe's unfused route; the quantize-out GEMMs are on no
    # serving path (quantize_out=True only), so the w8a8 run counts them 0;
    # quantize_act's are the w8a8 prefill chunks' (decode folds it into
    # qmatmul_w8a8: the qmatmul_w8a8_qin entry)
    main = {"quantize_act": ("x[8,896] bfloat16", "w8a8"),
            "qmatmul_w8a8_qin": ("M=8 K=896 N=4864 bf16 -> bf16", "w8a8"),
            "qmatmul_w8a8": ("M=8 K=896 N=4864 -> bf16", "w8a8"),
            "qmatmul_w8a16": ("M=8 K=896 N=4864 bfloat16", "w8a16"),
            "fused_decode": ("B=8 Hq=14 Hkv=2 hd=64 S=512 bfloat16", "w8a16"),
            "kv_attention": ("B=8 Hq=14 Hkv=2 hd=64 S=512 bfloat16",
                             "w8a16 unfused"),
            "qmatmul_w8a8_q8": ("M=8 K=896 N=4864", "w8a8"),
            "qmatmul_w8a16_q8": ("M=8 K=896 N=4864 bfloat16", "w8a8")}
    csrc = "src/repro_torch/csrc/"
    tpu = "src/repro/kernels/"
    sources = {"quantize_act": ("quantize_act.cu", "quantize_act/kernel.py:27"),
               "qmatmul_w8a8": ("qmatmul_w8a8.cu", "qmatmul_w8a8/kernel.py:72"),
               "qmatmul_w8a16": ("qmatmul_w8a16.cu",
                                 "qmatmul_w8a16/kernel.py:64"),
               "fused_decode": ("fused_decode.cu", "fused_decode/kernel.py:143"),
               "kv_attention": ("kv_attention.cu", "kv_attention/kernel.py:95"),
               "qmatmul_w8a8_q8": ("qmatmul_w8a8.cu",
                                   "qmatmul_w8a8/kernel.py:143"),
               "qmatmul_w8a16_q8": ("qmatmul_w8a16.cu",
                                    "qmatmul_w8a16/kernel.py:127"),
               "qmatmul_w8a8_qin": ("qmatmul_w8a8.cu",
                                    "quantize_act/kernel.py:27")}
    notes = {"quantize_act": {"decode": "folded into qmatmul_w8a8 "
                              "(qmatmul_w8a8_qin) wherever gemm_plan folds: "
                              "0 launches a decode step; launches are the "
                              "prefill chunks'"},
             "qmatmul_w8a8_qin": {"fuses": tpu + "qmatmul_w8a8/kernel.py:72"}}
    kernels = []
    for name, rows in tables.items():
        shape, path = main[name]
        row = next(r for r in rows if r["shape"] == shape)
        kernels.append({
            # the plan's split, share, tile, ticket, waiter and residency
            # counts are not measured: log only
            **{k: v for k, v in row.items()
               if k not in ("splits", "share", "tickets", "bm", "waiters",
                            "residency")},
            **notes.get(name, {}),
            # the contract's keys, last so that no row key replaces them
            "name": name, "route": "cuda",
            "source": csrc + sources[name][0],
            "replaces": tpu + sources[name][1],
            "launches": runs[path][1][name],
            "path": ("none: quantize_out=True only"
                     if name.endswith("_q8") else path)})
    log(f"  the script took {time.perf_counter() - t_script:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
