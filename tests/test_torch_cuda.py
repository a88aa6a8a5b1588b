"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside its body whether the host has a
card and skips with a reason when it has none (a CUDA kernel has no
interpret mode). On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py:

  * quantize_act and qmatmul_w8a8 bit-equal;
  * qmatmul_w8a16 within E = ``16 · sqrt(K) · 2⁻²⁴ · sqrt(a² @ w_deq²)
    + 2⁻²² · (|y| + |bias|)`` in float32 — the random-walk size of the
    rounding of two float32 sums of the same products, which a TF32
    product exceeds (checked) — and E plus one bf16 ulp in bfloat16 (the
    kernel applies the scale after the sum, the plain version before it;
    one ulp alone fails where the sum cancels);
  * ``repro_torch.quantize`` on the card bit-equal to the same call on the
    CPU, but ``bo`` (a matrix product's rounding bound); under dfq-int8,
    naive-int8, cle-only and the bias-corrected w8a8 deployment every
    weight leaf bit-equal, E[x] within 2⁻¹⁶ of its max and each corrected
    bias within |δ| @ |ε| + 2·D·2⁻²⁴·(|E[x]| @ |ε|) plus one ulp; that
    deployment saved, loaded bit-equal and served from ``--load``, fast
    and stepwise giving the same tokens;
  * fused_decode's appended cache bit-equal, its float32 output within
    T = atol 1e-6 + rtol 1e-5 and its bfloat16 output within T plus one
    bf16 ulp (one ulp alone fails near zero), its quantize-out bit-equal to
    quantize_act of the kernel's own output and off the plain version's by
    one only at a rounding tie (or, in bfloat16, where that output element
    moved);
  * kv_attention (with and without v_err) within fused_decode's bound of
    its plain version, a fully masked row exactly 0; fused_decode
    bit-equal to append_quantize + the kv_attention kernel (+ the
    quantize_act kernel);
  * the quantize-out GEMMs in one launch, on both routes and at bits 4
    and 8: qmatmul_w8a8's payload and scale bit-equal to its plain version
    and to the W8A8 kernel to float32 followed by the quantize_act kernel;
    qmatmul_w8a16's with float32 a bit-equal to that pair of its own
    kernels, with bfloat16 a at most one step off its plain version;
  * both GEMMs under forced K splits (the wrappers' private ``_splits``):
    the same bounds at every split, one launch a call, and two calls the
    same bits;
  * both decode attention kernels under forced S splits: kv_attention
    within fused_decode's bound at every split, two calls the same bits,
    fused_decode bit-equal to the composition at the same split;
  * the quantize-in W8A8 GEMM (quantize_act folded into the GEMM, one
    launch) bit-equal to quantize_act followed by qmatmul_w8a8 at every
    split that fits, in bfloat16 and float32, on ragged shapes, .5 ties
    and an all-zero row; the wrapper refuses CPU tensors and a slice that
    does not fit its shared memory;
  * the calls the CUDA tiers once refused, against the torch tier:
    kv_attention's float32 out from bfloat16 q within the bound (its bf16
    cast bit-equal to the kernel's bf16 out), fused_decode's shared idx [1]
    bit-equal to the same offset per slot, fused_decode's float32
    quantize-out from bfloat16 q bit-equal to quantize_act of its out, and
    quantize_act at fewer than 8 bits bit-equal;
  * the serving engine's fast path: each replayed CUDA graph (a decode
    horizon, the batched prefill) bit-equal to the same dispatch run
    eagerly on a copy of the pool (tokens, bad flags, every cache leaf),
    the stream scratch zero after a whole fast run, replays counting what
    their capture counted, and the fast path serving the stepwise path's
    tokens and ticks;
  * the paged pool: each replayed paged graph (the gather into the dense
    view, the forward, the commit) bit-equal to the same dispatch run
    eagerly, every page and the bookkeeping included; the gather and the
    commit on the card bit-equal to the CPU's, the dropped writes in the
    sink page and nowhere else; copy-on-write on the card the CPU's pages;
    paged serving (reuse off and on, warmup included) the contiguous
    tokens and ticks.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card only")
    return torch.device("cuda", 0)


def test_quantize_act_kernel_bit_equal(dev):
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((13, 77), device=dev) * 4).to(dtype)
        q, s = quantize_act(x)
        qr, sr = quantize_act_ref(x)
        assert torch.equal(q, qr) and torch.equal(s, sr)


# ragged shapes whose K the planner splits (S > 1): K = 4100 (65 steps of
# 64, not a multiple of S * 64), M on both sides of the decode tile's 16
SPLIT_CASES = ((3, 4100, 70), (17, 2100, 100), (8, 1600, 33), (70, 3000, 130))


def test_qmatmul_kernel_bit_equal_ragged(dev):
    from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8, qmatmul_w8a8_ref

    for M, K, N in ((1, 16, 8), (5, 33, 17), (40, 96, 72)) + SPLIT_CASES:
        a = torch.randint(-128, 128, (M, K), device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8).t()
        sa, sw = torch.rand(M, device=dev), torch.rand(N, device=dev)
        bias = torch.randn(N, device=dev)
        y = qmatmul_w8a8(a, w, sa, sw, bias)
        assert torch.equal(y, qmatmul_w8a8_ref(a, w, sa, sw, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_kernel_against_plain(dev, dtype):
    """The appended cache bit-equal, the fully masked row exactly 0 and the
    quantize-out bit-equal to quantize_act of the kernel's own out in every
    draw. Cache scales at the serving range (x 0.02): out within its bound
    of the plain version, the quantize-out off it only at a rounding tie.
    Cache scales U(0, 1): scores reach ~100, where one float32 ulp of a
    score moves its softmax weight by ~1e-5, so the float32 plain version
    itself leaves that bound around the exact value in many draws, and a
    kernel that sums in another order can only be held to the rounding
    error such a call may make. There the kernel and the plain version are
    both held to a float64 evaluation of the same function, within E, the
    first-order size of float32 rounding (``_fused_decode_float64``), plus
    one bf16 ulp in bfloat16; the quantize-out off the float64 one only
    where a rounding tie lies between the two. A control must fail that
    bound: in float32, the plain version with q rounded to bfloat16 does in
    at least 10 of the 12 draws."""
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
    from repro_torch.kernels.quantize_act import quantize_act_ref

    B, Hq, Hkv, hd, S = 3, 4, 2, 16, 33
    gen = torch.Generator(device=dev).manual_seed(16)
    control_fails = 0
    for scale in (0.02,) * 2 + (1.0,) * 12:
        leaves = []
        for _ in range(2):
            leaves.append(torch.randint(-127, 128, (B, S, Hkv, hd),
                                        device=dev, dtype=torch.int8,
                                        generator=gen))
            leaves.append(torch.rand((B, S, Hkv), device=dev, generator=gen)
                          * scale)
        q, kn, vn = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                     for shape in ((B, Hq, hd), (B, 1, Hkv, hd),
                                   (B, 1, Hkv, hd)))
        idx = torch.tensor([[S - 1], [4], [0]], device=dev)
        valid = torch.arange(S, device=dev)[None] <= idx
        valid[2] = False
        mine = [t.clone() for t in leaves]
        ref = [t.clone() for t in leaves]
        (out, oq, os_), _ = fused_decode(q, *mine, kn, vn, idx, valid=valid,
                                         out_dtype=dtype, quantize_out=True)
        (outr, oqr, osr), _ = fused_decode_ref(q, *ref, kn, vn, idx,
                                               valid=valid, out_dtype=dtype,
                                               quantize_out=True)
        for a, b in zip(mine, ref):
            assert torch.equal(a, b)
        assert float(out[2].abs().max()) == 0.0
        o, r = out.float().reshape(B, -1), outr.float().reshape(B, -1)
        qs, ss = quantize_act_ref(o)             # the epilogue's own formula
        assert torch.equal(oq, qs) and torch.equal(os_, ss)
        if scale < 1.0:
            diff = (o - r).abs()
            assert bool((diff <= _out_tolerance(r, dtype)).all())
            dq = (oq.int() - oqr.int()).abs()
            tie = ((r / osr[:, None]).abs() % 1.0 - 0.5).abs() < 1e-3
            allowed = tie | (diff > 0) if dtype == torch.bfloat16 else tie
            assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~allowed).any())
            continue
        o64, err = (t[:2].reshape(2, -1)
                    for t in _fused_decode_float64(q, ref, valid, Hkv))
        if dtype == torch.bfloat16:
            _, e = torch.frexp((o64.abs() + err).clamp_min(2.0 ** -126))
            err = err + torch.ldexp(torch.ones_like(err), e - 8)
        for name, x in (("kernel", o), ("plain", r)):
            worst = float(((x[:2].double() - o64).abs() / err).max())
            assert worst <= 1.0, (name, worst)
        if dtype == torch.float32:
            (oc, _, _), _ = fused_decode_ref(
                q.bfloat16().float(), *[t.clone() for t in leaves], kn, vn,
                idx, valid=valid, out_dtype=dtype, quantize_out=True)
            oc = oc.reshape(B, -1)[:2].double()
            control_fails += float(((oc - o64).abs() / err).max()) > 1.0
        s64 = o64.abs().amax(-1).clamp_min(1e-8) / 127
        x64 = o64 / s64[:, None]
        x = o[:2].double() / os_[:2, None].double()
        dq = (oq[:2].double() - torch.round(x64).clamp(-128, 127)).abs()
        tie = ((x64.abs() % 1.0) - 0.5).abs() <= (x - x64).abs() + 1e-3
        assert int(dq.max()) <= 1 and not bool(((dq > 0) & ~tie).any())
    assert control_fails >= 10 or dtype == torch.bfloat16, control_fails


def _fused_decode_float64(q, cache, valid, Hkv):
    """fused_decode's out [B, Hq, hd] in float64 over the cache after the
    append (a position whose effective K scale, the stored one where
    ``valid`` and else 0, is 0 is masked; V scale 0 adds nothing), and E,
    the first-order size of the rounding a float32 evaluation in any sum
    order may make, u = 2⁻²⁴:

        E = Σ_t p_t ε_t |v_t − out| + (S + 16) u (Σ_t p_t |v_t| + |out|),
        ε_t = hd u Σ_d |q_d k_td| ks_t / sqrt(hd) + u (4 |s_t| + 4 max|s| + 16)

    the score's dot product, its scaling, the softmax's max, exponent and
    rescales moving p_t by at most ε_t relative, and the sums of l and acc
    and the division at most (S + 16) u relative; plus (S + 16) 2⁻¹⁴⁹
    (1 + max|v|) for the weights and products that fall below float32's
    normal range (a weight of e⁻¹⁰⁰ is one, at scores ~100)."""
    u = 2.0 ** -24
    B, Hq, hd = q.shape
    S = cache[0].shape[1]
    kq, ks, vq, vs = (t.double() for t in cache)
    live = valid[..., None]
    ks, vs = ks * live, vs * live
    qg = q.double().reshape(B, Hkv, Hq // Hkv, hd)
    k, v = kq * ks[..., None], vq * vs[..., None]          # [B, S, Hkv, hd]
    sc = torch.einsum("bngd,bknd->bngk", qg, k) / hd ** 0.5
    dot = torch.einsum("bngd,bknd->bngk", qg.abs(), k.abs()) / hd ** 0.5
    mask = (ks > 0).permute(0, 2, 1)[:, :, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, -1)
    out = torch.einsum("bngk,bknd->bngd", p, v)
    s_abs = torch.where(mask, sc.abs(), torch.zeros_like(sc))
    eps = hd * u * dot + u * (4 * s_abs + 4 * s_abs.amax(-1, keepdim=True)
                              + 16)
    spread = (v.permute(0, 2, 1, 3)[:, :, None] - out[:, :, :, None]).abs()
    v_max = v.abs().amax((1, 3))[:, :, None, None]          # [B, Hkv, 1, 1]
    err = (torch.einsum("bngk,bngkd->bngd", p * eps, spread)
           + (S + 16) * u * (torch.einsum("bngk,bknd->bngd", p, v.abs())
                             + out.abs())
           + (S + 16) * 2.0 ** -149 * (1 + v_max))
    return out.reshape(B, Hq, hd), err.reshape(B, Hq, hd)


def _out_tolerance(r, dtype):
    """fused_decode's bound: T = atol 1e-6 + rtol 1e-5, plus one bf16 ulp
    of |r| + T in bfloat16."""
    tol = 1e-6 + 1e-5 * r.abs()
    if dtype == torch.bfloat16:
        _, e = torch.frexp((r.abs() + tol).clamp_min(2.0 ** -126))
        tol = tol + torch.ldexp(torch.ones_like(r), e - 8)
    return tol


def _cache(dev, B, S, Hkv, hd, gen):
    def payload():
        return torch.randint(-127, 128, (B, S, Hkv, hd), device=dev,
                             dtype=torch.int8, generator=gen)

    def scales():
        return torch.rand((B, S, Hkv), device=dev, generator=gen) * 0.02
    return payload(), scales(), payload(), scales()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_attention_kernel_against_plain(dev, dtype):
    """S = 33 against the plain version's blk = 32 and blk = 512 (S < blk),
    GQA 2 and 4, with and without v_err (zero where the scales are, as
    kv_attention_decode passes it); a row whose scales are all 0 gives
    exactly 0; one launch per call."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.kv_attention import kv_attention, kv_attention_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    for B, Hq, Hkv, hd, S in ((3, 4, 2, 16, 33), (2, 8, 2, 32, 70)):
        kq, ks, vq, vs = _cache(dev, B, S, Hkv, hd, gen)
        ks[1, S // 2:] = 0                                 # a ragged row
        vs[1, S // 2:] = 0
        ks[B - 1] = 0                                      # a masked row
        vs[B - 1] = 0
        q = torch.randn((B, Hq, hd), device=dev, generator=gen).to(dtype)
        v_err = torch.where(ks > 0, torch.randn(
            (B, S, Hkv), device=dev, generator=gen) * 1e-3, 0.0)
        for ve in (None, v_err):
            for blk in (32, 512):
                reset_launch_counts()
                out = kv_attention(q, kq, ks, vq, vs, blk=blk, out_dtype=dtype,
                                   v_err=ve)
                assert launch_counts()["kv_attention"] == 1
                r = kv_attention_ref(q, kq, ks, vq, vs, dtype, blk=blk,
                                     v_err=ve)
                diff = (out.float() - r.float()).abs()
                assert bool((diff <= _out_tolerance(r.float(), dtype)).all()), (
                    B, Hq, S, blk, ve is None, float(diff.max()))
                assert float(out[B - 1].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_equals_the_composition_bitwise(dev, dtype):
    """fused_decode against append_quantize + the kv_attention kernel + the
    quantize_act kernel: the shared attention body gives the same bits."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_decode import fused_decode
    from repro_torch.kernels.kv_attention import kv_attention_decode
    from repro_torch.kernels.quantize_act import quantize_act

    gen = torch.Generator(device=dev).manual_seed(1)
    B, Hq, Hkv, hd, S = 4, 8, 2, 32, 100
    leaves = _cache(dev, B, S, Hkv, hd, gen)
    q = torch.randn((B, Hq, hd), device=dev, generator=gen).to(dtype)
    kn = torch.randn((B, 1, Hkv, hd), device=dev, generator=gen).to(dtype)
    vn = torch.randn((B, 1, Hkv, hd), device=dev, generator=gen).to(dtype)
    idx = torch.tensor([[S - 1], [7], [0], [64]], device=dev)
    valid = torch.arange(S, device=dev)[None] <= idx
    valid[2] = False
    fused = [t.clone() for t in leaves]
    comp = [t.clone() for t in leaves]
    reset_launch_counts()
    (out, oq, os_), _ = fused_decode(q, *fused, kn, vn, idx, valid=valid,
                                     out_dtype=dtype, quantize_out=True)
    outc, _ = kv_attention_decode(q, *comp, kn, vn, idx, valid=valid,
                                  out_dtype=dtype)
    oqc, osc = quantize_act(outc.reshape(B, -1))
    counts = launch_counts()
    assert (counts["fused_decode"], counts["kv_attention"],
            counts["quantize_act"]) == (1, 1, 1)
    for a, b in zip(fused, comp):
        assert torch.equal(a, b)
    assert torch.equal(out, outc)
    assert torch.equal(oq, oqc) and torch.equal(os_, osc)


# the quantize-out GEMMs' card cases: several M and N tiles, N odd and N %
# 4 == 2 (the workspace route's scalar path), K splits at the decode tile
# (4100: 65 steps) and at a 64-row tile (2100)
Q8_CASES = ((1, 16, 8), (5, 33, 17), (70, 96, 130), (8, 896, 256),
            (3, 4100, 70), (17, 2100, 102))


def test_qmatmul_q8_kernels_one_launch_bit_equal(dev):
    """Both quantize-out GEMMs at ragged shapes (several M and N tiles, N
    not a multiple of 4, K splits), each called twice so the second call
    finds its scratch left zero: one launch per call; qmatmul_w8a8's payload
    and scale bit-equal to its plain version and to the kernel pair
    (float32 GEMM, then quantize_act); qmatmul_w8a16's bit-equal to its own
    pair for float32 a and at most one step off its plain version for
    bfloat16 a, its scale within rtol 1e-4 there (float32 sums in other
    orders). Then both routes (the plan's, resident at these shapes, and
    the workspace route forced by ``_route``) at bits 4 and 8, held the
    same way with the pair and the plain version at those bits, two calls
    the same bits."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8 import (
        qmatmul_w8a8,
        qmatmul_w8a8_q8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_q8_cuda,
        qmatmul_w8a8_q8_plan,
    )
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_q8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_q8_cuda
    from repro_torch.kernels.quantize_act import quantize_act

    def twice(fn):
        first, second = fn(), fn()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        return first

    gen = torch.Generator(device=dev).manual_seed(2)
    for M, K, N in Q8_CASES:
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                          generator=gen).t()
        sw = torch.rand(N, device=dev, generator=gen) * 0.01 + 1e-4
        bias = torch.randn(N, device=dev, generator=gen)
        a_q = torch.randint(-128, 128, (M, K), device=dev, dtype=torch.int8,
                            generator=gen)
        sa = torch.rand(M, device=dev, generator=gen) * 0.05 + 1e-4
        assert qmatmul_w8a8_q8_plan(M, N, K).q8_route == "resident"
        y8 = qmatmul_w8a8(a_q, w, sa, sw, bias)
        pair = quantize_act(y8)
        want = qmatmul_w8a8_q8_ref(a_q, w, sa, sw, bias)
        for _ in range(2):
            reset_launch_counts()
            q, s = qmatmul_w8a8(a_q, w, sa, sw, bias, quantize_out=True)
            assert launch_counts()["qmatmul_w8a8_q8"] == 1
            assert launch_counts()["qmatmul_w8a8"] == 0
            for got in (pair, want):
                assert torch.equal(q, got[0]) and torch.equal(s, got[1])
        for route in ("resident", "workspace"):
            for bits in (4, 8):
                q, s = twice(lambda: qmatmul_w8a8_q8_cuda(
                    a_q, w, sa, sw, bias, bits=bits, _route=route))
                for got in (quantize_act(y8, bits=bits),
                            qmatmul_w8a8_q8_ref(a_q, w, sa, sw, bias, bits)):
                    assert torch.equal(q, got[0]) and torch.equal(s, got[1]), (
                        M, K, N, route, bits)
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((M, K), device=dev, generator=gen).to(dtype)
            for _ in range(2):
                reset_launch_counts()
                q, s = qmatmul_w8a16(a, w, sw, bias, quantize_out=True)
                assert launch_counts()["qmatmul_w8a16_q8"] == 1
                assert launch_counts()["qmatmul_w8a16"] == 0
                if dtype == torch.float32:
                    qp, sp = quantize_act(qmatmul_w8a16(a, w, sw, bias))
                    assert torch.equal(q, qp) and torch.equal(s, sp)
                else:
                    qr, sr = qmatmul_w8a16_q8_ref(a, w, sw, bias)
                    assert int((q.int() - qr.int()).abs().max()) <= 1
                    assert bool(((s - sr).abs() <= 1e-4 * sr).all())
            y16 = qmatmul_w8a16(a, w, sw, bias) if dtype == torch.float32 else None
            for route in ("resident", "workspace"):
                for bits in (4, 8):
                    q, s = twice(lambda: qmatmul_w8a16_q8_cuda(
                        a, w, sw, bias, bits=bits, _route=route))
                    if dtype == torch.float32:
                        qp, sp = quantize_act(y16, bits=bits)
                        assert torch.equal(q, qp) and torch.equal(s, sp), (
                            M, K, N, route, bits)
                    else:
                        qr, sr = qmatmul_w8a16_q8_ref(a, w, sw, bias, bits)
                        assert int((q.int() - qr.int()).abs().max()) <= 1
                        assert bool(((s - sr).abs() <= 1e-4 * sr).all())


@pytest.mark.parametrize("recipe", ["w8a16", "w8a8"])
def test_unfused_serving_on_the_card_matches_fused(dev, recipe, monkeypatch):
    """REPRO_FUSED_DECODE=0 serves the fused run's tokens through
    kv_attention, with no fused_decode launch."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    config = repro_torch.ServeConfig(smoke=True, quantize=recipe, trace=4,
                                     slots=2, prompt_len=12, gen_len=6,
                                     prefill_chunk=4, kv_bits=8)
    fused = repro_torch.serve(config)
    monkeypatch.setenv("REPRO_FUSED_DECODE", "0")
    reset_launch_counts()
    unfused = repro_torch.serve(config)
    counts = launch_counts()
    assert counts["fused_decode"] == 0 and counts["kv_attention"] > 0
    for rid, r in fused.results.items():
        assert unfused.results[rid].tokens == r.tokens, rid


def test_v_bias_corrected_serving_on_the_card(dev):
    """kv_bias_correct: the cache carries v_err and decode runs the
    kv_attention kernel, never fused_decode."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine, synthetic_trace

    cfg = dataclasses.replace(repro_torch.get_config("qwen2-0.5b-smoke"),
                              kv_bias_correct=True)
    model = repro_torch.build_model(cfg)
    qm = repro_torch.quantize(model, model.init(0, device=dev),
                              recipe="serve-w8a8-kv8", device=dev)
    eng = ServingEngine(model, qm.params, cfg, num_slots=2, max_len=32,
                        prefill_chunk=4, device=dev, kv_bits=8)
    assert "v_err" in eng.pool.cache
    reset_launch_counts()
    res = eng.run(synthetic_trace(0, 4, vocab_size=cfg.vocab_size,
                                  prompt_lens=(3, 12), gen_lens=(6, 6)))
    counts = launch_counts()
    assert all(r.status == "ok" and len(r.tokens) == 6 for r in res.values())
    assert counts["fused_decode"] == 0 and counts["kv_attention"] > 0
    assert bool(eng.pool.cache["v_err"].abs().sum() > 0)


def _w8a16_tolerance(a, w_q, w_scale, bias, y_ref):
    """E = 16 · sqrt(K) · 2⁻²⁴ · sqrt(a² @ w_deq²) + 2⁻²² · (|y| + |bias|)
    (float32: two sums of the same K products rounded in other orders),
    plus one bf16 ulp of |y_ref| + E (bfloat16: each rounded once more)."""
    w_deq = w_q.float() * torch.atleast_1d(w_scale).float()[None, :]
    norm = torch.sqrt(a.float().square() @ w_deq.square())
    e = 16 * a.shape[1] ** 0.5 * 2.0 ** -24 * norm + 2.0 ** -22 * (
        y_ref.float().abs() + (0 if bias is None else bias.float().abs()))
    if y_ref.dtype != torch.bfloat16:
        return e
    _, ex = torch.frexp((y_ref.float().abs() + e).clamp_min(2.0 ** -126))
    return e + torch.ldexp(torch.ones_like(e), ex - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmatmul_w8a16_kernel_against_plain_ragged(dev, dtype):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_ref,
    )

    for M, K, N, per_channel, with_bias in (
            (1, 16, 8, True, True), (5, 33, 17, False, True),
            (40, 96, 72, True, False), (8, 896, 128, False, True),
            (70, 200, 130, True, True), (3, 4100, 70, True, True),
            (17, 2100, 100, False, True), (8, 1600, 33, True, False),
            (70, 3000, 130, False, True)):
        a = torch.randn((M, K), device=dev).to(dtype)
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8).t()
        sw = torch.rand(N if per_channel else 1, device=dev) * 0.01 + 1e-4
        bias = torch.randn(N, device=dev) if with_bias else None
        reset_launch_counts()
        y = qmatmul_w8a16(a, w, sw, bias)
        assert launch_counts()["qmatmul_w8a16"] == 1
        yr = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
        assert y.dtype == dtype
        diff = (y.float() - yr.float()).abs()
        tol = _w8a16_tolerance(a, w, sw, bias, yr)
        assert bool((diff <= tol).all()), (M, K, N, float(diff.max()))
    with pytest.raises(ValueError, match="out_dtype"):
        qmatmul_w8a16(a, w, sw, bias, out_dtype=torch.float16)


def _sweep(K):
    """The splits the card tests force: 1, 2, the plan's, the largest."""
    from repro_torch.kernels import gemm_plan

    top = gemm_plan.max_splits(-(-K // gemm_plan.BK))
    return sorted({1, min(2, top), gemm_plan.plan(8, 1, K).splits, top})


@pytest.mark.parametrize("M,K,N", SPLIT_CASES + ((8, 4864, 896),))
def test_gemm_split_sweep_one_launch_deterministic(dev, M, K, N):
    """Both GEMMs and both quantize-out variants at every swept K split:
    W8A8 bit-equal to its plain version, W8A16 within its tolerance, one
    launch per call, two calls the same bits; the quantize-out variants
    bit-equal to their plain version (W8A8) and to the kernel pair (W8A16,
    float32 a)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_q8_ref,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16.kernel import (
        qmatmul_w8a16_cuda,
        qmatmul_w8a16_q8_cuda,
    )
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                      generator=gen).t()
    sw = torch.rand(N, device=dev, generator=gen) * 0.01 + 1e-4
    bias = torch.randn(N, device=dev, generator=gen)
    a_q = torch.randint(-128, 128, (M, K), device=dev, dtype=torch.int8,
                        generator=gen)
    sa = torch.rand(M, device=dev, generator=gen) * 0.05 + 1e-4
    a32 = torch.randn((M, K), device=dev, generator=gen)
    want8 = {od: qmatmul_w8a8_ref(a_q, w, sa, sw, bias, od)
             for od in (torch.float32, torch.bfloat16)}
    want8_q8 = qmatmul_w8a8_q8_ref(a_q, w, sa, sw, bias)

    def once(fn, op):
        reset_launch_counts()
        out = fn()
        assert launch_counts()[op] == 1
        assert sum(launch_counts().values()) == 1
        return out

    for S in _sweep(K):
        for od, want in want8.items():
            runs = [once(lambda: qmatmul_w8a8_cuda(
                a_q, w, sa, sw, bias, out_dtype=od, _splits=S),
                "qmatmul_w8a8") for _ in range(2)]
            assert torch.equal(runs[0], want) and torch.equal(runs[1], want)
        for _ in range(2):
            q, s = once(lambda: qmatmul_w8a8_q8_cuda(
                a_q, w, sa, sw, bias, _splits=S), "qmatmul_w8a8_q8")
            assert torch.equal(q, want8_q8[0]) and torch.equal(s, want8_q8[1])
        for dtype in (torch.float32, torch.bfloat16):
            a = a32.to(dtype)
            ys = [once(lambda: qmatmul_w8a16_cuda(a, w, sw, bias, _splits=S),
                       "qmatmul_w8a16") for _ in range(2)]
            assert torch.equal(ys[0], ys[1]), (S, dtype)
            yr = qmatmul_w8a16_ref(a, w, sw, bias, dtype)
            diff = (ys[0].float() - yr.float()).abs()
            assert bool((diff <= _w8a16_tolerance(a, w, sw, bias, yr)).all())
            qs = [once(lambda: qmatmul_w8a16_q8_cuda(
                a, w, sw, bias, _splits=S), "qmatmul_w8a16_q8")
                for _ in range(2)]
            assert all(torch.equal(x, y) for x, y in zip(*qs)), (S, dtype)
            if dtype == torch.float32:
                pair = quantize_act_cuda(ys[0])
                assert torch.equal(qs[0][0], pair[0])
                assert torch.equal(qs[0][1], pair[1])


def test_q8_scratch_is_zero_after_calls(dev):
    """The quantize-out epilogues' per-stream scratch (the rows' max, the M
    tiles' or kv heads' counters, and the resident route's ticket and
    departure counters) is all zero after calls of both GEMM variants on
    both routes, at split and unsplit shapes and bits 4 and 8, and of
    fused_decode's quantize-out, on the default stream and on a second
    one."""
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_q8_cuda
    from repro_torch.kernels.qmatmul_w8a16.kernel import qmatmul_w8a16_q8_cuda

    def calls():
        gen = torch.Generator(device=dev).manual_seed(8)
        lens = torch.tensor([100, 1, 37], device=dev)
        leaves, valid, q, kn, vn, idx = _decode_operands(
            dev, gen, 3, 100, 8, 2, 32, torch.bfloat16, lens)
        fused_decode_cuda(q, *leaves, kn[:, 0], vn[:, 0], idx[:, 0].int(),
                          valid, quantize_out=True)
        for M, K, N in ((8, 896, 256),) + SPLIT_CASES:
            w = torch.randint(-127, 128, (N, K), device=dev,
                              dtype=torch.int8).t()
            sw = torch.rand(N, device=dev) * 0.01 + 1e-4
            bias = torch.randn(N, device=dev)
            a_q = torch.randint(-128, 128, (M, K), device=dev,
                                dtype=torch.int8)
            for route, bits in (("resident", 8), ("workspace", 8),
                                ("resident", 4), ("workspace", 4)):
                qmatmul_w8a8_q8_cuda(a_q, w, torch.rand(M, device=dev) + 1e-3,
                                     sw, bias, bits=bits, _route=route)
                for dtype in (torch.float32, torch.bfloat16):
                    qmatmul_w8a16_q8_cuda(torch.randn((M, K), device=dev).to(dtype),
                                          w, sw, bias, bits=bits, _route=route)

    calls()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        calls()
    torch.cuda.synchronize()
    assert len(dispatch._SCRATCH) >= 2
    for buf in dispatch._SCRATCH.values():
        assert int(buf.abs().sum()) == 0


def test_w8a16_tolerance_rejects_a_tf32_product(dev):
    """The float32 tolerance is tight enough to catch TF32: the plain
    version with TF32 allowed falls outside it at a path shape."""
    from repro_torch.kernels.qmatmul_w8a16 import qmatmul_w8a16_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((8, 896), generator=gen, device=dev)
    w = torch.randint(-127, 128, (896, 896), generator=gen, device=dev,
                      dtype=torch.int8).t()
    sw = torch.full((1,), 0.005, device=dev)
    yr = qmatmul_w8a16_ref(a, w, sw, None, torch.float32)
    tol = _w8a16_tolerance(a, w, sw, None, yr)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = qmatmul_w8a16_ref(a, w, sw, None, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert bool(((y_tf32 - yr).abs() > tol).any())


def test_serving_on_the_card_launches_every_kernel(dev):
    """serve-w8a8-kv8 runs qmatmul_w8a8_qin, qmatmul_w8a8 and fused_decode.
    Every GEMM of this run has at most 2 x 4 rows, a decode tile, so the
    plan folds quantize_act into every one whose activation is not the
    fused decode's quantize-out (wo at decode: qmatmul_w8a8), and
    quantize_act itself never launches."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, quantize="w8a8", trace=4, slots=2, prompt_len=12,
        gen_len=6, prefill_chunk=4, kv_bits=8))
    assert all(r.status == "ok" for r in run.results.values())
    counts = launch_counts()
    assert min(counts[k] for k in ("qmatmul_w8a8_qin", "qmatmul_w8a8",
                                   "fused_decode")) > 0
    assert counts["quantize_act"] == 0 and counts["qmatmul_w8a16"] == 0


# the decode tile (M <= 16) only: the kernel quantizes its own activation
# nowhere else; SPLIT_CASES' K and N with their M cut to a decode tile
QIN_CASES = ((8, 896, 896), (8, 4864, 896), (16, 896, 4864), (1, 896, 128),
             (3, 4100, 70), (16, 2100, 100), (8, 1600, 33), (13, 3000, 130),
             (5, 900, 130))


@pytest.mark.parametrize("M,K,N", QIN_CASES)
def test_qin_kernel_bit_equal_to_the_pair_at_forced_splits(dev, M, K, N):
    """qmatmul_w8a8_qin against quantize_act + qmatmul_w8a8 (the port's own
    kernels), bit for bit, at every split the planner allows whose slice
    fits, bf16 and f32 x and out: row 0 .5 ties with its only large value
    in the last K step (the last split's), row 1 zero. The quantized
    activation it hands out is quantize_act's. One launch a call, no
    quantize_act."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8.kernel import (
        qmatmul_w8a8_cuda,
        qmatmul_w8a8_qin_cuda,
    )
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                      generator=gen).t()
    sw = torch.rand(N, device=dev, generator=gen) * 0.01 + 1e-4
    bias = torch.randn(N, device=dev, generator=gen)
    top = gemm_plan.max_splits(-(-K // gemm_plan.BK))
    for xdt in (torch.bfloat16, torch.float32):
        x = torch.randn((M, K), device=dev, generator=gen) * 3
        x[0, :5] = torch.tensor([0.5, 1.5, -2.5, 2.5, -0.5])
        x[0, K - 1] = 127.0
        if M > 1:
            x[1] = 0.0
        x = x.to(xdt)
        a_q, a_s = quantize_act_cuda(x)
        for od in (torch.bfloat16, torch.float32):
            want = qmatmul_w8a8_cuda(a_q, w, a_s, sw, bias, out_dtype=od)
            for S in range(1, top + 1):
                if not gemm_plan.plan(M, N, K, splits=S).fold:
                    continue
                reset_launch_counts()
                y, q, s = qmatmul_w8a8_qin_cuda(x, w, sw, bias, out_dtype=od,
                                                quantized=True, _splits=S)
                counts = launch_counts()
                assert counts["qmatmul_w8a8_qin"] == 1
                assert counts["quantize_act"] == 0
                assert torch.equal(y, want), (xdt, od, S)
                assert torch.equal(q, a_q) and torch.equal(s, a_s), (xdt, S)


def test_qin_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """A CPU activation, a tile other than the decode tile (M = 17, 64 and
    256: 64-row tiles, fit or not), and a decode tile whose slice is over
    the shared memory cap (K = 2^18 in 16 splits) raise before any launch."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8.kernel import qmatmul_w8a8_qin_cuda

    w = torch.zeros((896, 4864), device=dev, dtype=torch.int8).t()
    sw, bias = torch.ones(896, device=dev), torch.zeros(896, device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError, match="cpu"):
        qmatmul_w8a8_qin_cuda(torch.zeros((8, 4864)), w, sw, bias)
    for M in (17, 64, 256):
        assert gemm_plan.plan(M, 896, 4864).bm == 64
        with pytest.raises(ValueError, match="decode tile"):
            qmatmul_w8a8_qin_cuda(torch.zeros((M, 4864), device=dev), w, sw,
                                  bias)
    K = 1 << 18
    assert gemm_plan.plan(8, 8, K).bm == 16
    assert not gemm_plan.plan(8, 8, K).qin_fits
    w = torch.zeros((8, K), device=dev, dtype=torch.int8).t()
    with pytest.raises(ValueError, match="shared memory"):
        qmatmul_w8a8_qin_cuda(torch.zeros((8, K), device=dev), w, sw[:8],
                              bias[:8])
    assert launch_counts().get("qmatmul_w8a8_qin", 0) == 0


def test_w8a16_serving_launches_its_kernels_only(dev):
    """serve-w8a16-kv8 (the default scheme over the int8 cache) runs
    qmatmul_w8a16 and fused_decode, and no quantize_act or qmatmul_w8a8."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    run = repro_torch.serve(repro_torch.ServeConfig(
        smoke=True, trace=4, slots=2, prompt_len=12, gen_len=6,
        prefill_chunk=4, kv_bits=8))
    assert all(r.status == "ok" for r in run.results.values())
    counts = launch_counts()
    assert counts["qmatmul_w8a16"] > 0 and counts["fused_decode"] > 0
    assert counts["quantize_act"] == 0 and counts["qmatmul_w8a8"] == 0


def _hostile_smoke(model):
    """Seeded smoke weights that need every rewrite: log-normal norm gains,
    random attention biases, MLP hidden channels spread by a
    function-preserving rescale."""
    gen = torch.Generator().manual_seed(2)
    params = model.init(0, device="cpu")
    blocks, mlp = params["blocks"], params["blocks"]["mlp"]
    for norm in ("attn_norm", "mlp_norm"):
        blocks[norm]["w"] = torch.exp(
            torch.randn(blocks[norm]["w"].shape, generator=gen) * 0.5)
    for k in ("bq", "bk", "bv", "bo"):
        blocks["attn"][k] = torch.randn(blocks["attn"][k].shape,
                                        generator=gen) * 0.5
    s = torch.exp(torch.randn((mlp["wu"].shape[0], mlp["wu"].shape[-1]),
                              generator=gen) * 2.3)
    mlp["wu"] = mlp["wu"] * s[:, None, :]
    mlp["wd"] = mlp["wd"] / s[:, :, None]
    return params


@pytest.mark.parametrize("recipe", ["serve-w8a16-kv8", "serve-w8a8-kv8"])
def test_quantize_on_the_card_matches_the_cpu(dev, recipe):
    """DFQ on the card: every payload, scale and float leaf bit-equal to the
    CPU pipeline's, but ``bo`` (its value-bias shift is a matrix product:
    n · 2⁻²³ · (|c| @ |wo|) plus one ulp); per-site SQNR within 1e-4 dB."""
    import repro_torch
    from repro_torch.quantized import QTensor

    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    params = _hostile_smoke(model)
    cpu = repro_torch.quantize(model, params, recipe=recipe, device="cpu")
    card = repro_torch.quantize(model, params, recipe=recipe, device=dev)
    attn = repro_torch.quantize(model, params, recipe=["fold_norm", "cle"],
                                device="cpu").params["blocks"]["attn"]
    cfg = model.cfg
    L, group = attn["bv"].shape[0], cfg.n_heads // cfg.n_kv_heads
    c = attn["bv"].reshape(L, cfg.n_kv_heads, 1, cfg.head_dim).expand(
        L, cfg.n_kv_heads, group, cfg.head_dim).reshape(L, -1)
    bo_tol = c.shape[-1] * 2.0 ** -23 * torch.einsum(
        "ln,lno->lo", c.abs(), attn["wo"].abs())

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, QTensor):
            yield path + ("q",), tree.q
            yield path + ("scale",), tree.scale
        else:
            yield path, tree

    want, got = dict(leaves(cpu.params)), dict(leaves(card.params))
    assert sorted(want) == sorted(got)
    for path, t in want.items():
        g = got[path].cpu()
        if path == ("blocks", "attn", "bo"):
            ulp = torch.nextafter(t.abs(), torch.tensor(float("inf"))) - t.abs()
            assert bool(((g - t).abs() <= bo_tol + ulp).all())
        else:
            assert torch.equal(g, t), path
    pack = [next(r for r in q.report if r["stage"] == "pack")["metrics"]
            for q in (cpu, card)]
    for site, db in pack[0]["sqnr_db"].items():
        assert abs(db - pack[1]["sqnr_db"][site]) <= 1e-4, site


#: the bias-corrected w8a8 deployment (chip_smoke.py's BC_DEPLOY)
BC_DEPLOY = ["fold_norm", "cle", "bias_absorb", "bias_correct",
             ("pack", {"mode": "w8a8"}), ("kv_cache", {"bits": 8})]


@pytest.mark.parametrize("recipe", ["dfq-int8", "naive-int8", "cle-only",
                                    "bc-w8a8-kv8"])
def test_fig4_recipes_on_the_card_match_the_cpu(dev, recipe):
    """The paper's flow on the card, on the CPU's calibration tokens: every
    weight leaf (fake-quantized or packed) bit-equal to the CPU's; E[x]
    within 2⁻¹⁶ of its max (tests/test_torch_bias_correction.py's
    STAT_TOL); each corrected bias within |δ| @ |ε| + 2·D·2⁻²⁴·(|E[x]| @
    |ε|) plus one ulp, δ the gap between the two sides' E[x] (``bo`` also
    within its absorption's bound)."""
    import repro_torch
    from repro_torch.core import DFQConfig, weight_quant_error
    from repro_torch.core.tree import get_path
    from repro_torch.pipeline import default_calibration
    from repro_torch.pipeline.api import _fold_weight_spec_overrides
    from repro_torch.pipeline.recipes import resolve_recipe
    from repro_torch.quantized import QTensor

    spec = BC_DEPLOY if recipe == "bc-w8a8-kv8" else recipe
    r = resolve_recipe(spec)
    model = repro_torch.build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    params = _hostile_smoke(model)
    hook = default_calibration(model, model.cfg)
    means = {"cpu": {}, "card": {}}

    def rec(side):
        def calibrate(p):
            means[side].update(hook(p))
            return means[side]
        return calibrate

    cpu = repro_torch.quantize(model, params, recipe=spec, device="cpu",
                               calibration=rec("cpu"))
    card = repro_torch.quantize(model, params, recipe=spec, device=dev,
                                calibration=rec("card"))
    tol = {}
    stages = r.stage_names()
    if "bias_absorb" in stages:
        attn = repro_torch.quantize(model, params, recipe=["fold_norm", "cle"],
                                    device="cpu").params["blocks"]["attn"]
        cfg = model.cfg
        L, group = attn["bv"].shape[0], cfg.n_heads // cfg.n_kv_heads
        c = attn["bv"].reshape(L, cfg.n_kv_heads, 1, cfg.head_dim).expand(
            L, cfg.n_kv_heads, group, cfg.head_dim).reshape(L, -1)
        tol[("blocks", "attn", "bo")] = c.shape[-1] * 2.0 ** -23 * torch.einsum(
            "ln,lno->lo", c.abs(), attn["wo"].abs()).double()
    if "bias_correct" in stages:
        wspec = _fold_weight_spec_overrides(r, DFQConfig()).weight_spec
        eq = repro_torch.quantize(
            model, params, calibration=None, device="cpu",
            recipe=list(r.steps[:stages.index("bias_correct")])).params
        for k, e in means["cpu"].items():
            assert float((means["card"][k].cpu() - e).abs().max()) <= \
                2.0 ** -16 * float(e.abs().max()), k
        for site in model.dfq_plan().sites:
            eps = weight_quant_error(get_path(eq, site.w), wspec).abs().double()
            e = means["cpu"][site.stat_key].double()
            delta = (means["card"][site.stat_key].cpu().double() - e).abs()
            tol[site.b] = tol.get(site.b, 0) + (
                torch.einsum("...i,...io->...o", delta, eps)
                + 2 * eps.shape[-2] * 2.0 ** -24
                * torch.einsum("...i,...io->...o", e.abs(), eps))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, QTensor):
            yield path + ("q",), tree.q
            yield path + ("scale",), tree.scale
        else:
            yield path, tree

    want, got = dict(leaves(cpu.params)), dict(leaves(card.params))
    assert sorted(want) == sorted(got)
    for path, t in want.items():
        g = got[path].cpu()
        if path in tol:
            ulp = (torch.nextafter(torch.maximum(t.abs(), g.abs()),
                                   torch.tensor(float("inf")))
                   - torch.maximum(t.abs(), g.abs())).double()
            assert bool(((g - t).abs().double() <= tol[path] + ulp).all()), path
        else:
            assert torch.equal(g, t), path


def test_bias_corrected_deployment_serves_on_the_card(dev, tmp_path):
    """The bias-corrected w8a8 deployment — real gate/up biases through the
    W8A8 GEMMs — saved, loaded bit-equal, and served from the artifact by
    ``serve(ServeConfig(load=...))``: the fast path's graphs give the
    stepwise tokens and ticks, through the W8A8 kernels and fused_decode."""
    import dataclasses

    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.pipeline import QuantizedModel

    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe=BC_DEPLOY, device=dev)
    assert float(qm.params["blocks"]["mlp"]["bg"].abs().max()) > 0
    qm.save(str(tmp_path))
    loaded = QuantizedModel.load(str(tmp_path), device=dev)
    assert loaded.kv_bits == 8
    for site in qm.model.dfq_plan().sites:
        a = qm.params[site.w[0]][site.w[1]][site.w[2]]
        b = loaded.params[site.w[0]][site.w[1]][site.w[2]]
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        assert torch.equal(qm.params[site.b[0]][site.b[1]][site.b[2]],
                           loaded.params[site.b[0]][site.b[1]][site.b[2]])
    config = repro_torch.ServeConfig(load=str(tmp_path), trace=6, slots=3,
                                     prompt_len=12, gen_len=12,
                                     prefill_chunk=4, warmup=True)
    reset_launch_counts()
    fast = repro_torch.serve(config)
    counts = launch_counts()
    slow = repro_torch.serve(dataclasses.replace(config, reference=True))
    for rid, r in slow.results.items():
        assert fast.results[rid].tokens == r.tokens, rid
        assert fast.results[rid].finished_at == r.finished_at, rid
    assert counts["qmatmul_w8a8_qin"] > 0 and counts["fused_decode"] > 0
    assert counts["qmatmul_w8a16"] == 0


def _decode_operands(dev, gen, B, S, Hq, Hkv, hd, dtype, lens):
    """The cache (scales zero past each row's length), the live mask, q,
    the new token's K/V [B, 1, Hkv, hd] and its offset [B, 1] (the last
    live position; 0 in an empty row, which the mask hides)."""
    kq, ks, vq, vs = _cache(dev, B, S, Hkv, hd, gen)
    valid = torch.arange(S, device=dev)[None] < lens[:, None]
    ks, vs = ks * valid[..., None], vs * valid[..., None]
    q = torch.randn((B, Hq, hd), device=dev, generator=gen).to(dtype)
    kn = torch.randn((B, 1, Hkv, hd), device=dev, generator=gen).to(dtype)
    vn = torch.randn((B, 1, Hkv, hd), device=dev, generator=gen).to(dtype)
    return [kq, ks, vq, vs], valid, q, kn, vn, (lens - 1).clamp_min(0)[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_split_sweep(dev, dtype):
    """Every split count the planner allows at S = 300 (5 tiles) and 512
    (8 tiles), rows of length S, 1 (all splits masked but the first), 65 and
    0: kv_attention within the bound of its plain version, the empty row
    exactly 0, two calls the same bits, one launch each; fused_decode
    (quantize-out) bit-equal to append_quantize + the kv_attention kernel
    at the same split + the quantize_act kernel."""
    from repro_torch.kernels import attention_plan, launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.fused_decode.kernel import fused_decode_cuda
    from repro_torch.kernels.kv_attention import append_quantize
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda
    from repro_torch.kernels.kv_attention.ref import kv_attention_ref
    from repro_torch.kernels.quantize_act.kernel import quantize_act_cuda

    gen = torch.Generator(device=dev).manual_seed(4)
    for B, Hq, Hkv, hd, S in ((4, 8, 2, 32, 300), (4, 14, 2, 64, 512)):
        lens = torch.tensor([S, 1, 65, 0], device=dev)
        leaves, valid, q, kn, vn, idx = _decode_operands(
            dev, gen, B, S, Hq, Hkv, hd, dtype, lens)
        kq, ks, vq, vs = leaves
        ref = kv_attention_ref(q, kq, ks, vq, vs, dtype)
        comp = [t.clone() for t in leaves]
        append_quantize(*comp, kn, vn, idx)
        ks_eff = torch.where(valid[..., None], comp[1], 0.0)
        vs_eff = torch.where(valid[..., None], comp[3], 0.0)
        top = attention_plan.max_splits(attention_plan.plan(
            B, S, Hq, Hkv, hd).tiles)
        for sp in range(1, top + 1):
            reset_launch_counts()
            runs = [kv_attention_cuda(q, kq, ks, vq, vs, _splits=sp)
                    for _ in range(2)]
            assert launch_counts()["kv_attention"] == 2
            assert torch.equal(runs[0], runs[1]), sp
            diff = (runs[0].float() - ref.float()).abs()
            assert bool((diff <= _out_tolerance(ref.float(), dtype)).all()), sp
            assert float(runs[0][3].float().abs().max()) == 0.0
            fused = [t.clone() for t in leaves]
            out, oq, os_ = fused_decode_cuda(
                q, *fused, kn[:, 0], vn[:, 0], idx[:, 0].int(), valid,
                quantize_out=True, _splits=sp)
            uo = kv_attention_cuda(q, comp[0], ks_eff, comp[2], vs_eff,
                                   _splits=sp)
            uoq, uos = quantize_act_cuda(uo.reshape(B, -1))
            for a, b in zip(fused, comp):
                assert torch.equal(a, b), sp
            assert torch.equal(out, uo), sp
            assert torch.equal(oq, uoq) and torch.equal(os_, uos), sp


def test_kv_attention_float32_out_from_bf16_q(dev):
    """kv_attention(q_bf16, ...) with the default out_dtype=float32 runs
    the kernel (it used to raise): within the bound of the plain version,
    and its bf16 cast bit-equal to the kernel's own bf16 output."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.kv_attention import kv_attention, kv_attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    B, Hq, Hkv, hd, S = 3, 8, 2, 32, 100
    lens = torch.tensor([S, 7, 0], device=dev)
    (kq, ks, vq, vs), _, q, _, _, _ = _decode_operands(
        dev, gen, B, S, Hq, Hkv, hd, torch.bfloat16, lens)
    reset_launch_counts()
    out = kv_attention(q, kq, ks, vq, vs)
    out16 = kv_attention(q, kq, ks, vq, vs, out_dtype=torch.bfloat16)
    assert launch_counts()["kv_attention"] == 2
    assert out.dtype == torch.float32 and out16.dtype == torch.bfloat16
    ref = kv_attention_ref(q, kq, ks, vq, vs)
    assert bool(((out - ref).abs() <= _out_tolerance(ref, torch.float32)).all())
    assert torch.equal(out.bfloat16(), out16)
    assert float(out[2].abs().max()) == 0.0


def test_fused_decode_shared_idx(dev):
    """A shared idx of shape [1] (the JAX op broadcasts it; the kernel's
    wrapper used to refuse it): out, quantize-out and cache bit-equal to the
    same offset given per slot, the cache bit-equal to the plain version's
    and out within its bound."""
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    B, Hq, Hkv, hd, S = 4, 8, 2, 32, 100
    lens = torch.tensor([S, 30, 1, 64], device=dev)
    leaves, valid, q, kn, vn, _ = _decode_operands(
        dev, gen, B, S, Hq, Hkv, hd, torch.float32, lens)
    shared = torch.tensor([40], device=dev)
    valid[:, 40] = True
    runs = []
    for idx in (shared, shared.expand(B)[:, None]):
        mine = [t.clone() for t in leaves]
        runs.append((fused_decode(q, *mine, kn, vn, idx, valid=valid,
                                  quantize_out=True)[0], mine))
    (a, ca), (b, cb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    plain = [t.clone() for t in leaves]
    (r, _, _), _ = fused_decode_ref(q, *plain, kn, vn, shared, valid=valid,
                                    quantize_out=True)
    assert all(torch.equal(x, y) for x, y in zip(ca, plain))
    assert bool(((a[0] - r).abs() <= _out_tolerance(r, torch.float32)).all())


def test_fused_decode_float32_quantize_out_from_bf16_q(dev):
    """The fused W8A8 route's quantize-out with bfloat16 q and
    out_dtype=float32: the epilogue bit-equal to quantize_act of the
    float32 out, out within the bound of the plain version, the cache
    bit-equal to the plain version's, the empty row exactly 0."""
    from repro_torch.kernels.fused_decode import fused_decode, fused_decode_ref
    from repro_torch.kernels.quantize_act import quantize_act_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    B, Hq, Hkv, hd, S = 4, 14, 2, 64, 512
    lens = torch.tensor([S, 1, 200, 0], device=dev)
    leaves, valid, q, kn, vn, idx = _decode_operands(
        dev, gen, B, S, Hq, Hkv, hd, torch.bfloat16, lens)
    mine = [t.clone() for t in leaves]
    plain = [t.clone() for t in leaves]
    (out, oq, os_), _ = fused_decode(q, *mine, kn, vn, idx, valid=valid,
                                     out_dtype=torch.float32,
                                     quantize_out=True)
    (r, _, _), _ = fused_decode_ref(q, *plain, kn, vn, idx, valid=valid,
                                    out_dtype=torch.float32, quantize_out=True)
    assert out.dtype == torch.float32
    qs, ss = quantize_act_ref(out.reshape(B, -1))
    assert torch.equal(oq, qs) and torch.equal(os_, ss)
    assert all(torch.equal(x, y) for x, y in zip(mine, plain))
    assert bool(((out - r).abs() <= _out_tolerance(r, torch.float32)).all())
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.parametrize("bits", [1, 2, 4, 6, 8])
def test_quantize_act_bits(dev, bits):
    """quantize_act at any bits (it was int8-only on the card): bit-equal
    to the plain version, the clip at [-qmax - 1, qmax]."""
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    gen = torch.Generator(device=dev).manual_seed(bits)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((9, 300), device=dev, generator=gen) * 3).to(dtype)
        q, s = quantize_act(x, bits=bits)
        qr, sr = quantize_act_ref(x, bits)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        qmax = 2 ** (bits - 1) - 1
        assert int(q.max()) <= qmax and int(q.min()) >= -qmax - 1


def test_attention_wrappers_refuse_shapes_the_kernel_does_not_take(dev):
    from repro_torch.kernels.kv_attention.kernel import kv_attention_cuda

    q = torch.zeros((1, 2, 40), device=dev)
    kv = torch.zeros((1, 8, 1, 40), device=dev, dtype=torch.int8)
    s = torch.zeros((1, 8, 1), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        kv_attention_cuda(q, kv, s, kv, s)
    q = torch.zeros((1, 128, 256), device=dev)
    kv = torch.zeros((1, 8, 1, 256), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        kv_attention_cuda(q, kv, s, kv, s)


# ------------------------------------------- the fast path's CUDA graphs

def _fast_engine(dev, recipe="serve-w8a8-kv8", **kw):
    """A smoke-size fast engine on the card, every graph captured."""
    import repro_torch

    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe=recipe, device=dev)
    kw = {"num_slots": 3, "max_len": 48, "prefill_chunk": 4, **kw}
    eng = repro_torch.ServingEngine.from_quantized(qm, device=dev, **kw)
    eng.warmup()
    assert len(eng.graphs) == len(eng.warmup_shapes())
    return eng


def _mid_decode(eng):
    """Serve until every slot decodes (the prompts are in the cache)."""
    from repro_torch.serving import Request

    for i in range(eng.num_slots):
        eng.submit(Request(rid=i, prompt=[3 + i] * (5 + 3 * i),
                           max_new_tokens=30))
    while any(not fl.prefill_done for fl in eng._inflight.values()) \
            or eng.scheduler.pending():
        eng.step()


def _cache_copy(eng):
    return {k: v.clone() for k, v in eng.pool.cache.items()}


def _restore(eng, saved):
    for k, v in eng.pool.cache.items():
        v.copy_(saved[k])


def test_decode_horizon_graph_equals_the_eager_horizon(dev):
    """A replayed decode-horizon graph against the same horizon run eagerly
    on a copy of the pool: tokens, bad flags and every cache leaf
    bit-equal, at each power-of-two horizon."""
    eng = _fast_engine(dev)
    _mid_decode(eng)
    B = eng.num_slots
    tokens = np.array([[fl.cur_token] for fl in sorted(
        eng._inflight.values(), key=lambda f: f.slot)], np.int64)
    for k in (1, 2, 4, 8):
        remaining = np.full((B,), k, np.int64)
        remaining[1] = max(1, k // 2)         # a row that freezes mid-horizon
        saved = _cache_copy(eng)
        toks, bad = (t.clone() for t in eng._dispatch(
            "decode_horizon", k, (tokens, remaining)))
        replayed = _cache_copy(eng)
        _restore(eng, saved)
        etoks, ebad = eng._decode_horizon_impl(
            eng.pool.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(remaining).to(dev), k=k)
        assert torch.equal(toks, etoks) and torch.equal(bad, ebad), k
        for name, leaf in eng.pool.cache.items():
            assert torch.equal(leaf, replayed[name]), (k, name)


def test_prefill_graph_equals_the_eager_prefill(dev):
    """The replayed batched-prefill graph against the same dispatch run
    eagerly on a copy of the pool, with a fresh row, a continuing row and a
    decoding row riding along."""
    eng = _fast_engine(dev)
    _mid_decode(eng)
    B, C = eng.num_slots, eng.prefill_chunk
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, eng.cfg.vocab_size, (B, C)).astype(np.int64)
    tokens[2] = 0
    n_valid = np.array([C, 2, 1], np.int64)
    fresh = np.array([True, False, False])
    is_real = np.array([True, True, False])
    saved = _cache_copy(eng)
    tok, bad = (t.clone() for t in eng._dispatch(
        "prefill_multi", B, (tokens, n_valid, fresh, is_real)))
    replayed = _cache_copy(eng)
    _restore(eng, saved)
    etok, ebad = eng._prefill_masked(
        eng.pool.cache, *(torch.from_numpy(a).to(dev)
                          for a in (tokens, n_valid, fresh, is_real)))
    assert torch.equal(tok, etok) and torch.equal(bad, ebad)
    for name, leaf in eng.pool.cache.items():
        assert torch.equal(leaf, replayed[name]), name
    # the ride-along row kept its cache bytes
    for name in ("k", "v", "k_scale", "v_scale", "kpos", "pos"):
        leaf = eng.pool.cache[name]
        row = leaf[2] if name in ("kpos", "pos") else leaf[:, 2]
        ref = saved[name][2] if name in ("kpos", "pos") else saved[name][:, 2]
        assert torch.equal(row, ref), name


def test_graph_replays_leave_the_scratch_zero(dev):
    """W8A8 with fused decode takes the stream scratch in every decode step
    (fused_decode's quantize-out): after a whole fast run, every scratch
    buffer — the graph stream's included — is zero again."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import synthetic_trace

    eng = _fast_engine(dev)
    key = (dev.index, eng.graphs.stream.cuda_stream)
    assert key in dispatch._SCRATCH
    res = eng.run(synthetic_trace(0, 6, vocab_size=eng.cfg.vocab_size,
                                  prompt_lens=(3, 12), gen_lens=(4, 12)))
    assert all(r.status == "ok" for r in res.values())
    torch.cuda.synchronize()
    for buf in list(dispatch._SCRATCH.values()) + dispatch._OUTGROWN:
        assert int(buf.abs().sum()) == 0


def test_replays_count_the_captured_launches(dev):
    """launch_counts() after n replays of a horizon graph is n times what
    its capture counted, and that is the horizon's kernels: k fused decode
    launches a layer."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    eng = _fast_engine(dev)
    B, L = eng.num_slots, eng.cfg.n_layers
    for k in (1, 4):
        delta = eng.graphs.launches(("decode_horizon", k))
        assert delta["fused_decode"] == L * k
        assert delta.get("quantize_act", 0) == 0
        reset_launch_counts()
        for _ in range(3):
            eng._dispatch("decode_horizon", k, (np.zeros((B, 1), np.int64),
                                                np.zeros((B,), np.int64)))
        torch.cuda.synchronize()
        assert {op: n for op, n in launch_counts().items() if n} == \
               {op: 3 * n for op, n in delta.items()}


@pytest.mark.parametrize("recipe", ["serve-w8a16-kv8", "serve-w8a8-kv8"])
def test_fast_path_on_the_card_serves_the_stepwise_tokens(dev, recipe):
    """repro_torch.serve's fast path (graphs replayed) gives the stepwise
    path's tokens and ticks, request by request, with one host sync a
    horizon."""
    import dataclasses

    import repro_torch

    config = repro_torch.ServeConfig(smoke=True, quantize=recipe[6:-4],
                                     trace=6, slots=3, prompt_len=12,
                                     gen_len=12, prefill_chunk=4,
                                     warmup=True, kv_bits=8)
    fast = repro_torch.serve(config)
    slow = repro_torch.serve(dataclasses.replace(config, reference=True))
    assert fast.warmup["graphs"] == 5 and fast.warmup["graph_pool_bytes"] >= 0
    for rid, r in slow.results.items():
        assert fast.results[rid].tokens == r.tokens, rid
        assert fast.results[rid].finished_at == r.finished_at, rid
    assert fast.stats["decode_dispatches"] < fast.stats["decode_steps"]


def test_warmup_on_the_card_leaves_the_pool_as_it_was(dev):
    """warmup() on the card — every graph captured, throwaway traffic
    replayed — restores every cache leaf's bytes at the same address, and
    the stats, clock and unclaimed results."""
    import repro_torch
    from repro_torch.serving import Request

    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe="serve-w8a8-kv8",
                              device=dev)
    eng = repro_torch.ServingEngine.from_quantized(
        qm, device=dev, num_slots=3, max_len=48, prefill_chunk=4)
    eng.submit(Request(rid=0, prompt=[5] * 9, max_new_tokens=6))
    while eng._inflight or eng.scheduler.pending():
        eng.step()
    before = _cache_copy(eng)
    addresses = {k: v.data_ptr() for k, v in eng.pool.cache.items()}
    stats, clock = dict(eng.stats), eng.clock
    # the run above captured some horizons already; warmup runs a masked
    # one-step decode before each capture it makes
    new = sum(("decode_horizon", k) not in eng.graphs for k in (1, 2, 4, 8))
    ran = eng.warmup()
    assert len(eng.graphs) == 5 and ran["decode_steps"] == 15 + new
    for k, v in eng.pool.cache.items():
        assert torch.equal(v, before[k]) and v.data_ptr() == addresses[k], k
    assert eng.stats == stats and eng.clock == clock
    assert list(eng.results) == [0]


# ------------------------------------------------------------- paged pool

def _paged_engine(dev, **kw):
    return _fast_engine(dev, page_size=8, **kw)


def test_paged_decode_horizon_graph_equals_the_eager_horizon(dev):
    """A replayed paged decode-horizon graph (gather, k steps on the dense
    view, commit) against the same dispatch run eagerly: tokens, bad flags,
    every page and the bookkeeping bit-equal, at each horizon."""
    eng = _paged_engine(dev)
    _mid_decode(eng)
    B = eng.num_slots
    tokens = np.array([[fl.cur_token] for fl in sorted(
        eng._inflight.values(), key=lambda f: f.slot)], np.int64)
    for k in (1, 2, 4, 8):
        remaining = np.full((B,), k, np.int64)
        remaining[1] = max(1, k // 2)         # a row that freezes mid-horizon
        saved = _cache_copy(eng)
        toks, bad = (t.clone() for t in eng._dispatch(
            "decode_horizon", k, (tokens, remaining)))
        replayed = _cache_copy(eng)
        _restore(eng, saved)
        etoks, ebad = eng._decode_horizon(
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(remaining).to(dev), k=k)
        assert torch.equal(toks, etoks) and torch.equal(bad, ebad), k
        for name, leaf in eng.pool.cache.items():
            assert torch.equal(leaf, replayed[name]), (k, name)


def test_paged_prefill_graph_equals_the_eager_prefill(dev):
    """The replayed paged prefill graph against the same dispatch run
    eagerly, a decoding row riding along: outputs and every page
    bit-equal, the ride-along slot's pages untouched."""
    eng = _paged_engine(dev)
    _mid_decode(eng)
    B, C = eng.num_slots, eng.prefill_chunk
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, eng.cfg.vocab_size, (B, C)).astype(np.int64)
    tokens[2] = 0
    n_valid = np.array([C, 2, 1], np.int64)
    fresh = np.zeros((B,), bool)
    is_real = np.array([True, True, False])
    saved = _cache_copy(eng)
    tok, bad = (t.clone() for t in eng._dispatch(
        "prefill_multi", B, (tokens, n_valid, fresh, is_real)))
    replayed = _cache_copy(eng)
    _restore(eng, saved)
    etok, ebad = eng._prefill(*(torch.from_numpy(a).to(dev)
                                for a in (tokens, n_valid, fresh, is_real)))
    assert torch.equal(tok, etok) and torch.equal(bad, ebad)
    for name, leaf in eng.pool.cache.items():
        assert torch.equal(leaf, replayed[name]), name
    for p in eng.pool.slot_pages(2):
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(replayed[name][:, p], saved[name][:, p]), name


def test_paged_gather_commit_and_sink_on_the_card(dev):
    """The gather and the commit on the card bit-equal to the CPU's on the
    same pool; the writes a commit drops land in the sink page, outside
    ``pool.cache``, and no mapped page they do not address changes."""
    from repro_torch import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import CachePool
    from repro_torch.serving.engine import _paged_commit, _paged_view

    model = build_model(get_config("qwen2-0.5b-smoke"))
    pools, denses = [], []
    rng = np.random.RandomState(1)
    table = np.full((3, 3), -1, np.int64)
    table[0], table[1, :2], table[2, :1] = [4, 0, 7], [2, 9], [5]
    vals = None
    for device in ("cpu", dev):
        pool = CachePool(model, 3, 24, device=device, kv_bits=8,
                         page_size=8, num_pages=12)
        if vals is None:
            vals = {n: (rng.randint(-127, 128, size=tuple(s.shape)).astype(np.int8)
                        if s.dtype == torch.int8 else
                        rng.randn(*s.shape).astype(np.float32))
                    for n, s in pool.storage.items()}
        for n, s in pool.storage.items():
            s.copy_(torch.from_numpy(vals[n]))
        pool.cache["page_table"].copy_(torch.from_numpy(table))
        dense = {n: torch.zeros((s.shape[0], 3, 24) + tuple(s.shape[3:]),
                                dtype=s.dtype, device=device)
                 for n, s in pool.storage.items()}
        _paged_view(pool, dense)
        pools.append(pool)
        denses.append(dense)
    for n in denses[0]:
        assert torch.equal(denses[1][n].cpu(), denses[0][n]), n
        denses[1][n].copy_(torch.flip(denses[0][n], dims=(2,)).to(dev))
        denses[0][n].copy_(torch.flip(denses[0][n], dims=(2,)))
    rows = torch.tensor([[6, 7, 8, 9], [14, 15, 16, 17], [-1, -1, -1, -1]])
    for pool, dense in zip(pools, denses):
        _paged_commit(pool, dense, rows.to(pool.cache["kpos"].device))
    torch.cuda.synchronize()
    written = {4, 0, 9}
    for n, s in pools[1].storage.items():
        assert torch.equal(pools[1].cache[n].cpu(), pools[0].cache[n]), n
        for p in set(range(12)) - written:
            assert torch.equal(s[:, p].cpu(), torch.from_numpy(vals[n][:, p])), (n, p)
        assert not torch.equal(s[:, pools[1].sink_page].cpu(),
                               torch.from_numpy(vals[n][:, 12])), n


def test_copy_on_write_on_the_card_matches_the_cpu(dev):
    """Admission over a shared page split by the reuse length copies it on
    the card: the same page ids, table, refcounts and page bytes as the
    CPU pool."""
    from repro_torch import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import CachePool

    model = build_model(get_config("qwen2-0.5b-smoke"))
    out = []
    for device in ("cpu", dev):
        pool = CachePool(model, 3, 32, device=device, kv_bits=8, page_size=8)
        gen = torch.Generator().manual_seed(0)
        for s in pool.storage.values():
            s.copy_(torch.randint(-127, 128, s.shape, generator=gen)
                    .to(s.dtype) if s.dtype == torch.int8
                    else torch.randn(s.shape, generator=gen))
        a = pool.allocate_pages(20)
        pool.ref_page(pool.slot_page(a, 0))
        pool.ref_page(pool.slot_page(a, 1))
        b = pool.allocate_pages(24, shared=pool.slot_pages(a)[:2],
                                reuse_len=12)
        assert pool.cow_copies == 1
        src, dst = pool.slot_page(a, 1), pool.slot_page(b, 1)
        for s in pool.storage.values():
            assert torch.equal(s[:, dst], s[:, src])
        out.append((pool.slot_pages(b), pool._page_ref, list(pool._free_pages),
                    pool.cache["page_table"].cpu(), pool.cache["kpos"].cpu(),
                    {n: v.cpu() for n, v in pool.cache.items()}))
    assert out[0][:3] == out[1][:3]
    for x, y in zip(out[0][3:5], out[1][3:5]):
        assert torch.equal(x, y)
    for n in out[0][5]:
        assert torch.equal(out[0][5][n], out[1][5][n]), n


@pytest.mark.parametrize("recipe", ["serve-w8a16", "serve-w8a8-kv8"])
def test_paged_serving_on_the_card_serves_the_contiguous_tokens(dev, recipe):
    """repro_torch.serve from the paged pool on the card (graphs captured by
    warmup; reuse off, fast and stepwise, then on) gives the contiguous
    pool's tokens, and with reuse off its ticks."""
    import dataclasses

    import repro_torch

    kv = {"kv_bits": 8} if recipe.endswith("-kv8") else {}
    config = repro_torch.ServeConfig(smoke=True, quantize=recipe.split("-")[1],
                                     trace=6, slots=3, prompt_len=12,
                                     gen_len=12, prefill_chunk=4,
                                     warmup=True, **kv)
    flat = repro_torch.serve(config)
    for kw in (dict(page_size=8, prefix_reuse=False),
               dict(page_size=8, prefix_reuse=False, reference=True),
               dict(page_size=4)):
        run = repro_torch.serve(dataclasses.replace(config, **kw))
        for rid, r in flat.results.items():
            assert run.results[rid].tokens == r.tokens, (kw, rid)
            if kw.get("prefix_reuse", True) is False:
                assert run.results[rid].finished_at == r.finished_at, (kw, rid)


# expert-batched shapes: (E, M, K, N) — ragged M, N and K, a split K, the
# routers' N = 8 and 16 (one BN = 16 tile, columns past N masked), decode
# tiles and 64-row tiles
EXPERT_CASES = ((4, 8, 96, 40), (3, 5, 4100, 70), (8, 80, 256, 136),
                (2, 17, 2100, 100), (1, 8, 512, 8), (1, 256, 320, 16),
                (16, 16, 640, 24))


@pytest.mark.parametrize("E,M,K,N", EXPERT_CASES)
def test_expert_batched_gemms_one_launch_against_plain(dev, E, M, K, N):
    """Each expert-batched GEMM in ONE launch: qmatmul_w8a8 bit-equal to
    its plain version expert by expert, qmatmul_w8a8_qin (where the plan
    folds) bit-equal to quantize_act + qmatmul_w8a8 with the flat
    quantize_act's int8 rows, qmatmul_w8a16 within its tolerance of each
    expert's plain version (per-tensor and per-channel scales, with and
    without a bias, bf16 and float32); two calls the same bits."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8 import (
        qmatmul_w8a8,
        qmatmul_w8a8_qin,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_ref,
    )
    from repro_torch.kernels.quantize_act import quantize_act

    g = torch.Generator(device=dev).manual_seed(E * M + K)
    w = torch.randint(-127, 128, (E, N, K), device=dev, dtype=torch.int8,
                      generator=g).transpose(1, 2)
    sw = torch.rand((E, N), device=dev, generator=g) * 0.01 + 1e-4
    bias = torch.randn((E, N), device=dev, generator=g)
    a = torch.randint(-128, 128, (E, M, K), device=dev, dtype=torch.int8,
                      generator=g)
    sa = torch.rand((E, M), device=dev, generator=g) + 1e-3
    reset_launch_counts()
    y = qmatmul_w8a8(a, w, sa, sw, bias, out_dtype=torch.bfloat16)
    assert launch_counts()["qmatmul_w8a8"] == 1
    assert torch.equal(y, qmatmul_w8a8(a, w, sa, sw, bias,
                                       out_dtype=torch.bfloat16))
    for e in range(E):
        assert torch.equal(y[e], qmatmul_w8a8_ref(a[e], w[e], sa[e], sw[e],
                                                  bias[e], torch.bfloat16)), e
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn((E, M, K), device=dev, generator=g) * 3).to(dtype)
        if gemm_plan.plan(M, N, K, experts=E).fold:
            reset_launch_counts()
            y, x_q, x_s = qmatmul_w8a8_qin(x, w, sw, bias, out_dtype=dtype,
                                           quantized=True)
            assert launch_counts()["qmatmul_w8a8_qin"] == 1
            q, s = quantize_act(x.reshape(-1, K))
            assert torch.equal(x_q.reshape(-1, K), q)
            assert torch.equal(x_s.reshape(-1), s)
            assert torch.equal(y, qmatmul_w8a8(x_q, w, x_s, sw, bias,
                                               out_dtype=dtype))
        for scale, b in ((sw[:, :1].contiguous(), None), (sw, bias)):
            s_, b_ = scale.to(dtype), None if b is None else b.to(dtype)
            reset_launch_counts()
            y = qmatmul_w8a16(x, w, s_, b_)
            assert launch_counts()["qmatmul_w8a16"] == 1
            assert torch.equal(y, qmatmul_w8a16(x, w, s_, b_))
            for e in range(E):
                yr = qmatmul_w8a16_ref(x[e], w[e], s_[e],
                                       None if b_ is None else b_[e], dtype)
                diff = (y[e].float() - yr.float()).abs()
                tol = _w8a16_tolerance(x[e], w[e], s_[e], b_ if b_ is None
                                       else b_[e], yr)
                assert bool((diff <= tol).all()), (e, float(diff.max()))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_smoke_serving_on_the_card_serves_the_cpu_tokens(dev, arch):
    """A smoke MoE model on the host-drawn weights under serve-w8a8-kv8,
    quantized and served on the card and on the CPU (stepwise): every
    token equal, and on the card one expert-batched launch per expert
    projection (gate/up: one quantize-in GEMM or quantize_act, then an
    int8 GEMM each; down: one)."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine, synthetic_trace

    model = repro_torch.build_model(repro_torch.get_config(arch, smoke=True))
    params = model.init(0, device="cpu")
    out = {}
    for d in ("cpu", dev):
        qm = repro_torch.quantize(model, params, device=d,
                                  recipe="serve-w8a8-kv8")
        eng = ServingEngine(qm.model, qm.params, qm.cfg, fast=False,
                            num_slots=3, max_len=16, prefill_chunk=4,
                            device=d)
        reset_launch_counts()
        out[str(d)] = eng.run(synthetic_trace(
            0, 6, vocab_size=256, prompt_lens=(4, 10), gen_lens=(4, 6)))
    counts = launch_counts()
    assert counts["qmatmul_w8a8"] > 0 and counts["fused_decode"] > 0
    for rid, r in out["cpu"].items():
        assert out[str(dev)][rid].tokens == r.tokens, rid


def _family_cases():
    """(M, K, N) of every GEMM on chip_smoke.py's phase-11 path
    (``family_gemms``, derived from the layers it runs): mamba2's and
    zamba2's in_proj (N = 10576 = 82·128 + 80 and 10448 = 81·128 + 80, a
    partial last tile under the planner's K split), out_proj and zamba2's
    shared block at a decode step and a prefill (M = 8, 1024), whisper's
    decoder there and its encoder over 8 x 1500 frames (M = 12,000, K =
    384: few K steps)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple((M, K, N) for _, K, N, ms in mod.family_gemms() for M in ms)


FAMILY_CASES = _family_cases()


@pytest.mark.parametrize("M,K,N", FAMILY_CASES)
def test_family_gemm_shapes_against_plain(dev, M, K, N):
    """At the new families' shapes, one launch each: qmatmul_w8a8
    bit-equal to its plain version, quantize_act bit-equal (12,000 rows),
    qmatmul_w8a8_qin bit-equal to quantize_act + qmatmul_w8a8 where the
    plan folds, qmatmul_w8a16 within its tolerance (bf16, per-tensor
    scale, as the path); the last N tile's columns included."""
    from repro_torch.kernels import gemm_plan, launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8 import (
        qmatmul_w8a8,
        qmatmul_w8a8_qin,
        qmatmul_w8a8_ref,
    )
    from repro_torch.kernels.qmatmul_w8a16 import (
        qmatmul_w8a16,
        qmatmul_w8a16_ref,
    )
    from repro_torch.kernels.quantize_act import quantize_act, quantize_act_ref

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                      generator=g).t()
    sw = torch.rand(N, device=dev, generator=g) * 0.01 + 1e-4
    bias = torch.randn(N, device=dev, generator=g)
    x = (torch.randn((M, K), device=dev, generator=g) * 3).to(bf16)
    reset_launch_counts()
    a_q, a_s = quantize_act(x)
    qr, sr = quantize_act_ref(x)
    assert torch.equal(a_q, qr) and torch.equal(a_s, sr)
    y = qmatmul_w8a8(a_q, w, a_s, sw, bias, out_dtype=bf16)
    assert torch.equal(y, qmatmul_w8a8_ref(a_q, w, a_s, sw, bias, bf16))
    assert launch_counts()["qmatmul_w8a8"] == 1
    if gemm_plan.plan(M, N, K).fold:
        reset_launch_counts()
        yq = qmatmul_w8a8_qin(x, w, sw, bias, out_dtype=bf16)
        assert launch_counts()["qmatmul_w8a8_qin"] == 1
        assert torch.equal(yq, y)
    s1 = (torch.rand((1,), device=dev, generator=g) * 0.01 + 1e-4).to(bf16)
    b16 = bias.to(bf16)
    reset_launch_counts()
    y16 = qmatmul_w8a16(x, w, s1, b16)
    assert launch_counts()["qmatmul_w8a16"] == 1
    yr = qmatmul_w8a16_ref(x, w, s1, b16, bf16)
    diff = (y16.float() - yr.float()).abs()
    tol = _w8a16_tolerance(x, w, s1, b16, yr)
    assert bool((diff <= tol).all()), (M, K, N, float(diff.max()))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_family_smoke_on_the_card_matches_the_cpu(dev, arch):
    """A smoke model of each new family on host-drawn weights under
    serve-w8a8, quantized on the card and on the CPU: every payload,
    scale and weight bit-equal; prefill and 4 greedy decode steps on the
    card (kernels launched) within 5 % of the largest |logit| of the CPU's
    (plain versions) on the same tokens."""
    import repro_torch
    from repro_torch.data import prng
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quantized.qtensor import QTensor

    model = repro_torch.build_model(repro_torch.get_config(arch, smoke=True))
    cfg = model.cfg
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    frames = (torch.from_numpy(prng.normal(prng.PRNGKey(3), (
        2, cfg.enc_seq, cfg.d_model))) if cfg.is_encdec else None)
    out, trees = {}, {}
    for d in ("cpu", dev):
        qm = repro_torch.quantize(model, params, device=d, recipe="serve-w8a8")
        trees[str(d)] = qm.params
        cache = model.init_cache(2, 16, device=d)
        if frames is not None:
            cache = model.warm_cache(qm.params, frames.to(d), cache)
        reset_launch_counts()
        lg, cache = model.prefill(qm.params, toks[:, :8].to(d), cache)
        steps = [lg]
        for t in range(8, 12):
            lg, cache = model.decode_step(qm.params, toks[:, t:t + 1].to(d),
                                          cache)
            steps.append(lg)
        out[str(d)] = torch.stack(steps).float().cpu()
    counts = launch_counts()
    # the card's run (the last): every input through the W8A8 kernels
    # (smoke rows fold: the quantize-in GEMM, and int8 GEMMs beside it)
    assert counts["qmatmul_w8a8_qin"] + counts["qmatmul_w8a8"] > 0, counts

    def qleaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from qleaves(v)
        elif isinstance(tree, QTensor):
            yield tree

    for a, b in zip(qleaves(trees["cpu"]), qleaves(trees[str(dev)])):
        assert torch.equal(a.q, b.q.cpu()) and torch.equal(a.scale,
                                                           b.scale.cpu())
    diff = float((out["cpu"] - out[str(dev)]).abs().max())
    assert diff <= 0.05 * float(out["cpu"].abs().max()), diff


def test_idle_engine_step_launches_nothing_on_the_card(dev):
    """The async server steps the engine while only sleepers remain: with
    nothing in flight a fast-path step (graphs captured by warmup) moves
    the clock one tick and replays no graph — no kernel launched."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine

    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe="serve-w8a16-kv8",
                              device=dev)
    eng = ServingEngine(qm.model, qm.params, qm.cfg, num_slots=2, max_len=32,
                        prefill_chunk=8, device=dev)
    eng.warmup()
    reset_launch_counts()
    clock = eng.clock
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    assert eng.clock == clock + 3
    assert not any(launch_counts().values()), launch_counts()


def test_qmatmul_w8a8_i32_and_epilogue_bit_equal(dev):
    """The epilogue-free W8A8 GEMM writes the exact int32 accumulator (its
    plain version's), and the scale epilogue after it gives
    ``qmatmul_w8a8``'s bits, at ragged and split shapes, the cut shapes of
    a model axis of 2 among them."""
    from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8
    from repro_torch.kernels.qmatmul_w8a8.ops import qmatmul_w8a8_i32
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_i32_ref,
        w8a8_epilogue,
    )

    for M, K, N in ((1, 16, 8), (5, 33, 17), (8, 448, 896), (8, 2432, 896),
                    (256, 2432, 896)) + SPLIT_CASES:
        a = torch.randint(-128, 128, (M, K), device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8).t()
        sa, sw = torch.rand(M, device=dev), torch.rand(N, device=dev)
        bias = torch.randn(N, device=dev)
        acc = qmatmul_w8a8_i32(a, w)
        assert acc.dtype == torch.int32
        assert torch.equal(acc, qmatmul_w8a8_i32_ref(a, w)), (M, K, N)
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(w8a8_epilogue(acc, sa, sw, bias, out),
                               qmatmul_w8a8(a, w, sa, sw, bias,
                                            out_dtype=out)), (M, K, N, out)


def test_one_rank_nccl_mesh_serves_the_single_device_tokens(dev):
    """A 1x1 NCCL mesh (one process, its own 1-rank group): the fast path
    captures the mesh's collectives in its CUDA graphs, and serve-w8a8-kv8-tp
    gives the single-device engine's tokens."""
    import torch.distributed as dist

    import repro_torch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serving import Request, ServingEngine

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    qm = repro_torch.quantize("qwen2-0.5b-smoke", recipe="serve-w8a8-kv8-tp",
                              device=dev)
    reqs = [Request(rid=i, prompt=list(range(3 + 2 * i)), max_new_tokens=5)
            for i in range(4)]
    kw = dict(num_slots=2, max_len=32, prefill_chunk=8, device=dev)
    single = ServingEngine.from_quantized(qm, **kw).run(
        [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5) for r in reqs])
    mesh = make_production_mesh(shape=(1, 1), device=dev)
    try:
        eng = ServingEngine.from_quantized(qm, mesh=mesh, **kw)
        assert eng.stats["graphs"] == 1
        assert eng.warmup()["graphs"] > 0
        got = eng.run(reqs)
    finally:
        dist.destroy_process_group()
    assert {r: v.tokens for r, v in got.items()} == \
        {r: v.tokens for r, v in single.items()}


def test_expert_batched_int32_gemm_one_launch_bit_equal(dev):
    """The epilogue-free W8A8 GEMM with an expert axis is ONE launch (its
    own counter), each expert's accumulator its plain version's, and the
    scale epilogue after it the expert-batched ``qmatmul_w8a8``'s bits, at
    ragged shapes and at mixtral's and llama4's per-rank down projections
    (a model axis of 2)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a8 import qmatmul_w8a8
    from repro_torch.kernels.qmatmul_w8a8.ops import qmatmul_w8a8_i32
    from repro_torch.kernels.qmatmul_w8a8.ref import (
        qmatmul_w8a8_i32_ref,
        w8a8_epilogue,
    )

    for E, M, K, N in ((3, 5, 33, 17), (4, 8, 64, 96), (8, 8, 8192, 6144),
                       (8, 80, 8192, 6144), (16, 16, 4096, 5120)):
        a = torch.randint(-128, 128, (E, M, K), device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (E, N, K), device=dev,
                          dtype=torch.int8).transpose(1, 2)
        reset_launch_counts()
        acc = qmatmul_w8a8_i32(a, w)
        assert launch_counts().get("qmatmul_w8a8_i32_experts") == 1
        assert acc.shape == (E, M, N) and acc.dtype == torch.int32
        for e in range(E):
            assert torch.equal(acc[e], qmatmul_w8a8_i32_ref(a[e], w[e])), (
                E, M, K, N, e)
        sa = torch.rand((E, M), device=dev) * 0.05 + 1e-4
        sw = torch.rand((E, 1), device=dev) * 0.01 + 1e-4
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(w8a8_epilogue(acc, sa, sw, None, out),
                               qmatmul_w8a8(a, w, sa, sw, None,
                                            out_dtype=out)), (E, M, K, N)


def test_one_rank_nccl_mesh_serves_moe_as_one_device(dev):
    """A 1x1 NCCL mesh over mixtral-smoke under serve-w8a8-kv8-tp: the fast
    path's graphs capture the collectives (and the expert-batched int32
    GEMM of the row-parallel expert down), the single-device tokens."""
    import torch.distributed as dist

    import repro_torch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serving import Request, ServingEngine

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    qm = repro_torch.quantize("mixtral-8x22b-smoke",
                              recipe="serve-w8a8-kv8-tp", device=dev)
    reqs = [Request(rid=i, prompt=list(range(3 + 2 * i)), max_new_tokens=5)
            for i in range(4)]
    kw = dict(num_slots=2, max_len=16, prefill_chunk=4, device=dev)
    single = ServingEngine.from_quantized(qm, **kw).run(
        [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5) for r in reqs])
    mesh = make_production_mesh(shape=(1, 1), device=dev)
    try:
        eng = ServingEngine.from_quantized(qm, mesh=mesh, **kw)
        assert eng.stats["graphs"] == 1
        assert eng.warmup()["graphs"] > 0
        got = eng.run(reqs)
    finally:
        dist.destroy_process_group()
    assert {r: v.tokens for r, v in got.items()} == \
        {r: v.tokens for r, v in single.items()}


def test_head_local_prefill_attention_bit_equal_on_the_card(dev):
    """A prefill chunk's attention over the int8 cache of half the KV heads
    (a head-local rank of a model axis of 2) is bit-equal to those heads of
    the whole attention: each KV head's group of q heads is one call, so
    the batched GEMMs see the same shapes on one device and on a rank."""
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(0)
    B, T, S, Hq, Hkv, hd = 1, 206, 256, 14, 2, 64
    dims = layers.AttnDims(n_q=Hq, n_kv=Hkv, head_dim=hd)
    q = torch.randn((B, T, Hq, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, Hkv, hd), generator=g, device=dev).to(torch.bfloat16)
    kpos = torch.full((B, S), -1, dtype=torch.int64, device=dev)
    slots = layers.slot_write(kpos, torch.arange(T, device=dev)[None])

    def cache(h):
        return {"k": torch.zeros((B, S, h, hd), dtype=torch.int8, device=dev),
                "v": torch.zeros((B, S, h, hd), dtype=torch.int8, device=dev),
                "k_scale": torch.zeros((B, S, h), device=dev),
                "v_scale": torch.zeros((B, S, h), device=dev)}

    whole, _ = layers._cached_attention(q, k, v, dims, cache(Hkv), slots,
                                        None, torch.bfloat16, False)
    whole = whole.reshape(B, T, Hq, hd)
    half = Hq // 2
    for r in range(2):
        got, _ = layers._cached_attention(
            q[:, :, r * half:(r + 1) * half], k[:, :, r:r + 1],
            v[:, :, r:r + 1], dims, cache(1), slots, None, torch.bfloat16,
            False)
        assert torch.equal(got.reshape(B, T, half, hd),
                           whole[:, :, r * half:(r + 1) * half]), r


@pytest.mark.parametrize("E,M,K,N", [(8, 8, 8192, 6144), (8, 80, 8192, 6144),
                                     (16, 16, 4096, 5120), (3, 5, 33, 17)])
def test_expert_down_float32_partials_one_launch(dev, E, M, K, N):
    """W8A16's row-parallel expert down at a model axis of 2 (mixtral's and
    llama4's per-rank shapes, and a ragged one): the bf16 hidden rows taken
    in float32 with the bf16-cast per-expert scale, as ``_row_linear``
    passes them, are ONE expert-batched launch of the float32 kernel, each
    expert's float32 partial within W8A16_TOL of its plain version."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.qmatmul_w8a16 import qmatmul_w8a16
    from repro_torch.kernels.qmatmul_w8a16.ref import qmatmul_w8a16_ref

    g = torch.Generator(device=dev).manual_seed(E * M + K)
    x = torch.randn((E, M, K), device=dev, generator=g).to(
        torch.bfloat16).float()
    w = torch.randint(-127, 128, (E, N, K), device=dev, generator=g,
                      dtype=torch.int8).transpose(1, 2)
    s16 = (torch.rand((E, 1), device=dev, generator=g) * 0.01
           + 1e-4).to(torch.bfloat16)
    reset_launch_counts()
    y = qmatmul_w8a16(x, w, s16, None)
    assert launch_counts()["qmatmul_w8a16"] == 1
    assert y.dtype == torch.float32 and y.shape == (E, M, N)
    for e in range(E):
        yr = qmatmul_w8a16_ref(x[e], w[e], s16[e], None, torch.float32)
        diff = (y[e] - yr).abs()
        tol = _w8a16_tolerance(x[e], w[e], s16[e], None, yr)
        assert bool((diff <= tol).all()), (e, float(diff.max()))


@pytest.mark.parametrize("Hq,Hkv,hd", [(14, 2, 64), (48, 8, 128)],
                         ids=["qwen2", "mixtral"])
def test_prefill_attention_rows_bit_equal_to_their_halves(dev, Hq, Hkv, hd):
    """A prefill chunk's attention over the int8 cache at the engine's
    shape (8 slots x 32 tokens, 512 positions; qwen2's and mixtral's
    heads) is bit-equal, row for row, to the same rows run as two halves of
    4 slots — what a rank of a data axis of 2 prefills: the batched GEMMs'
    batch does not change the bits."""
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(1)
    B, T, S = 8, 32, 512
    dims = layers.AttnDims(n_q=Hq, n_kv=Hkv, head_dim=hd)
    bf = torch.bfloat16
    q = torch.randn((B, T, Hq, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, T, Hkv, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, T, Hkv, hd), generator=g, device=dev).to(bf)
    start = torch.randint(0, S - T, (B,), generator=g, device=dev)
    pos = start[:, None] + torch.arange(T, device=dev)[None]
    kpos = torch.where(torch.arange(S, device=dev)[None] < start[:, None],
                       torch.arange(S, device=dev)[None], -1)
    keys = torch.randint(-127, 128, (B, S, Hkv, hd), generator=g, device=dev,
                         dtype=torch.int8)
    vals = torch.randint(-127, 128, (B, S, Hkv, hd), generator=g, device=dev,
                         dtype=torch.int8)
    ks = torch.rand((B, S, Hkv), generator=g, device=dev) * 0.05
    vs = torch.rand((B, S, Hkv), generator=g, device=dev) * 0.05

    def attend(rows):
        slots = layers.slot_write(kpos[rows].clone(), pos[rows])
        cache = {"k": keys[rows].clone(), "v": vals[rows].clone(),
                 "k_scale": ks[rows].clone(), "v_scale": vs[rows].clone()}
        out, _ = layers._cached_attention(q[rows], k[rows], v[rows], dims,
                                          cache, slots, None, bf, False)
        return out

    whole = attend(slice(0, B))
    halves = torch.cat([attend(slice(0, B // 2)), attend(slice(B // 2, B))])
    assert torch.equal(whole, halves)
