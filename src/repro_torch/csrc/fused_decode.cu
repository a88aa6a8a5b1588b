// Fused decode step: append-quantize the new token's K/V into the int8 cache
// in place, attend over the updated cache, optionally re-quantize the output.
//
// Replaces: fused_decode_pallas (src/repro/kernels/fused_decode/kernel.py:143).
// Computes, for each batch row b:
//   1. k_new/v_new [Hkv, hd] -> int8 payload + scale max(|t|,1e-8)/127 per
//      head, clipped to +-127, written to ring slot idx[b] of the cache
//      (nothing where idx[b] lies outside [0, S));
//   2. online softmax over the S cache positions with float32 m, l, acc, GQA
//      by h / group, the effective scale set to 0 where valid[b, s] == 0 and
//      masked scores set to -1e30 (never -inf: a fully masked row gives 0);
//   3. out = acc / max(l, 1e-30) cast to the output type (float32 or
//      bfloat16, chosen apart from q's type);
//   4. with quantize_out: per-row quantize of the cast output flattened to
//      [Hq*hd], clipped to [-128, 127] (the quantize_act formula).
// The stored scales are unmasked; only the attention reads see `valid`.
// Bound on the H100: bytes. The int8 cache is read once per step,
// B*S*Hkv*(hd+4)*2 bytes (8*512*2*68*2 = 1.1 MB at the main path's shapes,
// 0.3 us at 3.35 TB/s), against ~4*B*Hq*S*hd = 29 MFLOP of float32 work.
// Design: the split-S kernel of decode_attention.cuh, shared with
// kv_attention.cu (the same tiles, plan, thread mapping and sum order), so
// this kernel and append-quantize followed by the kv_attention kernel give
// the same bits. Only the CTA whose positions hold idx[b] writes the new
// token of its kv head, before it stages a tile; the quantize-out takes the
// row's max across the kv heads through a per-stream scratch that the last
// finisher of the row puts back to 0.
#include "decode_attention.cuh"

// q [B, Hq, hd], k_new / v_new [B, Hkv, hd] float32 (q_bf16 == 0) or
// bfloat16; out [B, Hq, hd] float32 (out_bf16 == 0) or bfloat16; kq / vq
// [B, S, Hkv, hd] int8 (16-byte aligned, hd a multiple of 16) and ks / vs
// [B, S, Hkv] float32, updated in place; idx [B] int32; valid [B, S] uint8;
// oq [B, Hq*hd] int8, os [B] float32 and scratch [2B] uint32 (all zero)
// with quantize_out, else NULL; 1 <= splits <= 16 and at most ceil(S / 64).
extern "C" int repro_fused_decode(const void* q, void* kq, void* ks, void* vq,
                                  void* vs, const void* k_new, const void* v_new,
                                  const void* idx, const void* valid, void* out,
                                  void* oq, void* os, void* scratch, int B,
                                  int S, int Hq, int Hkv, int hd, int splits,
                                  float scale, int q_bf16, int out_bf16,
                                  void* stream) {
  repro::attn::Params p = {};
  p.q = q;
  p.kq = static_cast<int8_t*>(kq);
  p.ks = static_cast<float*>(ks);
  p.vq = static_cast<int8_t*>(vq);
  p.vs = static_cast<float*>(vs);
  p.valid = static_cast<const uint8_t*>(valid);
  p.k_new = k_new;
  p.v_new = v_new;
  p.idx = static_cast<const int*>(idx);
  p.out = out;
  p.oq = static_cast<int8_t*>(oq);
  p.os = static_cast<float*>(os);
  p.scratch = static_cast<unsigned*>(scratch);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.hd = hd;
  p.splits = splits;
  p.scale = scale;
  return repro::attn::launch_any(p, q_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}
