// Single-token decode attention over an int8 KV cache (the unfused decode).
//
// Replaces: kv_attention_pallas (src/repro/kernels/kv_attention/kernel.py:95).
// Computes, for each batch row b: online softmax over the S cache positions
// with float32 m, l, acc; scores (q_h . k_t) * ks_t / sqrt(hd); a position
// whose K scale is 0 is masked with -1e30 (never -inf: a fully masked row
// with zero V scales gives exactly 0); GQA by h / group; out = (acc - e) /
// max(l, 1e-30) cast to the output type (float32 or bfloat16, chosen apart
// from q's type), where e = sum_t p_t * v_err[t] with the optional V error means
// v_err [B, S, Hkv] (the V bias correction; the TPU kernel lacks it and the
// JAX op computes it on XLA) and 0 without them. Any S: the last tile is
// zero-filled and masked, nothing is padded.
// Bound on the H100: bytes. The int8 cache and its scales are read once,
// B*S*Hkv*(hd+4)*2 bytes (+ 4 per position and head with v_err): 1.1 MB at
// the main path's decode shape (0.3 us at 3.35 TB/s), 553 MB at the JAX
// bench's long context (B=8 S=32768 Hkv=8 hd=128: 165 us), against
// ~4*B*Hq*S*hd float32 operations (~16 a cache byte at GQA 4).
// Design: the split-S kernel of decode_attention.cuh, shared with
// fused_decode.cu: one CTA per (split, kv head, batch row), a cp.async ring
// of tiles, the splits of a (b, kv head) combined by their cluster's rank 0
// in the same launch; kernels/attention_plan.py picks the split count.
#include "decode_attention.cuh"

// q [B, Hq, hd] float32 (q_bf16 == 0) or bfloat16; out [B, Hq, hd] float32
// (out_bf16 == 0) or bfloat16; kq / vq [B, S, Hkv, hd] int8; ks / vs
// [B, S, Hkv] float32; ve [B, S, Hkv] float32 or NULL. All contiguous;
// kq / vq 16-byte aligned, hd a multiple of 16; 1 <= splits <= 16 and at
// most ceil(S / 64).
extern "C" int repro_kv_attention(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* ve,
                                  void* out, int B, int S, int Hq, int Hkv,
                                  int hd, int splits, float scale, int q_bf16,
                                  int out_bf16, void* stream) {
  repro::attn::Params p = {};
  p.q = q;
  p.kq = static_cast<int8_t*>(const_cast<void*>(kq));
  p.ks = static_cast<float*>(const_cast<void*>(ks));
  p.vq = static_cast<int8_t*>(const_cast<void*>(vq));
  p.vs = static_cast<float*>(const_cast<void*>(vs));
  p.ve = static_cast<const float*>(ve);
  p.out = out;
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.hd = hd;
  p.splits = splits;
  p.scale = scale;
  return repro::attn::launch_any(p, q_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}
