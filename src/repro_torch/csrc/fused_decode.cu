// Fused decode step: append-quantize the new token's K/V into the int8 cache
// in place, attend over the updated cache, optionally re-quantize the output.
//
// Replaces: fused_decode_pallas (src/repro/kernels/fused_decode/kernel.py:143).
// Computes, for each batch row b (one block each):
//   1. k_new/v_new [Hkv, hd] -> int8 payload + scale max(|t|,1e-8)/127 per
//      head, clipped to +-127, written to ring slot idx[b] of the cache;
//   2. online softmax over the S cache positions with float32 m, l, acc, GQA
//      by h / group, the effective scale set to 0 where valid[b, s] == 0 and
//      masked scores set to -1e30 (never -inf: a fully masked row gives 0);
//   3. out = acc / max(l, 1e-30) cast to the output dtype;
//   4. with quantize_out: per-row quantize of the cast output flattened to
//      [Hq*hd], clipped to [-128, 127] (the quantize_act formula).
// The stored scales are unmasked; only the attention reads see `valid`.
// Bound on the H100: bytes. The int8 cache is read once per step,
// B*S*Hkv*(hd+4)*2 bytes (8*512*2*68*2 = 1.1 MB at the main path's shapes,
// 0.3 us at 3.35 TB/s), against ~4*B*Hq*S*hd = 29 MFLOP of float32 work.
// Design (simple and right first): one block of 256 threads per batch row.
// Steps 2 and 3 are the attention body of decode_attention.cuh, shared with
// kv_attention.cu (tiles of 64 positions, the same thread mapping and sum
// order), so this kernel and append-quantize followed by the kv_attention
// kernel give the same bits. B blocks leave most of the 132 SMs idle;
// splitting S across blocks is a later PR, for both kernels together. The
// new token's payload is written to global memory before the attention loop
// and made visible to the block by its first __syncthreads(); the cache is
// never read through the read-only path, so the block sees its own write.
#include "decode_attention.cuh"

namespace {

using namespace repro::attn;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_decode_kernel(const T* __restrict__ q, int8_t* kq, float* ks, int8_t* vq,
                    float* vs, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, const int* __restrict__ idx,
                    const uint8_t* __restrict__ valid, T* __restrict__ out,
                    int8_t* __restrict__ oq, float* __restrict__ os, int S,
                    int Hq, int Hkv, int hd, float scale, int quantize_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = THREADS / 32;
  const int HD = Hq * hd;
  const Smem sm = carve(smem_raw, Hq, Hkv, hd, false);

  const size_t cache_row = static_cast<size_t>(Hkv) * hd;  // bytes per position
  int8_t* kq_b = kq + static_cast<size_t>(b) * S * cache_row;
  int8_t* vq_b = vq + static_cast<size_t>(b) * S * cache_row;
  float* ks_b = ks + static_cast<size_t>(b) * S * Hkv;
  float* vs_b = vs + static_cast<size_t>(b) * S * Hkv;

  // ---- 1. append-quantize: one warp per (K|V, head)
  const int pos = idx[b];
  if (pos >= 0 && pos < S) {
    for (int w = warp; w < 2 * Hkv; w += n_warps) {
      const int h = w % Hkv;
      const bool is_v = w >= Hkv;
      const T* src = (is_v ? v_new : k_new) + (static_cast<size_t>(b) * Hkv + h) * hd;
      float amax = 0.f;
      for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(repro::to_f32(src[d])));
      amax = repro::warp_max(amax);
      const float s = repro::absmax_scale(amax);
      int8_t* dst = (is_v ? vq_b : kq_b) + pos * cache_row + h * hd;
      for (int d = lane; d < hd; d += 32)
        dst[d] = repro::quantize_one(repro::to_f32(src[d]), s, -127.f);
      if (lane == 0) (is_v ? vs_b : ks_b)[pos * Hkv + h] = s;
    }
  }
  // ---- 2. attend over the updated cache (its first barrier makes the
  //         appended token visible to every thread)
  attend<T>(sm, q + static_cast<size_t>(b) * HD, kq_b, ks_b, vq_b, vs_b, nullptr,
            valid + static_cast<size_t>(b) * S, S, Hq, Hkv, hd, scale);
  // ---- 3. normalize and cast; the cast value stays for the epilogue
  float amax = finish<T>(sm, out + static_cast<size_t>(b) * HD, Hq, hd);
  if (!quantize_out) return;
  // ---- 4. quantize-out: the quantize_act formula on the cast row
  amax = repro::block_max_nonneg(amax, sm.red);
  const float oscale = repro::absmax_scale(amax);
  for (int e = tid; e < HD; e += THREADS)
    oq[static_cast<size_t>(b) * HD + e] = repro::quantize_one(sm.acc[e], oscale, -128.f);
  if (tid == 0) os[b] = oscale;
}

template <typename T>
int launch(const void* q, void* kq, void* ks, void* vq, void* vs,
           const void* k_new, const void* v_new, const void* idx,
           const void* valid, void* out, void* oq, void* os, int B, int S,
           int Hq, int Hkv, int hd, float scale, int quantize_out,
           cudaStream_t st) {
  const size_t bytes = smem_bytes(Hq, Hkv, hd, false);
  const cudaError_t e = reserve_smem(fused_decode_kernel<T>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_decode_kernel<T><<<B, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<int8_t*>(kq), static_cast<float*>(ks),
      static_cast<int8_t*>(vq), static_cast<float*>(vs),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const int*>(idx), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), static_cast<int8_t*>(oq), static_cast<float*>(os),
      S, Hq, Hkv, hd, scale, quantize_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, hd], k_new / v_new [B, Hkv, hd], out [B, Hq, hd] in float32
// (is_bf16 == 0) or bfloat16; kq / vq [B, S, Hkv, hd] int8 and ks / vs
// [B, S, Hkv] float32, updated in place; idx [B] int32; valid [B, S] uint8;
// oq [B, Hq*hd] int8 and os [B] float32 (written only with quantize_out).
extern "C" int repro_fused_decode(const void* q, void* kq, void* ks, void* vq,
                                  void* vs, const void* k_new, const void* v_new,
                                  const void* idx, const void* valid, void* out,
                                  void* oq, void* os, int B, int S, int Hq,
                                  int Hkv, int hd, float scale,
                                  int quantize_out, int is_bf16, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, k_new, v_new, idx, valid, out,
                                 oq, os, B, S, Hq, Hkv, hd, scale, quantize_out, st);
  return launch<float>(q, kq, ks, vq, vs, k_new, v_new, idx, valid, out, oq, os,
                       B, S, Hq, Hkv, hd, scale, quantize_out, st);
}
