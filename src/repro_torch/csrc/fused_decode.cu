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
// Design (simple and right first): one block of 256 threads per batch row,
// walking S in tiles of 64 positions through shared memory (rows padded by 4
// bytes so the score pass reads without bank conflicts). B blocks leave most
// of the 132 SMs idle; splitting S across blocks is a later PR. The new
// token's payload is written to global memory before the attention loop and
// made visible to the block by __syncthreads(); the cache pointers are never
// read through the read-only path, so the block sees its own write.
#include "common.cuh"

namespace {

constexpr int TS = 64;       // cache positions per tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

struct Smem {
  float* qs;     // [Hq*hd]
  float* acc;    // [Hq*hd]
  float* m;      // [Hq]
  float* l;      // [Hq]
  float* corr;   // [Hq]
  float* sc;     // [Hq*TS] scores, then probabilities
  float* kse;    // [TS*Hkv] effective K scales
  float* vse;    // [TS*Hkv]
  float* red;    // [32]
  int8_t* kt;    // [TS*row] K tile, row = Hkv*hd + 4 bytes
  int8_t* vt;    // [TS*row]
};

__host__ __device__ inline size_t smem_bytes(int Hq, int Hkv, int hd) {
  const size_t row = static_cast<size_t>(Hkv) * hd + 4;
  return sizeof(float) * (2 * Hq * hd + 3 * Hq + Hq * TS + 2 * TS * Hkv + 32) +
         2 * TS * row;
}

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
  const int group = Hq / Hkv, HD = Hq * hd, row = Hkv * hd + 4;

  Smem sm;
  float* f = reinterpret_cast<float*>(smem_raw);
  sm.qs = f; f += HD;
  sm.acc = f; f += HD;
  sm.m = f; f += Hq;
  sm.l = f; f += Hq;
  sm.corr = f; f += Hq;
  sm.sc = f; f += Hq * TS;
  sm.kse = f; f += TS * Hkv;
  sm.vse = f; f += TS * Hkv;
  sm.red = f; f += 32;
  sm.kt = reinterpret_cast<int8_t*>(f);
  sm.vt = sm.kt + TS * row;

  const size_t cache_row = static_cast<size_t>(Hkv) * hd;  // bytes per position
  int8_t* kq_b = kq + static_cast<size_t>(b) * S * cache_row;
  int8_t* vq_b = vq + static_cast<size_t>(b) * S * cache_row;
  float* ks_b = ks + static_cast<size_t>(b) * S * Hkv;
  float* vs_b = vs + static_cast<size_t>(b) * S * Hkv;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * S;

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
  // ---- query and running state
  for (int i = tid; i < HD; i += THREADS) {
    sm.qs[i] = repro::to_f32(q[static_cast<size_t>(b) * HD + i]);
    sm.acc[i] = 0.f;
  }
  for (int h = tid; h < Hq; h += THREADS) {
    sm.m[h] = NEG;
    sm.l[h] = 0.f;
  }
  __syncthreads();  // the appended token is now visible to every thread

  const bool vec4 = (cache_row % 4) == 0;
  for (int s0 = 0; s0 < S; s0 += TS) {
    const int n = min(TS, S - s0);
    // ---- 2a. stage the tile: payload rows and masked (effective) scales
    if (vec4) {
      const int words = static_cast<int>(cache_row / 4);
      for (int i = tid; i < n * words; i += THREADS) {
        const int t = i / words, w = i % words;
        const size_t g = (static_cast<size_t>(s0 + t) * cache_row) / 4 + w;
        reinterpret_cast<int*>(sm.kt + t * row)[w] = reinterpret_cast<const int*>(kq_b)[g];
        reinterpret_cast<int*>(sm.vt + t * row)[w] = reinterpret_cast<const int*>(vq_b)[g];
      }
    } else {
      for (int i = tid; i < n * static_cast<int>(cache_row); i += THREADS) {
        const int t = i / static_cast<int>(cache_row), c = i % static_cast<int>(cache_row);
        sm.kt[t * row + c] = kq_b[static_cast<size_t>(s0 + t) * cache_row + c];
        sm.vt[t * row + c] = vq_b[static_cast<size_t>(s0 + t) * cache_row + c];
      }
    }
    for (int i = tid; i < TS * Hkv; i += THREADS) {
      const int t = i / Hkv, h = i % Hkv;
      const bool live = t < n && valid_b[s0 + t] != 0;
      sm.kse[i] = live ? ks_b[(s0 + t) * Hkv + h] : 0.f;
      sm.vse[i] = live ? vs_b[(s0 + t) * Hkv + h] : 0.f;
    }
    __syncthreads();
    // ---- 2b. scores s[h, t] = (q_h . (k_t * ks_t)) * scale, masked
    for (int e = tid; e < Hq * TS; e += THREADS) {
      const int h = e / TS, t = e % TS, kvh = h / group;
      const float kscale = sm.kse[t * Hkv + kvh];
      float sc = NEG;
      if (kscale > 0.f) {
        const int8_t* kr = sm.kt + t * row + kvh * hd;
        const float* qh = sm.qs + h * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d)
          dot += qh[d] * (static_cast<float>(kr[d]) * kscale);
        sc = dot * scale;
      }
      sm.sc[e] = sc;
    }
    __syncthreads();
    // ---- 2c. online-softmax update, one warp per head
    for (int h = warp; h < Hq; h += n_warps) {
      float mx = NEG;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sm.sc[h * TS + t]);
      mx = repro::warp_max(mx);
      const float m_old = sm.m[h];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = expf(sm.sc[h * TS + t] - m_new);
        sm.sc[h * TS + t] = p;
        psum += p;
      }
      psum = repro::warp_sum(psum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sm.corr[h] = c;
        sm.l[h] = sm.l[h] * c + psum;
        sm.m[h] = m_new;
      }
    }
    __syncthreads();
    // ---- 2d. acc = acc * corr + sum_t p[h, t] * (v_t * vs_t)
    for (int e = tid; e < HD; e += THREADS) {
      const int h = e / hd, d = e % hd, kvh = h / group;
      const float* p = sm.sc + h * TS;
      float pv = 0.f;
      for (int t = 0; t < TS; ++t)
        pv += p[t] * (static_cast<float>(sm.vt[t * row + kvh * hd + d]) * sm.vse[t * Hkv + kvh]);
      sm.acc[e] = sm.acc[e] * sm.corr[h] + pv;
    }
    __syncthreads();
  }

  // ---- 3. normalize and cast; keep the cast value for the epilogue
  float amax = 0.f;
  for (int e = tid; e < HD; e += THREADS) {
    const T o = repro::from_f32<T>(__fdiv_rn(sm.acc[e], fmaxf(sm.l[e / hd], 1e-30f)));
    out[static_cast<size_t>(b) * HD + e] = o;
    const float of = repro::to_f32(o);
    sm.acc[e] = of;
    amax = fmaxf(amax, fabsf(of));
  }
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
  const size_t bytes = smem_bytes(Hq, Hkv, hd);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
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
