// The single-token attention body over an int8 KV cache that the unfused
// (kv_attention.cu) and the fused (fused_decode.cu) decode kernels share, so
// that both give the same bits for the same effective scales — the JAX
// package's contract that fusing changes nothing numerically.
//
// One block of THREADS threads attends for one batch row b:
//   * the cache is walked in tiles of TS = 64 positions through shared
//     memory (payload rows padded by 4 bytes so the score pass reads without
//     bank conflicts);
//   * a position's effective K/V scale is 0 past S, where `valid` (nullable,
//     [S] bytes) is 0, or where the stored scale is 0; a zero K scale forces
//     the score to -1e30 (never -inf: a fully masked row gives exactly 0
//     when its V scales are 0 too);
//   * online softmax in float32 (m, l, acc), GQA by h / group;
//   * an optional per-position V error mean `v_err` ([S, Hkv], nullable) is
//     carried beside acc as e = sum_t p[t] * v_err[t], rescaled by the same
//     correction, and subtracted before the division by l: the V bias
//     correction (paper §4.2 applied to the int8 V cache).
// Threads map to (head, position) in the score pass, to (head, dim) in the
// value pass, and one warp per head does the softmax update; the order of
// every sum is fixed by that mapping.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int TS = 64;       // cache positions per tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
// dynamic shared memory a block may opt into on the H100 (232,448 bytes)
constexpr size_t MAX_SMEM = 227 * 1024;

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
  float* ese;    // [TS*Hkv] effective V error means (with v_err only)
  float* eacc;   // [Hq]
  int8_t* kt;    // [TS*row] K tile, row = Hkv*hd + 4 bytes
  int8_t* vt;    // [TS*row]
};

__host__ __device__ inline size_t smem_bytes(int Hq, int Hkv, int hd, bool with_err) {
  const size_t row = static_cast<size_t>(Hkv) * hd + 4;
  const size_t floats = 2 * static_cast<size_t>(Hq) * hd + 3 * Hq + Hq * TS +
                        2 * TS * Hkv + 32 + (with_err ? TS * Hkv + Hq : 0);
  return sizeof(float) * floats + 2 * TS * row;
}

__device__ inline Smem carve(unsigned char* raw, int Hq, int Hkv, int hd, bool with_err) {
  Smem sm;
  const int HD = Hq * hd, row = Hkv * hd + 4;
  float* f = reinterpret_cast<float*>(raw);
  sm.qs = f; f += HD;
  sm.acc = f; f += HD;
  sm.m = f; f += Hq;
  sm.l = f; f += Hq;
  sm.corr = f; f += Hq;
  sm.sc = f; f += Hq * TS;
  sm.kse = f; f += TS * Hkv;
  sm.vse = f; f += TS * Hkv;
  sm.red = f; f += 32;
  sm.ese = nullptr;
  sm.eacc = nullptr;
  if (with_err) {
    sm.ese = f; f += TS * Hkv;
    sm.eacc = f; f += Hq;
  }
  sm.kt = reinterpret_cast<int8_t*>(f);
  sm.vt = sm.kt + TS * row;
  return sm;
}

// Attend for one batch row. q_b [Hq*hd]; kq_b / vq_b [S, Hkv, hd] int8;
// ks_b / vs_b [S, Hkv]; ve_b [S, Hkv] or nullptr; valid_b [S] or nullptr.
// The cache is read through plain (not read-only) loads, so a block sees
// what it wrote to the cache before it called this. Ends with a
// __syncthreads(); acc, l and eacc are then final in shared memory.
template <typename T>
__device__ void attend(const Smem& sm, const T* q_b, const int8_t* kq_b,
                       const float* ks_b, const int8_t* vq_b, const float* vs_b,
                       const float* ve_b, const uint8_t* valid_b, int S, int Hq,
                       int Hkv, int hd, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = THREADS / 32;
  const int group = Hq / Hkv, HD = Hq * hd, row = Hkv * hd + 4;
  const size_t cache_row = static_cast<size_t>(Hkv) * hd;  // bytes per position
  const bool with_err = ve_b != nullptr;

  for (int i = tid; i < HD; i += THREADS) {
    sm.qs[i] = to_f32(q_b[i]);
    sm.acc[i] = 0.f;
  }
  for (int h = tid; h < Hq; h += THREADS) {
    sm.m[h] = NEG;
    sm.l[h] = 0.f;
    if (with_err) sm.eacc[h] = 0.f;
  }
  __syncthreads();

  const bool vec4 = (cache_row % 4) == 0;
  for (int s0 = 0; s0 < S; s0 += TS) {
    const int n = min(TS, S - s0);
    // ---- stage the tile: payload rows and effective scales
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
      const bool live = t < n && (valid_b == nullptr || valid_b[s0 + t] != 0);
      sm.kse[i] = live ? ks_b[(s0 + t) * Hkv + h] : 0.f;
      sm.vse[i] = live ? vs_b[(s0 + t) * Hkv + h] : 0.f;
      if (with_err) sm.ese[i] = live ? ve_b[(s0 + t) * Hkv + h] : 0.f;
    }
    __syncthreads();
    // ---- scores s[h, t] = (q_h . (k_t * ks_t)) * scale, masked
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
    // ---- online-softmax update, one warp per head
    for (int h = warp; h < Hq; h += n_warps) {
      float mx = NEG;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sm.sc[h * TS + t]);
      mx = warp_max(mx);
      const float m_old = sm.m[h];
      const float m_new = fmaxf(m_old, mx);
      const int kvh = h / group;
      float psum = 0.f, pe = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = expf(sm.sc[h * TS + t] - m_new);
        sm.sc[h * TS + t] = p;
        psum += p;
        if (with_err) pe += p * sm.ese[t * Hkv + kvh];
      }
      psum = warp_sum(psum);
      if (with_err) pe = warp_sum(pe);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sm.corr[h] = c;
        sm.l[h] = sm.l[h] * c + psum;
        sm.m[h] = m_new;
        if (with_err) sm.eacc[h] = sm.eacc[h] * c + pe;
      }
    }
    __syncthreads();
    // ---- acc = acc * corr + sum_t p[h, t] * (v_t * vs_t)
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
}

// out_b[e] = (acc[e] - eacc[h]) / max(l[h], 1e-30) cast to T (the V error
// term only with v_err). Keeps each cast value, as float, in sm.acc for an
// epilogue and returns this thread's max |cast value|.
template <typename T>
__device__ float finish(const Smem& sm, T* out_b, int Hq, int hd) {
  float amax = 0.f;
  for (int e = threadIdx.x; e < Hq * hd; e += THREADS) {
    const int h = e / hd;
    const float a = sm.eacc != nullptr ? sm.acc[e] - sm.eacc[h] : sm.acc[e];
    const T o = from_f32<T>(__fdiv_rn(a, fmaxf(sm.l[h], 1e-30f)));
    out_b[e] = o;
    const float of = to_f32(o);
    sm.acc[e] = of;
    amax = fmaxf(amax, fabsf(of));
  }
  return amax;
}

// Opt a kernel into `bytes` of dynamic shared memory; an error past the
// card's 227 KB.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
}  // namespace repro
