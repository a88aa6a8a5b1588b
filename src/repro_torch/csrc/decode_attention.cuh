// Single-token decode attention over an int8 KV cache, split over the cache
// positions (flash-decoding): the kernel the unfused (kv_attention.cu) and
// the fused (fused_decode.cu) decode share, so that both give the same bits
// for the same effective scales and the same plan — the JAX package's
// contract that fusing changes nothing numerically.
//
// Grid splits x Hkv x B, THREADS threads a CTA. CTA (s, g, b) attends for
// the `group` q heads of kv head g of batch row b over the tiles
// [s * tiles / splits, (s + 1) * tiles / splits) of TS positions
// (kernels/attention_plan.py picks `splits`):
//   * fused only: the CTA whose positions hold idx[b] quantizes the new
//     token's K and V of head g (scale max(|t|, 1e-8) / 127, clip +-127)
//     while its first tiles load, writes them into the cache, and patches
//     them into the staged tile that holds idx[b] once it has landed (that
//     tile's cp.async copy of the row may be old, new or mixed; no other
//     CTA reads head g's row, so no ordering with the copies is needed);
//   * tiles are staged through a ring of STAGES cp.async stages (16-byte
//     payload copies, rows padded by ROW_PAD bytes so the score pass reads
//     16 bytes a lane without bank conflicts; the positions past S
//     zero-filled), so the next tiles load while this one computes;
//   * a position's effective K/V scale is 0 past S, where `valid` (fused,
//     [B, S] bytes, staged with the tile) is 0, or where the stored scale
//     is 0; a zero K scale
//     forces the score to -1e30 (never -inf: a fully masked row gives
//     exactly 0 when its V scales are 0 too);
//   * scores: one thread a (head, position), 16-byte payload loads into
//     four independent float32 sums; online softmax in float32 (m, l, acc),
//     one warp a head; values: one thread a (head, 4 dims) and part of the
//     positions (the parts added in order), 4-byte payload loads, four
//     positions a step into two sums; int8 to float by PRMT + FADD (exact), not
//     the quarter-rate conversion unit; the optional V error means
//     `v_err` ([B, S, Hkv]) are carried as e = sum_t p[t] * v_err[t] beside
//     acc (the V bias correction, paper §4.2 applied to the int8 V cache);
//   * combine, in the same launch: the splits of one (b, g) are a thread
//     block cluster; once all are done, every other rank stores its
//     (m, l, acc, e) into rank 0's (then idle) ring through distributed
//     shared memory, and rank 0 adds them in rank order, each rescaled by
//     exp(m_r - max m): a split whose positions are all masked (m = -1e30)
//     adds exactly nothing once any split is live, and a row with no live
//     position keeps every split's weight 1, as the unsplit walk does;
//   * rank 0 writes out = (acc - e) / max(l, 1e-30) in the output type
//     (IEEE division);
//   * quantize-out (fused, W8A8 route): the row's scale needs the max over
//     all Hkv heads' outputs, which no cluster holds. Each rank 0 raises
//     the row's max in a per-stream scratch and then a counter, with
//     release semantics; the last of the row's Hkv finishers quantizes the
//     row from the cast outputs in global memory (the quantize_act formula,
//     bit-equal to quantize_act of `out`) and puts the scratch back to 0.
//     No CTA waits for another, and the max is order-free: deterministic.
// Every sum has a fixed order, so two calls give the same bits.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int TS = 64;          // cache positions a tile
constexpr int THREADS = 256;
constexpr int STAGES = 3;       // tiles in the cp.async ring
constexpr int ROW_PAD = 16;     // bytes after each staged payload row
constexpr int MAX_SPLITS = 16;  // CTAs in a cluster (non-portable past 8)
constexpr float NEG = -1e30f;
// dynamic shared memory a CTA may opt into on the H100 (232,448 bytes)
constexpr size_t MAX_SMEM = 227 * 1024;

struct Params {
  const void* q;          // [B, Hq, hd] T
  int8_t* kq;             // [B, S, Hkv, hd] cache payloads (written: fused)
  float* ks;              // [B, S, Hkv] cache scales (written: fused)
  int8_t* vq;
  float* vs;
  const float* ve;        // [B, S, Hkv] V error means or nullptr
  const uint8_t* valid;   // [B, S] live positions or nullptr (unfused)
  const void* k_new;      // [B, Hkv, hd] T or nullptr (unfused)
  const void* v_new;
  const int* idx;         // [B] ring offsets of the new token (fused)
  void* out;              // [B, Hq, hd] OT
  int8_t* oq;             // [B, Hq*hd] quantize-out or nullptr
  float* os;              // [B]
  unsigned* scratch;      // [2B] row max bits, finished heads; 0 between calls
  int B, S, Hq, Hkv, hd, splits;
  float scale;            // 1 / sqrt(hd)
};

__host__ __device__ inline size_t fixed_bytes(int G, int hd) {
  const size_t floats = 2 * static_cast<size_t>(G) * hd + G * TS + 3 * TS +
                        4 * G + MAX_SPLITS * G + 32 + 4 * THREADS + 2 + hd / 2;
  return (4 * floats + 15) / 16 * 16;
}

// bytes of `valid` a stage holds: the tile's TS bytes in whole 4-byte words
constexpr int VALID_BYTES = TS + 16;

__host__ __device__ inline size_t stage_bytes(int hd, bool with_err) {
  return 2 * static_cast<size_t>(TS) * (hd + ROW_PAD) + (with_err ? 3 : 2) * TS * 4 +
         VALID_BYTES;
}

// The ring also receives the other splits' states for the combine:
// MAX_SPLITS boxes of G*hd + 4*G floats.
__host__ __device__ inline size_t ring_bytes(int G, int hd, bool with_err) {
  const size_t ring = STAGES * stage_bytes(hd, with_err);
  const size_t boxes = MAX_SPLITS * (static_cast<size_t>(G) * hd + 4 * G) * 4;
  return ring > boxes ? ring : boxes;
}

// A CTA's dynamic shared memory (kernels/attention_plan.py: smem_bytes).
__host__ __device__ inline size_t smem_bytes(int G, int hd, bool with_err) {
  return fixed_bytes(G, hd) + ring_bytes(G, hd, with_err);
}

struct Smem {
  float* qs;     // [G*hd]
  float* acc;    // [G*hd]
  float* sc;     // [G*TS] scores, then probabilities times the V scales
  float* kse;    // [TS] effective K scales of the tile
  float* vse;    // [TS]
  float* ese;    // [TS] effective V error means (with v_err)
  float* m;      // [G]
  float* l;      // [G]
  float* corr;   // [G]
  float* eacc;   // [G]
  float* fac;    // [MAX_SPLITS*G] the combine's factors (rank 0)
  float* red;    // [32]
  float4* pv;    // [THREADS] the value pass's partial sums
  float* newkv;  // fused: the new token's K and V scales, then its payloads
  unsigned char* ring;
};

__device__ inline Smem carve(unsigned char* raw, int G, int hd) {
  Smem sm;
  float* f = reinterpret_cast<float*>(raw);
  sm.qs = f; f += G * hd;
  sm.acc = f; f += G * hd;
  sm.sc = f; f += G * TS;
  sm.kse = f; f += TS;
  sm.vse = f; f += TS;
  sm.ese = f; f += TS;
  sm.m = f; f += G;
  sm.l = f; f += G;
  sm.corr = f; f += G;
  sm.eacc = f; f += G;
  sm.fac = f; f += MAX_SPLITS * G;
  sm.red = f; f += 32;
  sm.pv = reinterpret_cast<float4*>(f); f += 4 * THREADS;
  sm.newkv = f;
  sm.ring = raw + fixed_bytes(G, hd);
  return sm;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The four signed bytes of a 32-bit word, as float (exact), without the
// quarter-rate conversion unit: each byte biased by 128 is placed in the
// mantissa of 2^23 (one PRMT) and 2^23 + 128 subtracted (one FADD).
__device__ __forceinline__ float4 bytes_f32(int w) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  constexpr unsigned TWO23 = 0x4B000000u;  // 2^23 as float bits
  constexpr float BIAS = 8388736.0f;       // 2^23 + 128
  return make_float4(__fsub_rn(__uint_as_float(__byte_perm(u, TWO23, 0x7540)), BIAS),
                     __fsub_rn(__uint_as_float(__byte_perm(u, TWO23, 0x7541)), BIAS),
                     __fsub_rn(__uint_as_float(__byte_perm(u, TWO23, 0x7542)), BIAS),
                     __fsub_rn(__uint_as_float(__byte_perm(u, TWO23, 0x7543)), BIAS));
}

__device__ __forceinline__ float dot4(float4 q, float4 k, float a) {
  return fmaf(q.w, k.w, fmaf(q.z, k.z, fmaf(q.y, k.y, fmaf(q.x, k.x, a))));
}

// *p += v with acquire-release semantics at GPU scope; returns the old value
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// acc[h, 4 d4 .. 4 d4 + 3] = acc * corr[h] + sum
__device__ __forceinline__ void update_acc(const Smem& sm, int h, int d4, int hd,
                                           float4 sum) {
  const float c = sm.corr[h];
  float4* a = reinterpret_cast<float4*>(sm.acc + h * hd) + d4;
  const float4 old = *a;
  *a = make_float4(fmaf(old.x, c, sum.x), fmaf(old.y, c, sum.y), fmaf(old.z, c, sum.z),
                   fmaf(old.w, c, sum.w));
}

// The kernel and its launchers have internal linkage: each of the two
// sources that include this header gets its own instance.
namespace {

template <typename T, typename OT>
__global__ void __launch_bounds__(THREADS) decode_kernel(const Params p) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int n_warps = THREADS / 32;
  const int S = p.S, hd = p.hd, Hkv = p.Hkv, G = p.Hq / Hkv, GH = G * hd;
  const bool with_err = p.ve != nullptr;
  const Smem sm = carve(smem_raw, G, hd);
  const int tiles = (S + TS - 1) / TS;
  const int tile0 = split * tiles / p.splits, tile1 = (split + 1) * tiles / p.splits;
  const size_t row = static_cast<size_t>(Hkv) * hd;  // cache bytes a position
  const size_t pos0 = static_cast<size_t>(b) * S;    // row b's first position
  int8_t* kq_bg = p.kq + pos0 * row + static_cast<size_t>(g) * hd;
  int8_t* vq_bg = p.vq + pos0 * row + static_cast<size_t>(g) * hd;

  // fused: does this CTA hold the new token's position (then it appends)?
  const int pos = p.k_new != nullptr ? p.idx[b] : -1;
  const bool appends = pos >= tile0 * TS && pos < min(tile1 * TS, S);

  const int rstride = hd + ROW_PAD, chunks = hd / 16;
  const size_t sbytes = stage_bytes(hd, with_err);
  auto stage = [&](int tile, int st) {
    unsigned char* base = sm.ring + st * sbytes;
    int8_t* kt = reinterpret_cast<int8_t*>(base);
    int8_t* vt = kt + TS * rstride;
    float* kst = reinterpret_cast<float*>(vt + TS * rstride);
    const int t0 = tile * TS, n = min(TS, S - t0);
    for (int i = tid; i < TS * chunks; i += THREADS) {
      const int t = i / chunks, c = i % chunks;
      const bool in = t < n;
      const size_t src = static_cast<size_t>(t0 + (in ? t : 0)) * row + c * 16;
      cp_async16(kt + t * rstride + c * 16, kq_bg + src, in ? 16 : 0);
      cp_async16(vt + t * rstride + c * 16, vq_bg + src, in ? 16 : 0);
    }
    for (int t = tid; t < TS; t += THREADS) {
      const bool in = t < n;
      const size_t gi = (pos0 + t0 + (in ? t : 0)) * Hkv + g;
      cp_async4(kst + t, p.ks + gi, in ? 4 : 0);
      cp_async4(kst + TS + t, p.vs + gi, in ? 4 : 0);
      if (with_err) cp_async4(kst + 2 * TS + t, p.ve + gi, in ? 4 : 0);
    }
    if (p.valid != nullptr) {
      // the words of `valid` that hold the tile's bytes (valid is 4-byte
      // aligned; the last word may run past B*S and is cut there)
      const size_t first = (pos0 + t0) & ~static_cast<size_t>(3);
      const size_t total = static_cast<size_t>(p.B) * S;
      unsigned char* vb = reinterpret_cast<unsigned char*>(kst + (with_err ? 3 : 2) * TS);
      for (int w = tid; w < VALID_BYTES / 4; w += THREADS) {
        const size_t at = first + 4 * w;
        const int bytes = at >= total ? 0 : static_cast<int>(min(total - at, size_t{4}));
        cp_async4(vb + 4 * w, p.valid + (bytes > 0 ? at : 0), bytes);
      }
    }
  };

  const int nt = tile1 - tile0;
  // the value pass's units (head, 4 dims) and position parts (1, 2 or 4)
  const int quads = hd / 4, units = G * quads;
  int parts = 1;
  while (parts < 4 && 2 * parts * units <= THREADS) parts *= 2;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) stage(tile0 + i, i);
    cp_async_commit();
  }
  // ---- fused: append-quantize the new token of head g (warp 0 K, warp 1
  //      V) while the first tiles load: into the cache and into `newkv`,
  //      from which the staged tile that holds it is patched (its cp.async
  //      copy may hold the old row or part of the new one)
  if (appends && warp < 2) {
    const T* src = static_cast<const T*>(warp ? p.v_new : p.k_new) +
                   (static_cast<size_t>(b) * Hkv + g) * hd;
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(to_f32(src[d])));
    amax = warp_max(amax);
    const float s = absmax_scale(amax);
    int8_t* dst = (warp ? vq_bg : kq_bg) + static_cast<size_t>(pos) * row;
    int8_t* mine = reinterpret_cast<int8_t*>(sm.newkv + 2) + warp * hd;
    for (int d = lane; d < hd; d += 32) {
      const int8_t v = quantize_one(to_f32(src[d]), s, -127.f);
      dst[d] = v;
      mine[d] = v;
    }
    if (lane == 0) {
      (warp ? p.vs : p.ks)[(pos0 + pos) * Hkv + g] = s;
      sm.newkv[warp] = s;
    }
  }
  // q and the softmax state while the first tiles load (the loop's first
  // barrier publishes them)
  const T* q_bg = static_cast<const T*>(p.q) + (static_cast<size_t>(b) * p.Hq + g * G) * hd;
  for (int i = tid; i < GH; i += THREADS) {
    sm.qs[i] = to_f32(q_bg[i]);
    sm.acc[i] = 0.f;
  }
  for (int h = tid; h < G; h += THREADS) {
    sm.m[h] = NEG;
    sm.l[h] = 0.f;
    sm.eacc[h] = 0.f;
  }

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i is in the ring; tile i - 1's stage is free
    if (i + STAGES - 1 < nt) stage(tile0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    unsigned char* base = sm.ring + (i % STAGES) * sbytes;
    int8_t* kt = reinterpret_cast<int8_t*>(base);
    int8_t* vt = kt + TS * rstride;
    float* kst = reinterpret_cast<float*>(vt + TS * rstride);
    const int t0 = (tile0 + i) * TS, n = min(TS, S - t0);
    if (appends && pos >= t0 && pos < t0 + TS) {
      // ---- fused: the new token into the staged tile
      const int8_t* nkv = reinterpret_cast<const int8_t*>(sm.newkv + 2);
      for (int j = tid; j < 2 * hd; j += THREADS)
        (j < hd ? kt : vt - hd)[(pos - t0) * rstride + j] = nkv[j];
      if (tid == 0) {
        kst[pos - t0] = sm.newkv[0];
        kst[TS + pos - t0] = sm.newkv[1];
      }
      __syncthreads();
    }
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(kst + (with_err ? 3 : 2) * TS) + ((pos0 + t0) & 3);
    // ---- effective scales
    for (int t = tid; t < TS; t += THREADS) {
      const bool live = t < n && (p.valid == nullptr || vb[t] != 0);
      sm.kse[t] = live ? kst[t] : 0.f;
      sm.vse[t] = live ? kst[TS + t] : 0.f;
      sm.ese[t] = live && with_err ? kst[2 * TS + t] : 0.f;
    }
    __syncthreads();
    // ---- scores s[h, t] = (q_h . k_t) * ks_t * scale, masked
    for (int e = tid; e < G * TS; e += THREADS) {
      const int h = e / TS, t = e % TS;
      const float kscale = sm.kse[t];
      float sc = NEG;
      if (kscale > 0.f) {
        const int8_t* kr = kt + t * rstride;
        const float4* q4 = reinterpret_cast<const float4*>(sm.qs + h * hd);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int c = 0; c < chunks; ++c) {
          const int4 w = *reinterpret_cast<const int4*>(kr + c * 16);
          a0 = dot4(q4[4 * c], bytes_f32(w.x), a0);
          a1 = dot4(q4[4 * c + 1], bytes_f32(w.y), a1);
          a2 = dot4(q4[4 * c + 2], bytes_f32(w.z), a2);
          a3 = dot4(q4[4 * c + 3], bytes_f32(w.w), a3);
        }
        sc = ((a0 + a1) + (a2 + a3)) * kscale * p.scale;
      }
      sm.sc[e] = sc;
    }
    __syncthreads();
    // ---- online-softmax update, one warp a head
    for (int h = warp; h < G; h += n_warps) {
      float mx = NEG;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sm.sc[h * TS + t]);
      mx = warp_max(mx);
      const float m_old = sm.m[h];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f, pe = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float pr = expf(sm.sc[h * TS + t] - m_new);
        sm.sc[h * TS + t] = pr * sm.vse[t];  // the value pass's weight
        psum += pr;
        pe = fmaf(pr, sm.ese[t], pe);
      }
      psum = warp_sum(psum);
      pe = warp_sum(pe);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sm.corr[h] = c;
        sm.l[h] = sm.l[h] * c + psum;
        sm.m[h] = m_new;
        sm.eacc[h] = sm.eacc[h] * c + pe;
      }
    }
    __syncthreads();
    // ---- acc = acc * corr + sum_t p[h, t] * vs_t * v_t: a thread a (head,
    //      4 dims) and, where the units leave threads idle, a part of the
    //      positions; the parts' sums are added in part order
    for (int e = tid; e < units * parts; e += THREADS) {
      const int u = e % units, part = e / units;
      const int h = u / quads, d4 = u % quads;
      const float* ph = sm.sc + h * TS;
      float4 ev = make_float4(0.f, 0.f, 0.f, 0.f), od = ev;
      const int ta = part * (TS / parts), tb = ta + TS / parts;
      const int8_t* vd = vt + 4 * d4;
#pragma unroll 2
      for (int t = ta; t < tb; t += 4) {
        const float4 w = *reinterpret_cast<const float4*>(ph + t);  // p * vs
        const float4 v0 = bytes_f32(*reinterpret_cast<const int*>(vd + t * rstride));
        const float4 v1 = bytes_f32(*reinterpret_cast<const int*>(vd + (t + 1) * rstride));
        const float4 v2 = bytes_f32(*reinterpret_cast<const int*>(vd + (t + 2) * rstride));
        const float4 v3 = bytes_f32(*reinterpret_cast<const int*>(vd + (t + 3) * rstride));
        ev = make_float4(fmaf(w.x, v0.x, ev.x), fmaf(w.x, v0.y, ev.y), fmaf(w.x, v0.z, ev.z),
                         fmaf(w.x, v0.w, ev.w));
        od = make_float4(fmaf(w.y, v1.x, od.x), fmaf(w.y, v1.y, od.y), fmaf(w.y, v1.z, od.z),
                         fmaf(w.y, v1.w, od.w));
        ev = make_float4(fmaf(w.z, v2.x, ev.x), fmaf(w.z, v2.y, ev.y), fmaf(w.z, v2.z, ev.z),
                         fmaf(w.z, v2.w, ev.w));
        od = make_float4(fmaf(w.w, v3.x, od.x), fmaf(w.w, v3.y, od.y), fmaf(w.w, v3.z, od.z),
                         fmaf(w.w, v3.w, od.w));
      }
      const float4 sum = make_float4(ev.x + od.x, ev.y + od.y, ev.z + od.z, ev.w + od.w);
      if (parts == 1)
        update_acc(sm, h, d4, hd, sum);
      else
        sm.pv[e] = sum;
    }
    if (parts > 1) {
      __syncthreads();
      for (int u = tid; u < units; u += THREADS) {
        float4 sum = sm.pv[u];
        for (int part = 1; part < parts; ++part) {
          const float4 x = sm.pv[part * units + u];
          sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
        }
        update_acc(sm, u / quads, u % quads, hd, sum);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // m, l, acc and eacc of this split are final

  // ---- combine the splits of (b, g) in rank order: every other rank
  //      pushes its (acc, m, l, e) into rank 0's ring (free once every
  //      split is done) through distributed shared memory, rank 0 adds them
  if (p.splits > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    const int R = p.splits, rank = static_cast<int>(cluster.block_rank());
    const int box = GH + 4 * G;  // floats a rank's state takes in the ring
    cluster.sync();              // every split is done; rank 0's ring is free
    if (rank > 0) {
      float* dst = cluster.map_shared_rank(reinterpret_cast<float*>(sm.ring), 0) + rank * box;
      for (int i = tid; i < GH / 4; i += THREADS)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(sm.acc)[i];
      for (int h = tid; h < G; h += THREADS) {
        dst[GH + h] = sm.m[h];
        dst[GH + G + h] = sm.l[h];
        dst[GH + 2 * G + h] = sm.eacc[h];
      }
    }
    cluster.sync();  // the pushed states are in rank 0's ring
    if (rank > 0) return;
    const float* boxes = reinterpret_cast<const float*>(sm.ring);
    for (int h = tid; h < G; h += THREADS) {
      float M = sm.m[h];
      for (int r = 1; r < R; ++r) M = fmaxf(M, boxes[r * box + GH + h]);
      const float f0 = expf(sm.m[h] - M);
      sm.fac[h] = f0;
      float l = sm.l[h] * f0, ea = sm.eacc[h] * f0;
      for (int r = 1; r < R; ++r) {
        const float* st = boxes + r * box + GH;
        const float f = expf(st[h] - M);
        sm.fac[r * G + h] = f;
        l = fmaf(st[G + h], f, l);
        ea = fmaf(st[2 * G + h], f, ea);
      }
      sm.l[h] = l;
      sm.eacc[h] = ea;
    }
    __syncthreads();
    for (int e = tid; e < GH; e += THREADS) {
      const int h = e / hd;
      float a = sm.acc[e] * sm.fac[h];
      for (int r = 1; r < R; ++r) a = fmaf(boxes[r * box + e], sm.fac[r * G + h], a);
      sm.acc[e] = a;
    }
    __syncthreads();
  }

  // ---- out = (acc - e) / max(l, 1e-30) in the output type
  OT* out_bg = static_cast<OT*>(p.out) + (static_cast<size_t>(b) * p.Hq + g * G) * hd;
  float amax = 0.f;
  for (int e = tid; e < GH; e += THREADS) {
    const int h = e / hd;
    const float a = with_err ? sm.acc[e] - sm.eacc[h] : sm.acc[e];
    const OT o = from_f32<OT>(__fdiv_rn(a, fmaxf(sm.l[h], 1e-30f)));
    out_bg[e] = o;
    amax = fmaxf(amax, fabsf(to_f32(o)));
  }
  if (p.oq == nullptr) return;
  // ---- quantize-out of row b: the last of its Hkv heads to finish. The
  //      barrier in block_max orders every thread's outputs before thread
  //      0's release; the last finisher's acquire makes all of row b's
  //      outputs and its max visible (the arrive / wait of CUTLASS's
  //      GenericBarrier)
  amax = block_max_nonneg(amax, sm.red);
  if (tid == 0) {
    atomicMax(&p.scratch[b], __float_as_uint(amax));
    sm.red[0] = add_acq_rel(&p.scratch[p.B + b], 1u) == static_cast<unsigned>(Hkv - 1)
                    ? 1.f : 0.f;
  }
  __syncthreads();
  if (sm.red[0] == 0.f) return;
  const float oscale = absmax_scale(__uint_as_float(__ldcg(&p.scratch[b])));
  // the row from L2, 16 bytes a thread (Hq*hd is a multiple of 16), all
  // loads in flight before the first quantize
  constexpr int V = 16 / sizeof(OT);  // values a 16-byte load
  constexpr int UNROLL = 4;
  const int HD = p.Hq * hd, n16 = HD / V;
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const OT*>(p.out) +
                                                    static_cast<size_t>(b) * HD);
  int8_t* oq_b = p.oq + static_cast<size_t>(b) * HD;
  for (int i0 = tid; i0 < n16; i0 += UNROLL * THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < n16) raw[u] = __ldcg(src + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n16) break;
      const OT* v = reinterpret_cast<const OT*>(&raw[u]);
      alignas(8) int8_t q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) q[k] = quantize_one(to_f32(v[k]), oscale, -128.f);
      if constexpr (V == 8)
        *reinterpret_cast<int2*>(oq_b + i * V) = *reinterpret_cast<const int2*>(q);
      else
        *reinterpret_cast<int*>(oq_b + i * V) = *reinterpret_cast<const int*>(q);
    }
  }
  if (tid == 0) {
    p.os[b] = oscale;
    p.scratch[b] = 0u;
    p.scratch[p.B + b] = 0u;
  }
}

// Launch the decode kernel for `p` on its split grid (each (b, kv head)'s
// splits one cluster); returns the launch's CUDA error. Refuses a plan the
// kernel does not take (the wrappers refuse it first).
template <typename T, typename OT>
inline int launch(const Params& p, cudaStream_t st) {
  if (p.B == 0) return 0;
  const bool with_err = p.ve != nullptr;
  if (p.splits < 1 || p.splits > MAX_SPLITS || p.S < 1 || p.hd % 16 || p.Hq % p.Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p.Hq / p.Hkv, p.hd, with_err);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_once<decode_kernel<T, OT>>(
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
  if (e == cudaSuccess && p.splits > 8)
    e = set_once<decode_kernel<T, OT>>(cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.splits, p.Hkv, p.B);
  if (p.splits == 1) {
    decode_kernel<T, OT><<<grid, THREADS, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_kernel<T, OT>, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on q's type and the output's (float32 or bfloat16 each).
inline int launch_any(const Params& p, int q_bf16, int out_bf16, cudaStream_t st) {
  if (q_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, st)
                    : launch<__nv_bfloat16, float>(p, st);
  return out_bf16 ? launch<float, __nv_bfloat16>(p, st) : launch<float, float>(p, st);
}

}  // namespace

}  // namespace attn
}  // namespace repro
