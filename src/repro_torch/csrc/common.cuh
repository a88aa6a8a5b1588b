// Helpers shared by the port's kernels: dtype conversion, block reductions,
// and the one symmetric absmax quantizer every kernel applies.
//
// The quantizer must stay expression-identical to the plain PyTorch versions
// (and to the JAX package's ref.py files): scale = max(amax, 1e-8) / 127 by
// IEEE division, q = clip(rint(x / scale), lo, 127) by IEEE division and
// round-half-to-even. Never multiply by a reciprocal in its place (quantize16
// multiplies only to find the elements where the division cannot change the
// integer, and divides the others), never build with --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace repro {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Max over the block of non-negative values (0 is the identity); `red` is
// __shared__ float[32]. Every thread of the block must call it.
__device__ __forceinline__ float block_max_nonneg(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < n_warps) ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// scale = max(amax, 1e-8) / qmax — 0 stays reserved as the "invalid"
// marker; qmax = 2^(bits-1) - 1, 127 for int8.
__device__ __forceinline__ float absmax_scale(float amax, float qmax = 127.0f) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), qmax);
}

// clip(round_half_even(x / scale), lo, hi): [-128, 127] for int8
// activations (quantize_act; [-qmax - 1, qmax] at fewer bits) and
// [-127, 127] for the KV cache (quantize_kv).
__device__ __forceinline__ int8_t quantize_one(float x, float scale, float lo,
                                               float hi = 127.0f) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, lo), hi)));
}

// 16 bytes of a row of T (bfloat16 or float32) from element k: one 16-byte
// load when `vec` (the row and k 16-byte aligned, the vector inside the
// row), else element by element, zero past K. The bits are T's.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int k, int K, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + k));
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  constexpr int EPV = 16 / sizeof(T);
  const Raw* r = reinterpret_cast<const Raw*>(row);
  union {
    uint4 v;
    Raw e[EPV];
  } u;
#pragma unroll
  for (int e = 0; e < EPV; ++e) u.e[e] = k + e < K ? r[k + e] : Raw(0);
  return u.v;
}

// Element e of a 16-byte vector of T as float32, exact.
template <typename T>
__device__ __forceinline__ float elem16(const uint4& v, int e) {
  const int i = sizeof(T) == 2 ? e >> 1 : e;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  if constexpr (sizeof(T) == 2)
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  else
    return __uint_as_float(w);
}

// The largest |x| of a 16-byte vector of T, folded into m.
template <typename T>
__device__ __forceinline__ float absmax16(const uint4& v, float m) {
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) m = fmaxf(m, fabsf(elem16<T>(v, e)));
  return m;
}

// The reciprocal a row's quantize16 calls take: __frcp_rn(scale), or 0
// where the IEEE division must decide every element (scale >= 2^125, whose
// reciprocal may be subnormal; an infinite or NaN scale).
__device__ __forceinline__ float quantize_rcp(float scale) {
  return scale < 0x1p125f ? __frcp_rn(scale) : 0.f;
}

// A 16-byte vector of T quantized exactly as quantize_one does, its int8
// values packed in element order: 8 bytes for bfloat16 (a uint2), 4 for
// float32 (.x). Without a division where it cannot matter: rcp =
// __frcp_rn(scale) is within 2^-24 of 1/scale (relative), so t = x * rcp is
// within 2^-23 (1 + 2^-24) |q| of the exact quotient q, and the IEEE quotient
// within 2^-24 |q|: at |q| <= 128 (every |x| <= amax) the two lie within
// 4.6e-5 of each other. Where every t of the vector lies more than 2^-13
// (1.2e-4) from each half-integer, t and the IEEE quotient fall between the
// same two half-integers and round to the same integer (t - rint(t) is
// exact); else the vector takes __fdiv_rn. Never a reciprocal alone. (A
// division for every element made the quantize-in GEMM 0.7-1.0 µs slower at
// each decode shape on an H100: chip_smoke.py's qmatmul_w8a8_qin lines.)
template <typename T>
__device__ __forceinline__ uint2 quantize16(const uint4& v, float scale, float rcp,
                                            float lo, float hi) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  float r[EPV];
  bool exact = rcp == 0.f;
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    const float t = __fmul_rn(elem16<T>(v, e), rcp);
    r[e] = rintf(t);
    exact |= fabsf(t - r[e]) > 0.5f - 0x1p-13f;
  }
  if (exact)
#pragma unroll
    for (int e = 0; e < EPV; ++e) r[e] = rintf(__fdiv_rn(elem16<T>(v, e), scale));
  uint32_t p[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < EPV; ++e)
    p[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(
                     static_cast<int>(fminf(fmaxf(r[e], lo), hi)))))
                 << (8 * (e & 3));
  return make_uint2(p[0], p[1]);
}

// Set a kernel's attribute once for each device (a driver call costs the
// host several microseconds, and the serving loop is bound by the host).
template <auto Kernel>
inline cudaError_t set_once(cudaFuncAttribute attr, int value) {
  static std::atomic<unsigned long long> done[2];  // [attr]: device bits, 0 at load
  const int slot = attr == cudaFuncAttributeMaxDynamicSharedMemorySize ? 0 : 1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  const unsigned long long bit = 1ull << (device & 63);
  if (e != cudaSuccess || (done[slot].load() & bit)) return e;
  e = cudaFuncSetAttribute(Kernel, attr, value);
  if (e == cudaSuccess) done[slot].fetch_or(bit);
  return e;
}

}  // namespace repro
