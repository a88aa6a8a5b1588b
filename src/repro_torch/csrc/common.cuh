// Helpers shared by the port's kernels: dtype conversion, block reductions,
// and the one symmetric absmax quantizer every kernel applies.
//
// The quantizer must stay expression-identical to the plain PyTorch versions
// (and to the JAX package's ref.py files): scale = max(amax, 1e-8) / 127 by
// IEEE division, q = clip(rint(x / scale), lo, 127) by IEEE division and
// round-half-to-even. Never multiply by a reciprocal, never build with
// --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
