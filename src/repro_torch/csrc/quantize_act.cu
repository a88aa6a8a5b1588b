// Per-row dynamic int8 quantization of an activation, one block per row.
//
// Replaces: quantize_act_pallas (src/repro/kernels/quantize_act/kernel.py:27).
// Computes: scale[m] = max(max_k |x[m,k]|, 1e-8) / qmax,
//           q[m,k]   = clip(rint(x[m,k] / scale[m]), -qmax - 1, qmax),
// qmax = 2^(bits-1) - 1 (127 at the serving path's 8 bits), int8 out.
// Bound on the H100: bytes. M*K*(2|4) bytes in, M*K + 4*M bytes out, about
// 2 operations a byte — far under the ~295 operations a byte at which the
// card stops being memory-bound. At the main path's widths (M = 8 decode
// rows, K = 896 or 4864) the transfer is a few tens of kB, so one launch
// costs its latency, not its bytes.
// Design: one block of 256 threads per row. The row is read twice (absmax
// pass, then quantize pass); the second read hits L1/L2. The output is
// bit-equal to the plain version: the max is order-independent and the
// division and rounding are IEEE (see common.cuh).
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s, int K, float qmax) {
  __shared__ float red[32];
  const T* row = x + static_cast<size_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(repro::to_f32(row[k])));
  amax = repro::block_max_nonneg(amax, red);
  const float scale = repro::absmax_scale(amax, qmax);
  int8_t* qrow = q + static_cast<size_t>(blockIdx.x) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    qrow[k] = repro::quantize_one(repro::to_f32(row[k]), scale, -qmax - 1.f, qmax);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
}

}  // namespace

// x [M, K] (float32 when is_bf16 == 0, bfloat16 otherwise), q [M, K] int8,
// s [M] float32, all contiguous; qmax = 2^(bits-1) - 1 for 1 <= bits <= 8.
// Returns cudaGetLastError().
extern "C" int repro_quantize_act(const void* x, void* q, void* s, int M,
                                  int K, int qmax, int is_bf16, void* stream) {
  if (M == 0) return 0;
  const float qm = static_cast<float>(qmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_act_kernel<__nv_bfloat16><<<M, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), K, qm);
  else
    quantize_act_kernel<float><<<M, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), K, qm);
  return static_cast<int>(cudaGetLastError());
}
