// Per-row dynamic int8 quantization of an activation.
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
// Where it runs: the W8A8 GEMM quantizes its own activation wherever
// kernels/gemm_plan.py folds (every decode tile, M <= 16: the quantize-in
// variant of qmatmul_w8a8.cu), so a W8A8 decode step launches none of this
// kernel; it stays for the public op, for a prefill chunk's GEMMs (which do
// not fold) and for bits < 8.
// Design: each row is read once — 16-byte loads kept in registers — by at
// least four warps, eight where four would leave a lane more than two
// vectors (latency, not bytes, sets the time at these sizes, and a lane's
// serial work is most of it): a CTA of eight warps holds two rows at
// K = 896 and one at K = 4864, so a prefill chunk of 256 rows runs on 128
// or 256 CTAs. The row's max is taken by warp
// shuffles and one shared-memory step across its warps; the row is then
// quantized from the registers (a row of more than 24 vectors a lane
// re-reads from L1). The division is skipped where it cannot change the
// integer (common.cuh quantize16: a reciprocal multiply as a filter, the
// IEEE division within 2^-13 of a rounding boundary).
// Bit-equal to the plain version at every bits: the max is
// order-independent and the integer is the IEEE division's, rounded half
// to even.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // a CTA's warps

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * WARPS)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s, int M, int K, int wpr, float qmax,
                    int vec) {
  constexpr int EPV = 16 / sizeof(T);  // elements a vector
  __shared__ float red[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (WARPS / wpr) + warp / wpr;
  const int part = warp % wpr, stride = 32 * wpr;
  const int nv = (K + EPV - 1) / EPV, v0 = part * 32 + lane;
  const bool live = r < M, held = nv <= stride * VPL;
  const T* row = x + static_cast<size_t>(r) * K;
  uint4 reg[VPL];
  float amax = 0.f;
  if (live) {
    if (held) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = v0 + j * stride;
        if (v < nv) {
          reg[j] = repro::load16(row, v * EPV, K, vec != 0);
          amax = repro::absmax16<T>(reg[j], amax);
        }
      }
    } else {
      for (int v = v0; v < nv; v += stride)
        amax = repro::absmax16<T>(repro::load16(row, v * EPV, K, vec != 0), amax);
    }
  }
  amax = repro::warp_max(amax);
  if (wpr > 1) {  // the row's warps: one shared-memory step
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    amax = red[warp - part];
    for (int i = 1; i < wpr; ++i) amax = fmaxf(amax, red[warp - part + i]);
  }
  if (!live) return;
  const float scale = repro::absmax_scale(amax, qmax);
  const float rcp = repro::quantize_rcp(scale);
  int8_t* qrow = q + static_cast<size_t>(r) * K;
  const auto put = [&](int v, const uint4& u) {
    const uint2 p = repro::quantize16<T>(u, scale, rcp, -qmax - 1.f, qmax);
    const int k = v * EPV;
    if (vec) {
      if constexpr (EPV == 8)
        *reinterpret_cast<uint2*>(qrow + k) = p;
      else
        *reinterpret_cast<uint32_t*>(qrow + k) = p.x;
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        if (k + e < K) qrow[k + e] = static_cast<int8_t>((e < 4 ? p.x : p.y) >> (8 * (e & 3)));
    }
  };
  if (held) {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (v0 + j * stride < nv) put(v0 + j * stride, reg[j]);
  } else {
    for (int v = v0; v < nv; v += stride) put(v, repro::load16(row, v * EPV, K, vec != 0));
  }
  if (part == 0 && lane == 0) s[r] = scale;
}

template <typename T>
int launch(const void* x, void* q, void* s, int M, int K, float qmax, int vec,
           cudaStream_t st) {
  constexpr int EPV = 16 / sizeof(T);
  const int nv = (K + EPV - 1) / EPV;
  // at least four warps a row, and more (up to the CTA's eight) until a
  // lane holds at most two vectors: latency, not bytes, sets the time at
  // these sizes, and a lane's serial work is most of it; then the smallest
  // register array that holds a lane's vectors
  int wpr = 4;
  while (wpr < WARPS && nv > 32 * wpr * 2) wpr *= 2;
  const int per = (nv + 32 * wpr - 1) / (32 * wpr);
  const dim3 grid((M + WARPS / wpr - 1) / (WARPS / wpr));
  const T* X = static_cast<const T*>(x);
  int8_t* Q = static_cast<int8_t*>(q);
  float* S = static_cast<float*>(s);
  if (per <= 2)
    quantize_act_kernel<T, 2><<<grid, 32 * WARPS, 0, st>>>(X, Q, S, M, K, wpr, qmax, vec);
  else if (per <= 4)
    quantize_act_kernel<T, 4><<<grid, 32 * WARPS, 0, st>>>(X, Q, S, M, K, wpr, qmax, vec);
  else if (per <= 8)
    quantize_act_kernel<T, 8><<<grid, 32 * WARPS, 0, st>>>(X, Q, S, M, K, wpr, qmax, vec);
  else
    quantize_act_kernel<T, 24><<<grid, 32 * WARPS, 0, st>>>(X, Q, S, M, K, wpr, qmax, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] (float32 when is_bf16 == 0, bfloat16 otherwise), q [M, K] int8,
// s [M] float32, all contiguous; qmax = 2^(bits-1) - 1 for 1 <= bits <= 8.
// `vec` = 1 when every row of x and of q may be read and written in 16-byte
// and 8- / 4-byte pieces (K * sizeof(x) % 16 == 0, both bases 16-byte
// aligned). Returns cudaGetLastError().
extern "C" int repro_quantize_act(const void* x, void* q, void* s, int M,
                                  int K, int qmax, int is_bf16, int vec,
                                  void* stream) {
  if (M == 0) return 0;
  const float qm = static_cast<float>(qmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, q, s, M, K, qm, vec, st);
  return launch<float>(x, q, s, M, K, qm, vec, st);
}
