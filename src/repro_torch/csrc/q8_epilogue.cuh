// The quantize-out epilogue the two GEMMs share (qmatmul_w8a8.cu,
// qmatmul_w8a16.cu): the GEMM's own float32 result y, re-quantized per row
// by the quantize_act formula, in the GEMM's one launch.
//
// A row's scale needs the max |y| over the whole row, which no block holds:
// N = 4864 float32 of 16 rows is 311 KB, more than a block's 227 KB of
// shared memory. So the GEMM keeps its (M-tile, N-tile) grid and
//   1. every block writes its float32 tile of y to a workspace and raises
//      each row's running max with atomicMax on the float bits (|y| >= 0,
//      and non-negative floats order as unsigned integers);
//   2. a counter per M tile, raised after a __threadfence(), finds the last
//      block of that M tile to finish; that block reads the rows' max and
//      the tile's y from L2 and writes scale = max(amax, 1e-8) / 127 and
//      q = clip(rint(y / scale), -128, 127), both by IEEE division;
//   3. that block puts the rows' max and the counter back to 0, so the
//      scratch (`amax`, `count`) is zero between calls on one stream and no
//      call clears it.
// The other blocks never wait, so any grid size is safe. With K split
// across a cluster (gemm_mainloop.cuh), only its rank 0, which holds the
// tile's sum, calls keep() and finish_tile() (the splits that only publish
// exit first), so an M tile still counts gridDim.x arrivals, one per N tile. Bit-equal to the GEMM to float32 followed by
// quantize_act: the max is order-independent and every y is the GEMM's own.
#pragma once

#include "common.cuh"

namespace repro {
namespace q8 {

struct Args {
  float* y;         // [M, N] float32 workspace
  unsigned* amax;   // [M] running max |y| as float bits, 0 between calls
  unsigned* count;  // [gridDim.y] reduced tiles per M tile, 0 between calls
  int8_t* q;        // [M, N] int8 out
  float* s;         // [M] float32 scale out
};

// A block's share of step 1 for one value: store y, raise its row's max in
// the block's shared `smax` [BM] (zeroed before the mainloop).
__device__ __forceinline__ void keep(const Args& a, unsigned* smax, int row,
                                     int m0, int col, int N, float y) {
  a.y[static_cast<size_t>(row) * N + col] = y;
  atomicMax(&smax[row - m0], __float_as_uint(fabsf(y)));
}

// Steps 1-3 after every thread of the block has called keep() for its
// values. Every thread of the block must call it, and only the one block
// that reduces each (N tile, M tile).
template <int BM>
__device__ void finish_tile(const Args& a, const unsigned* smax, int m0, int M,
                            int N) {
  __shared__ int last;
  __shared__ float scale[BM];
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < BM && m0 + tid < M) atomicMax(&a.amax[m0 + tid], smax[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.count[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < BM && m0 + tid < M) {
    const float sc = absmax_scale(__uint_as_float(__ldcg(&a.amax[m0 + tid])));
    scale[tid] = sc;
    a.s[m0 + tid] = sc;
    a.amax[m0 + tid] = 0u;
  }
  if (tid == 0) a.count[blockIdx.y] = 0u;
  __syncthreads();
  const int rows = min(BM, M - m0);
  const size_t base = static_cast<size_t>(m0) * N;
  if (N % 4 == 0) {
    // UNROLL float4 loads in flight per thread: one block reads the tile's
    // rows alone, so the loop is bound by L2 latency, not bandwidth
    constexpr int UNROLL = 8;
    const int n4 = N / 4, total = rows * n4;
    const float4* y4 = reinterpret_cast<const float4*>(a.y + base);
    char4* q4 = reinterpret_cast<char4*>(a.q + base);
    for (int i0 = tid; i0 < total; i0 += UNROLL * blockDim.x) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) v[u] = __ldcg(y4 + i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const float sc = scale[i / n4];
          q4[i] = make_char4(quantize_one(v[u].x, sc, -128.f), quantize_one(v[u].y, sc, -128.f),
                             quantize_one(v[u].z, sc, -128.f), quantize_one(v[u].w, sc, -128.f));
        }
      }
    }
  } else {
    for (int i = tid; i < rows * N; i += blockDim.x)
      a.q[base + i] = quantize_one(__ldcg(a.y + base + i), scale[i / N], -128.f);
  }
}

}  // namespace q8
}  // namespace repro
