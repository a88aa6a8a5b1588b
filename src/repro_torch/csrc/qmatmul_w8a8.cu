// W8A8 GEMM: int8 x int8 -> int32 on the tensor cores, dequant epilogue.
//
// Replaces: qmatmul_w8a8_pallas (src/repro/kernels/qmatmul_w8a8/kernel.py:72).
// Computes: C[m,n] = ((acc[m,n] * sa[m]) * sw[n]) + bias[n] with
//           acc = sum_k A[m,k] * B[k,n] exact in int32.
// Operands: A [M, K] int8 row-major; the weight is passed as Bt [N, K] int8
// row-major, i.e. B [K, N] stored K-major — the layout the port's QTensor
// keeps (its public `q` is the [K, N] view of that storage), so mma.sync's
// "col" B fragment is contiguous bytes and no copy is made per call.
// Bound on the H100: at decode (M = num_slots <= 8) bytes — the weight is
// read once, K*N bytes (4.36 MB at K=896 N=4864: 1.3 us at 3.35 TB/s), and
// the int8 tensor-core work is ~2*M*K*N operations, about 16 operations a
// byte; a prefill chunk (M = 256) is still below the card's ~590 int8
// operations a byte, so every path shape is bound by bytes, and at these
// sizes by latency: the grid must fill the card and keep loads in flight.
// Design (gemm_mainloop.cuh): a CTA owns a 16 x 16 output tile at decode
// (M <= 16), walked by eight one-warp groups that each take a share of its
// K steps, a 64 x 32 tile walked by two groups of 2 x 2 warps (M <= 256) or
// a 128 x 64 tile of 4 x 2 warps; each group streams 64-byte steps through a cp.async ring of its own and runs
// two mma.sync.m16n8k32.s8 per fragment pair a step. The groups' int32
// partials are added in shared memory; K is split across the CTAs of a
// cluster where a CTA would walk more than 24 steps and the grid is small
// (the down projection; kernels/gemm_plan.py), rank 0 adding the splits' partials
// through distributed shared memory. Integer sums are exact, so the bits
// are the plain version's for any split. The epilogue's scales and bias are
// loaded before the mainloop, and column pairs are stored together.
// The epilogue uses __fmul_rn / __fadd_rn so it is never contracted into an
// FMA: for float32 output the result is bit-equal to the plain version.
//
// Quantize-out variant (replaces qmatmul_w8a8_q8_pallas,
// src/repro/kernels/qmatmul_w8a8/kernel.py:143): the same mainloop and the
// same y, then q8_epilogue.cuh in the same launch — the CTA that reduces a
// tile (rank 0 of its cluster) writes its float32 tile to a workspace and
// raises the rows' max with atomicMax, the last such CTA of each M tile
// (found by a counter after __threadfence()) quantizing the rows. Payload
// and scale are bit-equal to the float32 GEMM followed by quantize_act, and
// to the plain version.
#include "common.cuh"
#include "gemm_mainloop.cuh"
#include "q8_epilogue.cuh"

namespace {

using repro::gemm::BK;
using repro::gemm::ld16;
using repro::gemm::word;

// Unpadded 64-byte rows: the 16-byte fragment reads of 8 lanes (two rows,
// four quads) cover 128 contiguous bytes.
constexpr int LDS = BK;

__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BM>
using Ring = repro::gemm::Ring<BM, 1, LDS, LDS>;

// Q8: write q8 (the quantize-out epilogue) instead of C.
template <int BM, typename OutT, bool Q8>
__global__ void __launch_bounds__(repro::gemm::Tile<BM>::THREADS)
qmatmul_w8a8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                    const float* __restrict__ sa, const float* __restrict__ sw,
                    const float* __restrict__ bias, OutT* __restrict__ C,
                    repro::q8::Args q8, int M, int N, int K, int vec) {
  using W = repro::gemm::WarpTile<BM>;
  __shared__ unsigned smax[BM];
  const W w;
  constexpr int BN = repro::gemm::Tile<BM>::BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (Q8)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;
  // the epilogue's operands, loaded now so their latency hides under the
  // mainloop (0 past M or N)
  float row_s[W::MT][2], col_s[W::NT][2], col_b[W::NT][2];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + w.row(i, h);
      row_s[i][h] = r < M ? sa[r] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < W::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + w.col(j, e);
      col_s[j][e] = c < N ? sw[c] : 0.f;
      col_b[j][e] = c < N ? bias[c] : 0.f;
    }

  int acc[W::ACC];
#pragma unroll
  for (int i = 0; i < W::ACC; ++i) acc[i] = 0;

  Ring<BM>::run(A, Bt, M, N, K, m0, n0, vec != 0,
                [&](const char* as, const char* bs) {
    uint4 a[W::MT][2], b[W::NT];
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = ld16(as + w.row(i, h) * LDS + 16 * w.t);
#pragma unroll
    for (int j = 0; j < W::NT; ++j) b[j] = ld16(bs + w.b_row(j) * LDS + 16 * w.t);
    // k32 MMA s takes bytes [8s, 8s + 8) of each lane's 16: the first word
    // as the fragment's k 4t..4t+3, the second as 16+4t..16+4t+3
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int j = 0; j < W::NT; ++j)
          mma_s8(&acc[(i * W::NT + j) * 4], word(a[i][0], 2 * s),
                 word(a[i][1], 2 * s), word(a[i][0], 2 * s + 1),
                 word(a[i][1], 2 * s + 1), word(b[j], 2 * s),
                 word(b[j], 2 * s + 1));
  });

  const int role = repro::gemm::reduce<BM>(acc);
  if (role == 0) return;
  if (role == 2)
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int j = 0; j < W::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + w.row(i, h), col = n0 + w.col(j, 0);
          if (row >= M || col >= N) continue;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[e] = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(acc[(i * W::NT + j) * 4 + 2 * h + e]),
                                    row_s[i][h]),
                          col_s[j][e]),
                col_b[j][e]);
          if constexpr (Q8) {
            repro::q8::keep(q8, smax, row, m0, col, N, o[0]);
            if (col + 1 < N) repro::q8::keep(q8, smax, row, m0, col + 1, N, o[1]);
          } else {
            repro::gemm::store_pair(C, row, col, N, o[0], o[1]);
          }
        }
  if constexpr (Q8) repro::q8::finish_tile<BM>(q8, smax, m0, M, N);
}

template <int BM>
int launch_tiles(const void* a, const void* wt, const void* sa, const void* sw,
                 const void* bias, void* c, const repro::q8::Args& q8, int M,
                 int N, int K, int splits, int out_bf16, int vec,
                 cudaStream_t st) {
  constexpr int BN = repro::gemm::Tile<BM>::BN;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  const float* BI = static_cast<const float*>(bias);
  constexpr int smem = Ring<BM>::SMEM;
  using repro::gemm::launch;
  if (q8.q != nullptr)
    return launch<BM, qmatmul_w8a8_kernel<BM, float, true>>(
        smem, grid, st, A, Bt, SA, SW, BI, static_cast<float*>(nullptr), q8, M,
        N, K, vec);
  if (out_bf16)
    return launch<BM, qmatmul_w8a8_kernel<BM, __nv_bfloat16, false>>(
        smem, grid, st, A, Bt, SA, SW, BI, static_cast<__nv_bfloat16*>(c), q8,
        M, N, K, vec);
  return launch<BM, qmatmul_w8a8_kernel<BM, float, false>>(
      smem, grid, st, A, Bt, SA, SW, BI, static_cast<float*>(c), q8, M, N, K,
      vec);
}

int dispatch(const void* a, const void* wt, const void* sa, const void* sw,
             const void* bias, void* c, const repro::q8::Args& q8, int M,
             int N, int K, int bm, int splits, int out_bf16, int vec,
             void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16)
    return launch_tiles<16>(a, wt, sa, sw, bias, c, q8, M, N, K, splits,
                            out_bf16, vec, st);
  if (bm == 64)
    return launch_tiles<64>(a, wt, sa, sw, bias, c, q8, M, N, K, splits,
                            out_bf16, vec, st);
  if (bm == 128)
    return launch_tiles<128>(a, wt, sa, sw, bias, c, q8, M, N, K, splits,
                             out_bf16, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a [M, K] int8, wt [N, K] int8 (the K-major weight), sa [M], sw [N],
// bias [N] float32, c [M, N] float32 or bfloat16 — all contiguous. bm (16, 64
// or 128) and splits (1 ... 16, the K splits of a tile) come from
// kernels/gemm_plan.py. `vec` = 1 when K % 16 == 0 and both int8 bases are
// 16-byte aligned.
extern "C" int repro_qmatmul_w8a8(const void* a, const void* wt, const void* sa,
                                  const void* sw, const void* bias, void* c,
                                  int M, int N, int K, int bm, int splits,
                                  int out_bf16, int vec, void* stream) {
  return dispatch(a, wt, sa, sw, bias, c, repro::q8::Args{}, M, N, K, bm,
                  splits, out_bf16, vec, stream);
}

// The quantize-out variant: q [M, N] int8 and s [M] float32 out; y [M, N]
// float32 workspace; scratch [M + ceil(M / 16)] uint32, zero on entry and
// left zero (the rows' max, then one counter per M tile).
extern "C" int repro_qmatmul_w8a8_q8(const void* a, const void* wt,
                                     const void* sa, const void* sw,
                                     const void* bias, void* y, void* scratch,
                                     void* q, void* s, int M, int N, int K,
                                     int bm, int splits, int vec,
                                     void* stream) {
  unsigned* amax = static_cast<unsigned*>(scratch);
  const repro::q8::Args q8{static_cast<float*>(y), amax, amax + M,
                           static_cast<int8_t*>(q), static_cast<float*>(s)};
  return dispatch(a, wt, sa, sw, bias, nullptr, q8, M, N, K, bm, splits, 0,
                  vec, stream);
}
