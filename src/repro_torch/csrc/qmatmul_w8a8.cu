// W8A8 GEMM: int8 x int8 -> int32 on the tensor cores, dequant epilogue.
//
// Replaces: qmatmul_w8a8_pallas (src/repro/kernels/qmatmul_w8a8/kernel.py:72).
// Computes: C[m,n] = ((acc[m,n] * sa[m]) * sw[n]) + bias[n] with
//           acc = sum_k A[m,k] * B[k,n] exact in int32.
// Operands: A [M, K] int8 row-major; the weight is passed as Bt [N, K] int8
// row-major, i.e. B [K, N] stored K-major — the layout the port's QTensor
// keeps (its public `q` is the [K, N] view of that storage), so mma.sync's
// "col" B fragment is four contiguous bytes and no copy is made per call.
// Bound on the H100: at decode (M = num_slots <= 8) bytes — the weight is
// read once, K*N bytes, and the int8 tensor-core work is ~2*M*K*N operations,
// about 16 operations a byte; a prefill chunk (M = 256) is still below the
// card's ~590 int8 operations a byte.
// Design (simple and right first): a block of 4 warps owns a BM x 64 output
// tile (BM = 16 when M <= 16, else 64); each warp owns 16 columns across all
// BM rows. K is walked in 64-byte steps through shared memory (rows padded
// by 16 bytes so the fragment reads are free of bank conflicts), each step
// issuing mma.sync.m16n8k32.s8 twice. Ragged M, N and K are masked with zero
// fill. No cp.async pipeline and no split-K yet: decode launches only N/64
// blocks, which leaves most SMs idle — work for a later PR.
// The epilogue uses __fmul_rn / __fadd_rn so it is never contracted into an
// FMA: for float32 output the result is bit-equal to the plain version.
//
// Quantize-out variant (replaces qmatmul_w8a8_q8_pallas,
// src/repro/kernels/qmatmul_w8a8/kernel.py:143): the same mainloop and the
// same y, then q8_epilogue.cuh in the same launch — the (M-tile, N-tile)
// grid kept, each block writing its float32 tile to a workspace and raising
// the rows' max with atomicMax, the last block of each M tile (found by a
// counter after __threadfence()) quantizing the rows. Chosen over one block
// per M tile walking every N tile, which would run one block at decode
// (M = 8). Payload and scale are bit-equal to the float32 GEMM followed by
// quantize_act, and to the plain version.
#include "common.cuh"
#include "q8_epilogue.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded shared row stride in bytes

__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

union Chunk16 {
  int4 v;
  int8_t b[16];
};

// Copy a ROWS x 64-byte tile of a row-major int8 matrix [rows_total, K]
// (rows from r0, bytes from k0) into shared memory, zero-filling past the
// matrix edge. `vec` says 16-byte loads are aligned (K % 16 == 0 and a
// 16-byte aligned base).
template <int ROWS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int r0, int rows_total, int k0,
                                          int K, bool vec) {
  for (int c = threadIdx.x; c < ROWS * (BK / 16); c += blockDim.x) {
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    const int gr = r0 + r, gk = k0 + kc;
    Chunk16 ch;
    ch.v = make_int4(0, 0, 0, 0);
    if (gr < rows_total) {
      const int8_t* p = src + static_cast<size_t>(gr) * K + gk;
      if (vec && gk + 16 <= K) {
        ch.v = *reinterpret_cast<const int4*>(p);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) ch.b[i] = (gk + i < K) ? p[i] : 0;
      }
    }
    *reinterpret_cast<int4*>(dst + r * LDS + kc) = ch.v;
  }
}

// Q8: write q8 (the quantize-out epilogue) instead of C.
template <int BM, typename OutT, bool Q8>
__global__ void __launch_bounds__(128)
qmatmul_w8a8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                    const float* __restrict__ sa, const float* __restrict__ sw,
                    const float* __restrict__ bias, OutT* __restrict__ C,
                    repro::q8::Args q8, int M, int N, int K, int vec) {
  constexpr int MT = BM / 16;
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ unsigned smax[BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (Q8)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;

  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM>(As, A, m0, M, k0, K, vec != 0);
    load_tile<BN>(Bs, Bt, n0, N, k0, K, vec != 0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* bp = Bs + (warp * 16 + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[j][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* ap = As + (i * 16 + g) * LDS + kk + t * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS + 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_s8(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + i * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + warp * 16 + j * 8 + t * 2 + (c & 1);
        if (row < M && col < N) {
          const float o = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][c]), sa[row]), sw[col]),
              bias[col]);
          if constexpr (Q8)
            repro::q8::keep(q8, smax, row, m0, col, N, o);
          else
            C[static_cast<size_t>(row) * N + col] = repro::from_f32<OutT>(o);
        }
      }
  if constexpr (Q8) repro::q8::finish_tile<BM>(q8, smax, m0, M, N);
}

template <int BM>
void launch(const void* a, const void* wt, const void* sa, const void* sw,
            const void* bias, void* c, const repro::q8::Args& q8, int M, int N,
            int K, int out_bf16, int vec, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  const float* BI = static_cast<const float*>(bias);
  if (q8.q != nullptr)
    qmatmul_w8a8_kernel<BM, float, true><<<grid, 128, 0, st>>>(
        A, Bt, SA, SW, BI, nullptr, q8, M, N, K, vec);
  else if (out_bf16)
    qmatmul_w8a8_kernel<BM, __nv_bfloat16, false><<<grid, 128, 0, st>>>(
        A, Bt, SA, SW, BI, static_cast<__nv_bfloat16*>(c), q8, M, N, K, vec);
  else
    qmatmul_w8a8_kernel<BM, float, false><<<grid, 128, 0, st>>>(
        A, Bt, SA, SW, BI, static_cast<float*>(c), q8, M, N, K, vec);
}

int dispatch(const void* a, const void* wt, const void* sa, const void* sw,
             const void* bias, void* c, const repro::q8::Args& q8, int M,
             int N, int K, int out_bf16, int vec, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<16>(a, wt, sa, sw, bias, c, q8, M, N, K, out_bf16, vec, st);
  else
    launch<64>(a, wt, sa, sw, bias, c, q8, M, N, K, out_bf16, vec, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M, K] int8, wt [N, K] int8 (the K-major weight), sa [M], sw [N],
// bias [N] float32, c [M, N] float32 or bfloat16 — all contiguous.
// `vec` = 1 when K % 16 == 0 and both int8 bases are 16-byte aligned.
extern "C" int repro_qmatmul_w8a8(const void* a, const void* wt, const void* sa,
                                  const void* sw, const void* bias, void* c,
                                  int M, int N, int K, int out_bf16, int vec,
                                  void* stream) {
  return dispatch(a, wt, sa, sw, bias, c, repro::q8::Args{}, M, N, K, out_bf16,
                  vec, stream);
}

// The quantize-out variant: q [M, N] int8 and s [M] float32 out; y [M, N]
// float32 workspace; scratch [M + ceil(M / 16)] uint32, zero on entry and
// left zero (the rows' max, then one counter per M tile).
extern "C" int repro_qmatmul_w8a8_q8(const void* a, const void* wt,
                                     const void* sa, const void* sw,
                                     const void* bias, void* y, void* scratch,
                                     void* q, void* s, int M, int N, int K,
                                     int vec, void* stream) {
  unsigned* amax = static_cast<unsigned*>(scratch);
  const repro::q8::Args q8{static_cast<float*>(y), amax, amax + M,
                           static_cast<int8_t*>(q), static_cast<float*>(s)};
  return dispatch(a, wt, sa, sw, bias, nullptr, q8, M, N, K, 0, vec, stream);
}
