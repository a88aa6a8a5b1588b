// W8A16 GEMM: bf16 / f32 activations x int8 weights, float32 accumulation.
//
// Replaces: qmatmul_w8a16_pallas (src/repro/kernels/qmatmul_w8a16/kernel.py:64).
// Computes: C[m,n] = (sum_k A[m,k] * float(W[k,n])) * sw[n] + bias[n], the
//           weight cast to A's type on the chip, the sum in float32, scale
//           and bias applied once after the K loop, the result in A's type.
// Operands: A [M, K] bf16 or f32 row-major; the weight is passed as
// Bt [N, K] int8 row-major, i.e. W [K, N] stored K-major — the layout the
// port's QTensor keeps, so a B fragment is contiguous bytes and no weight is
// copied per call. The scale is a pointer plus a stride (0: per-tensor [1],
// 1: per-channel [N]); the bias a nullable pointer; each float32 or bf16.
// Bound on the H100: at decode (M = 8) bytes — the int8 weight is read
// once (K*N bytes, 4.36 MB at K=896 N=4864: 1.3 us at 3.35 TB/s) against
// 2*M*K*N flops, ~16 per byte. A prefill chunk (M = 256) moves ~7.3 MB and
// does 2.2 GFLOP: ~2.2 us either way at 989 bf16 TFLOP/s.
// Design (simple and right first), as csrc/qmatmul_w8a8.cu:
//  * bf16: a block of 4 warps owns a BM x 64 output tile (BM = 16 when
//    M <= 16, else 64); each warp owns 16 columns across all BM rows. K is
//    walked in 64-element steps through shared memory (rows padded so the
//    fragment reads are free of bank conflicts). Each int8 pair of a B
//    fragment is converted to bf16x2 in registers (exact for int8) and fed
//    to mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.
//  * f32: the same tiles on the CUDA cores — each thread owns one column
//    and BM/2 rows and accumulates with fmaf over K steps of 32; the weight
//    tile is converted to float once, when it is stored to shared memory.
//    Never TF32.
//  * Ragged M, N and K are zero-filled in the loaders.
//  * The epilogue uses __fmul_rn / __fadd_rn, never contracted into an FMA.
// No cp.async pipeline, no wgmma, no TMA and no split-K yet: decode launches
// only N/64 blocks, which leaves most SMs idle — work for a later PR.
//
// Quantize-out variant (replaces qmatmul_w8a16_q8_pallas,
// src/repro/kernels/qmatmul_w8a16/kernel.py:127): the same mainloops and
// the same float32 y = acc * sw + bias (never rounded to a's type), then
// q8_epilogue.cuh in the same launch — the (M-tile, N-tile) grid kept, each
// block writing its float32 tile to a workspace and raising the rows' max
// with atomicMax, the last block of each M tile (found by a counter after
// __threadfence()) quantizing the rows. Chosen over one block per M tile
// walking every N tile, which would run one block at decode (M = 8). For
// float32 a, bit-equal to this GEMM to float32 followed by quantize_act.
#include "common.cuh"
#include "q8_epilogue.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 64;            // bf16 path: K elements per step
constexpr int LDA = BK + 8;       // padded bf16 elements per shared A row
constexpr int LDB = BK + 16;      // padded bytes per shared B row
constexpr int FBK = 32;           // f32 path: K elements per step
constexpr int LDF = BN + 1;       // padded floats per shared f32 B row

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two consecutive int8 weights (k, k+1 of one column) as a bf16x2 register,
// the lower k in the lower half — exact, an int8 fits bf16's mantissa.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(const int8_t* p) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(p);
  __nv_bfloat162 v = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(u & 0xff)),
      static_cast<float>(static_cast<int8_t>(u >> 8)));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_f32(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

struct Epilogue {
  const void* sw;    // scale, float32 or bf16
  int ss;            // scale stride: 0 per-tensor, 1 per-channel
  int sw_bf16;
  const void* bias;  // nullable
  int bias_bf16;

  __device__ __forceinline__ float operator()(float acc, int col) const {
    float o = __fmul_rn(acc, load_f32(sw, col * ss, sw_bf16));
    if (bias != nullptr) o = __fadd_rn(o, load_f32(bias, col, bias_bf16));
    return o;
  }
};

union Chunk16 {
  int4 v;
  int8_t b[16];
  uint16_t h[8];
  float f[4];
};

// ROWS x BK bytes of the K-major int8 weight Bt [N, K] (rows from r0,
// bytes from k0) into shared memory, zero-filled past the edge.
template <int ROWS>
__device__ __forceinline__ void load_b_int8(int8_t* dst, const int8_t* src,
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
    *reinterpret_cast<int4*>(dst + r * LDB + kc) = ch.v;
  }
}

// ROWS x BK bf16 of A [M, K] into shared memory, 8 elements per chunk.
template <int ROWS>
__device__ __forceinline__ void load_a_bf16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int r0,
                                            int M, int k0, int K, bool vec) {
  for (int c = threadIdx.x; c < ROWS * (BK / 8); c += blockDim.x) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int gr = r0 + r, gk = k0 + kc;
    Chunk16 ch;
    ch.v = make_int4(0, 0, 0, 0);
    if (gr < M) {
      const __nv_bfloat16* p = src + static_cast<size_t>(gr) * K + gk;
      if (vec && gk + 8 <= K) {
        ch.v = *reinterpret_cast<const int4*>(p);
      } else {
        const uint16_t* ph = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
        for (int i = 0; i < 8; ++i) ch.h[i] = (gk + i < K) ? ph[i] : 0;
      }
    }
    *reinterpret_cast<int4*>(dst + r * LDA + kc) = ch.v;
  }
}

// Q8 (both kernels): write q8 (the quantize-out epilogue) instead of C.
template <int BM, bool Q8>
__global__ void __launch_bounds__(128)
w8a16_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                  const int8_t* __restrict__ Bt, Epilogue ep,
                  __nv_bfloat16* __restrict__ C, repro::q8::Args q8, int M,
                  int N, int K, int vec) {
  constexpr int MT = BM / 16;
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(16) int8_t Bs[BN * LDB];
  __shared__ unsigned smax[BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (Q8)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_bf16<BM>(As, A, m0, M, k0, K, vec != 0);
    load_b_int8<BN>(Bs, Bt, n0, N, k0, K, vec != 0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* bp = Bs + (warp * 16 + j * 8 + g) * LDB + kk + t * 2;
        b[j][0] = int8x2_to_bf16x2(bp);
        b[j][1] = int8x2_to_bf16x2(bp + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* ap = As + (i * 16 + g) * LDA + kk + t * 2;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_bf16(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
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
          if constexpr (Q8)
            repro::q8::keep(q8, smax, row, m0, col, N, ep(acc[i][j][c], col));
          else
            C[static_cast<size_t>(row) * N + col] =
                __float2bfloat16_rn(ep(acc[i][j][c], col));
        }
      }
  if constexpr (Q8) repro::q8::finish_tile<BM>(q8, smax, m0, M, N);
}

template <int BM, bool Q8>
__global__ void __launch_bounds__(128)
w8a16_f32_kernel(const float* __restrict__ A, const int8_t* __restrict__ Bt,
                 Epilogue ep, float* __restrict__ C, repro::q8::Args q8, int M,
                 int N, int K, int vec) {
  constexpr int RPT = BM / 2;     // rows per thread: rg, rg + 2, ...
  __shared__ __align__(16) float As[BM * FBK];
  __shared__ float Bs[FBK * LDF];  // [k][n], the weight as float
  __shared__ unsigned smax[BM];
  const int col_l = threadIdx.x & 63, rg = threadIdx.x >> 6;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (Q8)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int c = threadIdx.x; c < BM * (FBK / 4); c += blockDim.x) {
      const int r = c / (FBK / 4), kc = (c % (FBK / 4)) * 4;
      const int gr = m0 + r, gk = k0 + kc;
      Chunk16 ch;
      ch.v = make_int4(0, 0, 0, 0);
      if (gr < M) {
        const float* p = A + static_cast<size_t>(gr) * K + gk;
        if (vec && gk + 4 <= K) {
          ch.v = *reinterpret_cast<const int4*>(p);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) ch.f[i] = (gk + i < K) ? p[i] : 0.f;
        }
      }
      *reinterpret_cast<int4*>(As + r * FBK + kc) = ch.v;
    }
    for (int c = threadIdx.x; c < BN * (FBK / 16); c += blockDim.x) {
      const int n = c / (FBK / 16), kc = (c % (FBK / 16)) * 16;
      const int gn = n0 + n, gk = k0 + kc;
      Chunk16 ch;
      ch.v = make_int4(0, 0, 0, 0);
      if (gn < N) {
        const int8_t* p = Bt + static_cast<size_t>(gn) * K + gk;
        if (vec && gk + 16 <= K) {
          ch.v = *reinterpret_cast<const int4*>(p);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) ch.b[i] = (gk + i < K) ? p[i] : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        Bs[(kc + i) * LDF + n] = static_cast<float>(ch.b[i]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FBK; ++kk) {
      const float b = Bs[kk * LDF + col_l];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(As[(rg + 2 * i) * FBK + kk], b, acc[i]);
    }
    __syncthreads();
  }

  const int col = n0 + col_l;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = m0 + rg + 2 * i;
      if (row >= M) continue;
      if constexpr (Q8)
        repro::q8::keep(q8, smax, row, m0, col, N, ep(acc[i], col));
      else
        C[static_cast<size_t>(row) * N + col] = ep(acc[i], col);
    }
  }
  if constexpr (Q8) repro::q8::finish_tile<BM>(q8, smax, m0, M, N);
}

template <int BM>
void launch(const void* a, const void* wt, Epilogue ep, void* c,
            const repro::q8::Args& q8, int M, int N, int K, int a_bf16,
            int vec, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const bool q_out = q8.q != nullptr;
  if (a_bf16) {
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
    if (q_out)
      w8a16_bf16_kernel<BM, true><<<grid, 128, 0, st>>>(A, Bt, ep, C, q8, M, N, K, vec);
    else
      w8a16_bf16_kernel<BM, false><<<grid, 128, 0, st>>>(A, Bt, ep, C, q8, M, N, K, vec);
  } else {
    const float* A = static_cast<const float*>(a);
    float* C = static_cast<float*>(c);
    if (q_out)
      w8a16_f32_kernel<BM, true><<<grid, 128, 0, st>>>(A, Bt, ep, C, q8, M, N, K, vec);
    else
      w8a16_f32_kernel<BM, false><<<grid, 128, 0, st>>>(A, Bt, ep, C, q8, M, N, K, vec);
  }
}

int dispatch(const void* a, const void* wt, Epilogue ep, void* c,
             const repro::q8::Args& q8, int M, int N, int K, int a_bf16,
             int vec, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<16>(a, wt, ep, c, q8, M, N, K, a_bf16, vec, st);
  else
    launch<64>(a, wt, ep, c, q8, M, N, K, a_bf16, vec, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M, K] bf16 (a_bf16 = 1) or float32; wt [N, K] int8 (the K-major
// weight); sw float32 or bf16 (sw_bf16) read at col * sw_stride; bias [N]
// float32 or bf16 (bias_bf16) or NULL; c [M, N] in a's type — all
// contiguous. `vec` = 1 when K % 16 == 0 and a and wt are 16-byte aligned.
extern "C" int repro_qmatmul_w8a16(const void* a, const void* wt,
                                   const void* sw, int sw_stride, int sw_bf16,
                                   const void* bias, int bias_bf16, void* c,
                                   int M, int N, int K, int a_bf16, int vec,
                                   void* stream) {
  const Epilogue ep{sw, sw_stride, sw_bf16, bias, bias_bf16};
  return dispatch(a, wt, ep, c, repro::q8::Args{}, M, N, K, a_bf16, vec,
                  stream);
}

// The quantize-out variant: operands as above; q [M, N] int8 and s [M]
// float32 out; y [M, N] float32 workspace; scratch [M + ceil(M / 16)]
// uint32, zero on entry and left zero (the rows' max, then one counter per
// M tile).
extern "C" int repro_qmatmul_w8a16_q8(const void* a, const void* wt,
                                      const void* sw, int sw_stride,
                                      int sw_bf16, const void* bias,
                                      int bias_bf16, void* y, void* scratch,
                                      void* q, void* s, int M, int N, int K,
                                      int a_bf16, int vec, void* stream) {
  const Epilogue ep{sw, sw_stride, sw_bf16, bias, bias_bf16};
  unsigned* amax = static_cast<unsigned*>(scratch);
  const repro::q8::Args q8{static_cast<float*>(y), amax, amax + M,
                           static_cast<int8_t*>(q), static_cast<float*>(s)};
  return dispatch(a, wt, ep, nullptr, q8, M, N, K, a_bf16, vec, stream);
}
