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
// does 2.2 GFLOP: ~2.2 us either way at 989 bf16 TFLOP/s. At these sizes the
// time is latency: the grid must fill the card and keep loads in flight.
// Design (gemm_mainloop.cuh, as csrc/qmatmul_w8a8.cu): a CTA owns a 16 x 16
// output tile at decode (M <= 16), walked by eight one-warp groups that
// each take a share of its K steps, a 64 x 32 tile walked by two groups of
// 2 x 2 warps (M <= 256) or a 128 x 64 tile of 4 x 2 warps; each group
// streams 64-element steps through a cp.async ring of its own. K is split
// across the CTAs of a cluster where a CTA would walk more than 24 steps and
// the grid is small (kernels/gemm_plan.py).
//  * bf16: each lane reads 16 weight bytes of its column per step, turns
//    each int8 pair into bf16x2 in registers (exact, two PRMT and two FADD)
//    and feeds mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, four per step.
//  * f32: the same rings on the CUDA cores — each thread of a group owns one
//    column and every (group size / BN)-th row and accumulates with fmaf,
//    k ascending; the weight is converted to float in registers. Never TF32.
//  * The groups' float32 partials are added in shared memory in group
//    order, and rank 0 of a split tile's cluster adds the splits' through
//    distributed shared memory in the order 0 ... S-1, so the bits do not
//    depend on which finished first; it alone runs the epilogue, whose scale
//    and bias were loaded before the mainloop.
//  * The epilogue uses __fmul_rn / __fadd_rn, never contracted into an FMA.
//
// Expert-batched (the MoE block's projections, which the reference runs as
// jax.vmap of linear() over the expert axis: one pallas_call with the
// expert index in its grid): E experts' operands back to back in one
// launch, E x m_tiles M tiles on the grid's y axis (gemm_mainloop.cuh
// expert_tile), each CTA offsetting A, the weight, the scales, the bias and
// C to its expert's; the clusters span x and z only, so a tile's K splits
// (and the quantize-in cluster) are one expert's. gemm_plan.plan(...,
// experts=E) counts the E experts' tiles against MAX_CTAS. The
// quantize-out variant takes one expert.
//
// Quantize-out variant (replaces qmatmul_w8a16_q8_pallas,
// src/repro/kernels/qmatmul_w8a16/kernel.py:127): the same mainloops and
// the same float32 y = acc * sw + bias (never rounded to a's type), then
// q8_epilogue.cuh in the same launch, at any bits from 1 to 8: on the
// RESIDENT route the CTA that reduces a tile quantizes its own y from
// registers once its M tile's rows' max is known; on the WORKSPACE route y
// goes to a float32 workspace and the last CTAs of each M tile to finish
// divide its rows. Always at the plain GEMM's tile and splits, so for
// float32 a bit-equal to this GEMM to float32 followed by quantize_act.
#include "common.cuh"
#include "gemm_mainloop.cuh"
#include "q8_epilogue.cuh"

namespace {

using repro::gemm::BK;
using repro::gemm::int8_to_f32;
using repro::gemm::ld16;
using repro::gemm::word;

// bf16 A rows (128 bytes a step) padded by 16 bytes: the two 16-byte
// fragment reads of 8 lanes (two rows, four quads) then hit distinct banks.
constexpr int LDA_BF16 = BK * 2 + 16;
// float32 A rows: every lane of a warp reads the same row (a broadcast).
constexpr int LDA_F32 = BK * 4;
// int8 weight rows: unpadded for the MMA path (8 lanes read 128 contiguous
// bytes); padded by 16 for the f32 path, where 8 lanes read 16 bytes of 8
// consecutive rows.
constexpr int LDB = BK;
constexpr int LDB_F32 = BK + 16;

template <int BM>
using RingBf16 = repro::gemm::Ring<BM, 2, LDA_BF16, LDB>;
template <int BM>
using RingF32 = repro::gemm::Ring<BM, 4, LDA_F32, LDB_F32>;

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes i and i + 1 of w (consecutive k of one column) as a bf16x2
// register, byte i in the lower half. Exact: an int8 fits bf16's mantissa,
// so the float32 values' low halves are zero and the pair is their high
// halves, packed by one PRMT (no conversion-unit instruction).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int i) {
  return __byte_perm(__float_as_uint(int8_to_f32(w, i)),
                     __float_as_uint(int8_to_f32(w, i + 1)), 0x7632);
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

  // column col's scale and bias as float32 (0 past N), loaded before the
  // mainloop so their latency hides under it
  __device__ __forceinline__ void load(int col, int N, float& s, float& b) const {
    s = col < N ? load_f32(sw, col * ss, sw_bf16) : 0.f;
    b = col < N && bias != nullptr ? load_f32(bias, col, bias_bf16) : 0.f;
  }
  __device__ __forceinline__ float operator()(float acc, float s, float b) const {
    const float o = __fmul_rn(acc, s);
    return bias != nullptr ? __fadd_rn(o, b) : o;
  }
  // expert e's scale ([E, N], or [E, 1] per-tensor) and bias ([E, N])
  __device__ __forceinline__ void to_expert(size_t e, int N) {
    const size_t width = (sw_bf16 ? 2 : 4), bwidth = (bias_bf16 ? 2 : 4);
    sw = static_cast<const char*>(sw) + e * (ss ? N : 1) * width;
    if (bias != nullptr) bias = static_cast<const char*>(bias) + e * N * bwidth;
  }
};

// ROUTE (both kernels; q8_epilogue.cuh): NONE writes C; RESIDENT and
// WORKSPACE write the quantize-out epilogue's int8 and scales instead.
template <int BM, int ROUTE>
__global__ void __launch_bounds__(repro::gemm::Tile<BM>::THREADS)
w8a16_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                  const int8_t* __restrict__ Bt, Epilogue ep,
                  __nv_bfloat16* __restrict__ C, repro::q8::Args q8, int M,
                  int N, int K, int vec) {
  namespace q8r = repro::q8;
  using W = repro::gemm::WarpTile<BM>;
  __shared__ unsigned smax[BM];
  const W w;
  constexpr int BN = repro::gemm::Tile<BM>::BN;
  int mt, nt = blockIdx.x;
  // this CTA's expert's operands (expert 0 on the quantize-out routes)
  const size_t e = repro::gemm::expert_tile<BM>(M, mt);
  A += e * M * K;
  Bt += e * N * K;
  ep.to_expert(e, N);
  if constexpr (ROUTE == q8r::NONE) C += e * M * N;
  if constexpr (ROUTE != q8r::NONE) q8r::take_tile(q8, gridDim.x, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  if constexpr (ROUTE != q8r::NONE)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;
  float col_s[W::NT][2], col_b[W::NT][2];
#pragma unroll
  for (int j = 0; j < W::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) ep.load(n0 + w.col(j, e), N, col_s[j][e], col_b[j][e]);

  float acc[W::ACC];
#pragma unroll
  for (int i = 0; i < W::ACC; ++i) acc[i] = 0.f;

  RingBf16<BM>::run(A, Bt, M, N, K, m0, n0, vec != 0,
                    [&](const char* as, const char* bs) {
    // lane t of a quad holds k [16t, 16t + 16) of its rows: 32 bytes of A
    // (two uint4, rows g and g + 8) and 16 weight bytes of column g
    uint4 a[W::MT][2][2], b[W::NT];
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const char* p = as + w.row(i, h) * LDA_BF16 + 32 * w.t;
        a[i][h][0] = ld16(p);
        a[i][h][1] = ld16(p + 16);
      }
#pragma unroll
    for (int j = 0; j < W::NT; ++j) b[j] = ld16(bs + w.b_row(j) * LDB + 16 * w.t);
    // k16 MMA s takes k [4s, 4s + 4) of the lane's 16: the first pair as
    // the fragment's k 2t, 2t+1, the second as 2t+8, 2t+9
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t b0[W::NT], b1[W::NT];
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        b0[j] = int8x2_to_bf16x2(word(b[j], s), 0);
        b1[j] = int8x2_to_bf16x2(word(b[j], s), 2);
      }
      const int half = s >> 1, w0 = 2 * (s & 1);
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int j = 0; j < W::NT; ++j)
          mma_bf16(&acc[(i * W::NT + j) * 4], word(a[i][0][half], w0),
                   word(a[i][1][half], w0), word(a[i][0][half], w0 + 1),
                   word(a[i][1][half], w0 + 1), b0[j], b1[j]);
    }
  });

  const int role = repro::gemm::reduce<BM>(acc);
  if (role == 0) return;
  // y, kept in registers (meaningful in the threads of role 2)
  float o[W::MT][2][W::NT][2];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < W::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[i][h][j][e] = ep(acc[(i * W::NT + j) * 4 + 2 * h + e], col_s[j][e], col_b[j][e]);
  if (role == 2)
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + w.row(i, h);
        unsigned m = 0u;  // the row's max |y| as bits (a NaN wins, as in amax)
#pragma unroll
        for (int j = 0; j < W::NT; ++j) {
          const int col = n0 + w.col(j, 0);
          if (row >= M || col >= N) continue;
          if constexpr (ROUTE == q8r::NONE) {
            repro::gemm::store_pair(C, row, col, N, o[i][h][j][0], o[i][h][j][1]);
          } else {
            if constexpr (ROUTE == q8r::WORKSPACE)
              repro::gemm::store_pair(q8.y, row, col, N, o[i][h][j][0], o[i][h][j][1]);
            m = max(m, __float_as_uint(fabsf(o[i][h][j][0])));
            if (col + 1 < N) m = max(m, __float_as_uint(fabsf(o[i][h][j][1])));
          }
        }
        if constexpr (ROUTE != q8r::NONE) {
          // the quad's four lanes hold the row's columns: one atomic a row
          m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (w.t == 0 && row < M) atomicMax(&smax[w.row(i, h)], m);
        }
      }
  if constexpr (ROUTE == q8r::WORKSPACE) q8r::workspace_finish<BM>(q8, smax, mt, M, N);
  if constexpr (ROUTE == q8r::RESIDENT) {
    const unsigned order = q8r::arrive<BM>(q8, smax, mt, M);
    const float* scale = q8r::scales<BM>(q8, mt, M, order, nt == 0);
    if (role == 2)
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + w.row(i, h);
          if (row >= M) continue;
#pragma unroll
          for (int j = 0; j < W::NT; ++j) {
            const int col = n0 + w.col(j, 0);
            if (col < N)
              q8r::store_q_pair(q8, row, col, N, o[i][h][j][0], o[i][h][j][1],
                                scale[w.row(i, h)]);
          }
        }
    q8r::depart(q8, M);
  }
}

template <int BM, int ROUTE>
__global__ void __launch_bounds__(repro::gemm::Tile<BM>::THREADS)
w8a16_f32_kernel(const float* __restrict__ A, const int8_t* __restrict__ Bt,
                 Epilogue ep, float* __restrict__ C, repro::q8::Args q8, int M,
                 int N, int K, int vec) {
  namespace q8r = repro::q8;
  // in each group, thread (rg, col_l) owns column col_l and rows rg,
  // rg + RG, ...; each warp holds one rg, so its A reads are broadcasts
  constexpr int BN = repro::gemm::Tile<BM>::BN;
  constexpr int RG = repro::gemm::Tile<BM>::GROUP_THREADS / BN;
  constexpr int RPT = BM / RG;
  __shared__ unsigned smax[BM];
  const int tid = threadIdx.x % repro::gemm::Tile<BM>::GROUP_THREADS;
  const int col_l = tid % BN, rg = tid / BN;
  int mt, nt = blockIdx.x;
  const size_t e = repro::gemm::expert_tile<BM>(M, mt);
  A += e * M * K;
  Bt += e * N * K;
  ep.to_expert(e, N);
  if constexpr (ROUTE == q8r::NONE) C += e * M * N;
  if constexpr (ROUTE != q8r::NONE) q8r::take_tile(q8, gridDim.x, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN, col = n0 + col_l;
  if constexpr (ROUTE != q8r::NONE)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;
  float col_s, col_b;
  ep.load(col, N, col_s, col_b);

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  RingF32<BM>::run(A, Bt, M, N, K, m0, n0, vec != 0,
                   [&](const char* as, const char* bs) {
    const float* af = reinterpret_cast<const float*>(as);
#pragma unroll 1
    for (int kc = 0; kc < BK; kc += 16) {
      const uint4 wv = ld16(bs + col_l * LDB_F32 + kc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wq = word(wv, q);
        const float b0 = int8_to_f32(wq, 0), b1 = int8_to_f32(wq, 1);
        const float b2 = int8_to_f32(wq, 2), b3 = int8_to_f32(wq, 3);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(
              af + (rg + RG * i) * BK + kc + 4 * q);
          acc[i] = fmaf(x.x, b0, acc[i]);
          acc[i] = fmaf(x.y, b1, acc[i]);
          acc[i] = fmaf(x.z, b2, acc[i]);
          acc[i] = fmaf(x.w, b3, acc[i]);
        }
      }
    }
  });

  const int role = repro::gemm::reduce<BM>(acc);
  if (role == 0) return;
  float o[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i] = ep(acc[i], col_s, col_b);
  if (role == 2)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = m0 + rg + RG * i;
      const bool live = row < M && col < N;
      if constexpr (ROUTE == q8r::NONE) {
        if (live) C[static_cast<size_t>(row) * N + col] = o[i];
      } else {
        if (ROUTE == q8r::WORKSPACE && live) q8.y[static_cast<size_t>(row) * N + col] = o[i];
        // the row's max |y| as bits (a NaN wins, as in amax) over the
        // lanes that hold its columns (BN of them, or the whole warp)
        unsigned m = live ? __float_as_uint(fabsf(o[i])) : 0u;
#pragma unroll
        for (int off = (BN < 32 ? BN : 32) / 2; off > 0; off >>= 1)
          m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (col_l % 32 == 0 && row < M) atomicMax(&smax[rg + RG * i], m);
      }
    }
  if constexpr (ROUTE == q8r::WORKSPACE) q8r::workspace_finish<BM>(q8, smax, mt, M, N);
  if constexpr (ROUTE == q8r::RESIDENT) {
    const unsigned order = q8r::arrive<BM>(q8, smax, mt, M);
    const float* scale = q8r::scales<BM>(q8, mt, M, order, nt == 0);
    if (role == 2 && col < N)
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = m0 + rg + RG * i;
        if (row < M)
          q8.q[static_cast<size_t>(row) * N + col] =
              repro::quantize_one(o[i], scale[rg + RG * i], -q8.qmax - 1.f, q8.qmax);
      }
    q8r::depart(q8, M);
  }
}

template <int BM>
int launch_tiles(const void* a, const void* wt, Epilogue ep, void* c,
                 const repro::q8::Call& q8, int M, int N, int K, int E,
                 int splits, int a_bf16, int vec, cudaStream_t st) {
  namespace q8r = repro::q8;
  const dim3 grid = repro::gemm::expert_grid<BM>(M, N, E, splits);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const q8r::Args args = q8.args(M, BM);
  using repro::gemm::launch;
  if (a_bf16) {
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
    constexpr int smem = RingBf16<BM>::SMEM;
    if (q8.route != q8r::NONE)
      return q8r::launch<BM, w8a16_bf16_kernel<BM, q8r::RESIDENT>,
                         w8a16_bf16_kernel<BM, q8r::WORKSPACE>>(
          q8, smem, grid, st, A, Bt, ep, C, args, M, N, K, vec);
    return launch<BM, w8a16_bf16_kernel<BM, q8r::NONE>>(smem, grid, st, A, Bt,
                                                         ep, C, args, M, N, K, vec);
  }
  const float* A = static_cast<const float*>(a);
  float* C = static_cast<float*>(c);
  constexpr int smem = RingF32<BM>::SMEM;
  if (q8.route != q8r::NONE)
    return q8r::launch<BM, w8a16_f32_kernel<BM, q8r::RESIDENT>,
                       w8a16_f32_kernel<BM, q8r::WORKSPACE>>(
        q8, smem, grid, st, A, Bt, ep, C, args, M, N, K, vec);
  return launch<BM, w8a16_f32_kernel<BM, q8r::NONE>>(smem, grid, st, A, Bt, ep,
                                                      C, args, M, N, K, vec);
}

int dispatch(const void* a, const void* wt, Epilogue ep, void* c,
             const repro::q8::Call& q8, int M, int N, int K, int E, int bm,
             int splits, int a_bf16, int vec, void* stream) {
  if (E < 1 || (E > 1 && q8.route != repro::q8::NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16)
    return launch_tiles<16>(a, wt, ep, c, q8, M, N, K, E, splits, a_bf16, vec, st);
  if (bm == 64)
    return launch_tiles<64>(a, wt, ep, c, q8, M, N, K, E, splits, a_bf16, vec, st);
  if (bm == 128)
    return launch_tiles<128>(a, wt, ep, c, q8, M, N, K, E, splits, a_bf16, vec,
                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BM>
int resident(int splits, int a_bf16, int* out) {
  namespace q8r = repro::q8;
  if (a_bf16)
    return q8r::residency<BM, w8a16_bf16_kernel<BM, q8r::RESIDENT>,
                          w8a16_bf16_kernel<BM, q8r::WORKSPACE>>(RingBf16<BM>::SMEM, splits,
                                                                 out);
  return q8r::residency<BM, w8a16_f32_kernel<BM, q8r::RESIDENT>,
                        w8a16_f32_kernel<BM, q8r::WORKSPACE>>(RingF32<BM>::SMEM, splits, out);
}

}  // namespace

// a [M, K] bf16 (a_bf16 = 1) or float32; wt [N, K] int8 (the K-major
// weight); sw float32 or bf16 (sw_bf16) read at col * sw_stride; bias [N]
// float32 or bf16 (bias_bf16) or NULL; c [M, N] in a's type — all
// contiguous. bm (16, 64 or 128) and splits (1 ... 16, the K splits of a tile)
// come from kernels/gemm_plan.py. `vec` = 1 when K % 16 == 0 and a and wt
// are 16-byte aligned. E > 1 experts in one launch: each operand E of those
// back to back (a [E, M, K], wt [E, N, K], sw [E, N] or [E, 1], bias
// [E, N], c [E, M, N]).
extern "C" int repro_qmatmul_w8a16(const void* a, const void* wt,
                                   const void* sw, int sw_stride, int sw_bf16,
                                   const void* bias, int bias_bf16, void* c,
                                   int M, int N, int K, int E, int bm,
                                   int splits, int a_bf16, int vec,
                                   void* stream) {
  const Epilogue ep{sw, sw_stride, sw_bf16, bias, bias_bf16};
  return dispatch(a, wt, ep, c, repro::q8::Call{}, M, N, K, E, bm, splits,
                  a_bf16, vec, stream);
}

// The quantize-out variant: operands as above; q [M, N] int8 and s [M]
// float32 out, at qmax = 2^(bits-1) - 1; scratch [M + ceil(M / bm) + 2]
// uint32, zero on entry and left zero (q8_epilogue.cuh). route 1
// (RESIDENT): every CTA quantizes its own tile, y unused; route 2
// (WORKSPACE): y [M, N] float32 is the workspace, and the last `waiters`
// CTAs of an M tile to arrive quantize it; `ticketed`: tiles by ticket, M
// tile by M tile. The route, waiters and ticketed come from
// kernels/gemm_plan.py (GemmPlan.q8_route).
extern "C" int repro_qmatmul_w8a16_q8(const void* a, const void* wt,
                                      const void* sw, int sw_stride,
                                      int sw_bf16, const void* bias,
                                      int bias_bf16, void* y, void* scratch,
                                      void* q, void* s, int M, int N, int K,
                                      int bm, int splits, int route, int waiters,
                                      int qmax, int ticketed, int a_bf16,
                                      int vec, void* stream) {
  const Epilogue ep{sw, sw_stride, sw_bf16, bias, bias_bf16};
  repro::q8::Call q8;
  q8.route = route;
  q8.waiters = waiters;
  q8.qmax = qmax;
  q8.ticketed = ticketed;
  q8.y = y;
  q8.scratch = scratch;
  q8.q = q;
  q8.s = s;
  if (route == repro::q8::NONE || qmax < 0 || qmax > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(a, wt, ep, nullptr, q8, M, N, K, 1, bm, splits, a_bf16, vec,
                  stream);
}

// The clusters of `splits` CTAs (CTAs at splits = 1) of the quantize-out
// kernels for a's type at bm-row tiles that the card keeps resident at
// once, into *out: gemm_plan's residency. Returns the CUDA error.
extern "C" int repro_qmatmul_w8a16_q8_residency(int bm, int splits,
                                                int a_bf16, int* out) {
  if (bm == 16) return resident<16>(splits, a_bf16, out);
  if (bm == 64) return resident<64>(splits, a_bf16, out);
  if (bm == 128) return resident<128>(splits, a_bf16, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
