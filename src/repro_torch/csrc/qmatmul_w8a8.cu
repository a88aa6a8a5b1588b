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
// Epilogue-free variant (out_kind 2, qmatmul_w8a8_i32): the same mainloop
// and reduction, then the exact int32 accumulator stored as it is — a
// row-parallel shard's partial sums, which the ranks add in int32 (exact,
// unlike float32 partials: |acc| reaches 7.8e7 at K = 4864, past 2^24)
// before the scale epilogue; sa, sw and bias are not read.
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
// Quantize-in variant (qmatmul_w8a8_qin: quantize_act folded into this
// GEMM, wherever kernels/gemm_plan.py folds — every decode tile, M <= 16):
// A is the float activation (bfloat16 or float32), not int8 + sa. Every CTA
// of an M tile needs the same int8 rows, so a cluster of `share`
// neighbouring N tiles (x the K splits) divides the quantizing
// (QuantizeIn): each CTA reads its part of its split's K range into
// registers before it issues its first weight stages, takes the rows'
// partial max, and pushes it into every CTA of the cluster through
// distributed shared memory; the max of all the parts is exact in any
// order, so every CTA holds the row's scale, absmax_scale(amax, 127). Each
// CTA quantizes its part (common.cuh quantize16: quantize_one's integers,
// clip [-128, 127]) into its resident int8 slice, in the ring's A-tile
// layout, and the copy engine copies it into the slice of each other CTA
// at its split; then the mainloop streams W alone, and the epilogue takes
// the row scale from shared memory. Arrival is counted on each receiver's
// transaction barriers: no cluster barrier on the path. Bit-equal to
// quantize_act followed by the int8 GEMM: the same max, the same IEEE
// quotient's integer, the same exact sums. The first cluster along N may
// also write the int8 rows and scales out — quantize_act's output — for
// the other GEMMs that read the same activation. Rows past M keep the
// 1e-8 floor (finite) and are never stored. The resident slice, BM x the
// split's K steps x 64 bytes, must fit beside the ring (QIN_SMEM_MAX; the
// planner refuses the fold otherwise).
//
// Quantize-out variant (replaces qmatmul_w8a8_q8_pallas,
// src/repro/kernels/qmatmul_w8a8/kernel.py:143): the same mainloop and the
// same y, then q8_epilogue.cuh in the same launch, at any bits from 1 to 8.
// Where the card keeps the launch's tiles resident at once (gemm_plan's
// RESIDENT route) the CTA that reduces a tile keeps y in registers, shares
// its rows' max through the scratch, waits for its M tile's other N tiles
// and quantizes its own tile; elsewhere (WORKSPACE) y goes to a float32
// workspace and the last CTAs of each M tile to finish divide its rows.
// Payload and scale are bit-equal to the float32 GEMM followed by
// quantize_act, and to the plain version.
#include "common.cuh"
#include "gemm_mainloop.cuh"
#include "q8_epilogue.cuh"

#include <algorithm>

namespace {

using repro::gemm::BK;
using repro::gemm::ld16;
using repro::gemm::word;

// repro_qmatmul_w8a8's output kinds (kernel.py OUT_KINDS)
constexpr int OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2;

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

// ROUTE (q8_epilogue.cuh): NONE writes C; RESIDENT and WORKSPACE write the
// quantize-out epilogue's int8 and scales instead.
template <int BM, typename OutT, int ROUTE>
__global__ void __launch_bounds__(repro::gemm::Tile<BM>::THREADS)
qmatmul_w8a8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                    const float* __restrict__ sa, const float* __restrict__ sw,
                    const float* __restrict__ bias, OutT* __restrict__ C,
                    repro::q8::Args q8, int M, int N, int K, int vec) {
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
  if constexpr (!std::is_same<OutT, int>::value) {
    sa += e * M;
    sw += e * N;
    bias += e * N;
  }
  if constexpr (ROUTE == q8r::NONE) C += e * M * N;
  if constexpr (ROUTE != q8r::NONE) q8r::take_tile(q8, gridDim.x, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  if constexpr (ROUTE != q8r::NONE)
    for (int i = threadIdx.x; i < BM; i += blockDim.x) smax[i] = 0u;
  // the epilogue's operands, loaded now so their latency hides under the
  // mainloop (0 past M or N)
  // (the int32 variant reads none: its sa, sw and bias are null)
  constexpr bool ACC_OUT = std::is_same<OutT, int>::value;
  float row_s[W::MT][2], col_s[W::NT][2], col_b[W::NT][2];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + w.row(i, h);
      row_s[i][h] = !ACC_OUT && r < M ? sa[r] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < W::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + w.col(j, e);
      col_s[j][e] = !ACC_OUT && c < N ? sw[c] : 0.f;
      col_b[j][e] = !ACC_OUT && c < N ? bias[c] : 0.f;
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
          o[i][h][j][e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[(i * W::NT + j) * 4 + 2 * h + e]),
                                  row_s[i][h]),
                        col_s[j][e]),
              col_b[j][e]);
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
          if constexpr (ACC_OUT) {
            // the exact accumulator, no epilogue
            int* p = C + static_cast<size_t>(row) * N + col;
            p[0] = acc[(i * W::NT + j) * 4 + 2 * h];
            if (col + 1 < N) p[1] = acc[(i * W::NT + j) * 4 + 2 * h + 1];
          } else if constexpr (ROUTE == q8r::NONE) {
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

// The quantize-in GEMM runs at the decode tile only (gemm_plan.FOLD_BM: a
// prefill chunk's 64-row tiles are faster as quantize_act + the int8 GEMM);
// its ring (W only) and the most dynamic shared memory it may take with its
// resident A (gemm_plan.QIN_SMEM_MAX): the H100's 227 KB a block less 10 KB
// kept for the static row maxes, scales and barriers.
constexpr int QBM = 16;
template <int BM>
using RingW = repro::gemm::Ring<BM, 0, LDS, LDS>;
constexpr int QIN_SMEM_MAX = 217 * 1024;

// Distributed shared memory pushes completed on the receiver's
// transaction barrier (sm_90): a shared::cta address, the peer CTA's
// shared::cluster address of it, and the mbarrier steps.
__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(cta_addr(bar)), "r"(bytes) : "memory");
}
// Wait for phase 0 of `bar` by non-blocking polls; a wait that outlasts
// 2^26 of them (well over a second; the pushes land in microseconds) traps
// — a fault reported at the next synchronize, never a hang.
__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(cta_addr(bar)) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}
// v to the peer's shared::cluster address, counted on its barrier
__device__ __forceinline__ void push32(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// `bytes` (a multiple of 16) of this CTA's shared memory at `src` to the
// peer's shared::cluster address `dst`, by the copy engine, counted on the
// peer's barrier
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// The quantize-in prologue. The cluster is `share` neighbouring N tiles x
// the S splits of the same M tile: the CTAs at split z all need rows
// [m0, m0 + BM) of x over the split's K steps [k0, k1), quantized by one
// row scale. CTA x of them takes part x of those steps. load() issues its
// 16-byte loads into registers before the weight stages are issued (an
// x load queued behind the weight's copies would wait for HBM); finish(),
// after them, takes the rows' partial max (a shared-memory atomicMax of
// the non-negative float bits, fmaxf's order) and pushes it into its slot
// of every CTA of the cluster (st.async): when a CTA's transaction barrier
// has counted every CTA's maxes, it takes their max — the same in every
// CTA, whatever the order. It then quantizes its part into its own resident
// slice (`res`, one [BM, BK] tile a step, as the ring's A stages; the
// part's tiles are contiguous) and the copy engine copies the part into
// the slice of each other CTA at its split (cp.async.bulk, counted on the
// receiver's second barrier): the slice is whole when that barrier has
// counted the other parts' bytes. Of the two cluster barriers, the first
// publishes the barriers' initialization (armed in load()), the second
// (waited in retire(), after the mainloop) keeps every CTA resident until
// the copies out of it are done. Rows past M and bytes past K are written
// 0. Every thread of every CTA of the cluster must call all three.
template <int BM, typename XT>
struct QuantizeIn {
  static constexpr int EPV = 16 / sizeof(XT);          // elements a vector
  static constexpr int THREADS = repro::gemm::Tile<BM>::THREADS;
  static constexpr int HOLD = 4;                       // vectors a thread keeps
  const XT* __restrict__ X;
  int8_t* aq;  // the quantized activation [M, K] and its scales [M], or null
  float* as;
  char* res;
  float *part, *rs, *rc, *all;
  uint64_t* bar;
  int K, m0, k0, k1, p0, p1, nv, items, rows;
  bool vec, shared;
  dim3 at, dims;
  uint4 held[HOLD];

  __device__ __forceinline__ QuantizeIn(const XT* x, int8_t* aq_, float* as_,
                                        char* res_, float* part_, float* rs_,
                                        float* rc_, float* all_, uint64_t* bar_,
                                        int M_, int K_, int m0_, int k0_,
                                        int k1_, bool vec_)
      : X(x), aq(aq_), as(as_), res(res_), part(part_), rs(rs_), rc(rc_),
        all(all_), bar(bar_), K(K_), m0(m0_), k0(k0_), k1(k1_), vec(vec_) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    at = cluster.block_index();
    dims = cluster.dim_blocks();
    shared = dims.x * dims.z > 1;
    // this CTA's part of the split: steps [p0, p1), vectors over all BM rows
    p0 = k0 + (k1 - k0) * static_cast<int>(at.x) / static_cast<int>(dims.x);
    p1 = k0 + (k1 - k0) * static_cast<int>(at.x + 1) / static_cast<int>(dims.x);
    nv = (p1 - p0) * BK / EPV;
    items = BM * nv;
    rows = min(BM, M_ - m0);
    // the first cluster along N writes the quantized activation out
    if (blockIdx.x >= dims.x) aq = nullptr;
  }

  __device__ __forceinline__ void where(int i, int& r, int& k) const {
    r = i / nv;
    k = p0 * BK + (i % nv) * EPV;
  }
  __device__ __forceinline__ bool live(int r, int k) const { return r < rows && k < K; }
  __device__ __forceinline__ uint4 read(int r, int k) const {
    return repro::load16(X + static_cast<size_t>(m0 + r) * K, k, K, vec);
  }
  // the vector of this thread's j-th item (r, k): held, or read again
  __device__ __forceinline__ uint4 vector(int j, int r, int k) const {
    uint4 v = held[0];
#pragma unroll
    for (int h = 1; h < HOLD; ++h)
      if (j == h) v = held[h];
    return j < HOLD ? v : read(r, k);
  }

  __device__ __forceinline__ void load() {
#pragma unroll
    for (int h = 0; h < HOLD; ++h) {  // (static indices: held stays in registers)
      const int i = threadIdx.x + h * THREADS;
      int r, k;
      where(i, r, k);
      held[h] = i < items && live(r, k) ? read(r, k) : make_uint4(0u, 0u, 0u, 0u);
    }
    if (threadIdx.x < BM) part[threadIdx.x] = 0.f;
    if (shared) {  // while the loads are in flight
      if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b)  // one arrival each: the expect_tx
          asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                       ::"r"(cta_addr(bar + b)), "r"(1) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    }
  }

  __device__ __forceinline__ void finish() {
    namespace cg = cooperative_groups;
    __syncthreads();  // part is zero
    for (int i = threadIdx.x, j = 0; i < items; i += THREADS, ++j) {
      int r, k;
      where(i, r, k);
      if (!live(r, k)) continue;
      // a non-negative max (never NaN: fmaxf drops it) orders as its bits
      atomicMax(reinterpret_cast<unsigned*>(part) + r,
                __float_as_uint(repro::absmax16<XT>(vector(j, r, k), 0.f)));
    }
    __syncthreads();
    float m = threadIdx.x < BM ? part[threadIdx.x] : 0.f;
    if (shared) {
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned n = cluster.num_blocks(), me = cluster.block_rank();
      // every peer's barriers are initialized
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      // this CTA's maxes into slot `me` of every CTA's `all`
      if (threadIdx.x == 0) expect_bytes(bar, 4u * BM * n);
      for (unsigned t = threadIdx.x; t < BM * n; t += THREADS)
        push32(peer_addr(cta_addr(all + me * BM + t % BM), t / BM), part[t % BM],
               peer_addr(cta_addr(bar), t / BM));
      wait_phase0(bar);
      if (threadIdx.x < BM)
        for (unsigned q = 0; q < n; ++q) m = fmaxf(m, all[q * BM + threadIdx.x]);
    }
    if (threadIdx.x < BM) {
      rs[threadIdx.x] = repro::absmax_scale(m, 127.f);
      rc[threadIdx.x] = repro::quantize_rcp(rs[threadIdx.x]);
      if (aq != nullptr && at.x == 0 && at.z == 0 && threadIdx.x < rows)
        as[m0 + threadIdx.x] = rs[threadIdx.x];
    }
    __syncthreads();
    for (int i = threadIdx.x, j = 0; i < items; i += THREADS, ++j) {
      int r, k;
      where(i, r, k);
      uint2 p = make_uint2(0u, 0u);
      if (live(r, k)) {
        p = repro::quantize16<XT>(vector(j, r, k), rs[r], rc[r], -128.f, 127.f);
        if (aq != nullptr) {
          int8_t* out = aq + static_cast<size_t>(m0 + r) * K + k;
          if (vec && EPV == 8)
            *reinterpret_cast<uint2*>(out) = p;
          else if (vec)
            *reinterpret_cast<uint32_t*>(out) = p.x;
          else
#pragma unroll
            for (int e = 0; e < EPV; ++e)
              if (k + e < K) out[e] = static_cast<int8_t>((e < 4 ? p.x : p.y) >> (8 * (e & 3)));
        }
      }
      const int kp = k - k0 * BK;                      // offset in the slice
      char* dst = res + (kp / BK) * (BM * BK) + r * BK + kp % BK;
      if constexpr (EPV == 8)
        *reinterpret_cast<uint2*>(dst) = p;
      else
        *reinterpret_cast<uint32_t*>(dst) = p.x;
    }
    if (!shared) {
      __syncthreads();
      return;
    }
    // this part's tiles are contiguous in the slice: one copy to each CTA
    // at split z, issued once they are visible to the copy engine
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t mine = cta_addr(res + (p0 - k0) * (BM * BK));
      const uint32_t bytes = (p1 - p0) * (BM * BK);
      expect_bytes(bar + 1, (k1 - k0) * (BM * BK) - bytes);
      for (unsigned x = 0; x < dims.x; ++x) {
        const uint32_t rank = x + dims.x * dims.y * at.z;
        if (x != at.x && bytes > 0)
          copy_to_peer(peer_addr(mine, rank), mine, bytes,
                       peer_addr(cta_addr(bar + 1), rank));
      }
    }
    // the slice whole: every peer's part has landed
    wait_phase0(bar + 1);
    // this CTA's copies in and out are done once every CTA has arrived
    // here; retire() waits for that before the CTA may leave
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  // After the mainloop: no CTA leaves while the copy engine may still read
  // its part for a peer.
  __device__ __forceinline__ void retire() const {
    if (shared) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
};

template <int BM, typename XT, typename OutT>
__global__ void __launch_bounds__(repro::gemm::Tile<BM>::THREADS)
qmatmul_w8a8_qin_kernel(const XT* __restrict__ X, const int8_t* __restrict__ Bt,
                        const float* __restrict__ sw,
                        const float* __restrict__ bias, OutT* __restrict__ C,
                        int8_t* __restrict__ AQ, float* __restrict__ AS,
                        int M, int N, int K, int vec) {
  using W = repro::gemm::WarpTile<BM>;
  // the part's row max; the row scale and its quantize_rcp; every CTA's
  // part maxes; the transaction barriers of those and of the int8 parts
  __shared__ float part[BM], rs[BM], rc[BM], all[repro::gemm::MAX_SPLITS * BM];
  __shared__ uint64_t bar[2];
  const W w;
  constexpr int BN = repro::gemm::Tile<BM>::BN;
  int mt;
  const size_t e = repro::gemm::expert_tile<BM>(M, mt);
  X += e * M * K;
  Bt += e * N * K;
  sw += e * N;
  bias += e * N;
  C += e * M * N;
  if (AQ != nullptr) {
    AQ += e * M * K;
    AS += e * M;
  }
  const int m0 = mt * BM, n0 = blockIdx.x * BN;
  float col_s[W::NT][2], col_b[W::NT][2];
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

  char* res = repro::gemm::ring_smem() + RingW<BM>::SMEM;
  const long long steps = (K + BK - 1) / BK;
  const int k0 = static_cast<int>(blockIdx.z * steps / gridDim.z);
  const int k1 = static_cast<int>((blockIdx.z + 1) * steps / gridDim.z);
  QuantizeIn<BM, XT> qin(X, AQ, AS, res, part, rs, rc, all, bar, M, K, m0, k0,
                         k1, vec != 0);
  qin.load();
  RingW<BM>::run(res, Bt, M, N, K, m0, n0, vec != 0,
                 [&](const char* as, const char* bs) {
    uint4 a[W::MT][2], b[W::NT];
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = ld16(as + w.row(i, h) * LDS + 16 * w.t);
#pragma unroll
    for (int j = 0; j < W::NT; ++j) b[j] = ld16(bs + w.b_row(j) * LDS + 16 * w.t);
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
  }, [&] { qin.finish(); });
  qin.retire();

  if (repro::gemm::reduce<BM>(acc) != 2) return;
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + w.row(i, h);
      if (row >= M) continue;
      const float row_s = rs[w.row(i, h)];
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int col = n0 + w.col(j, 0);
        if (col >= N) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[(i * W::NT + j) * 4 + 2 * h + e]),
                                  row_s),
                        col_s[j][e]),
              col_b[j][e]);
        repro::gemm::store_pair(C, row, col, N, o[0], o[1]);
      }
    }
}

template <typename XT>
int launch_qin(const void* x, const void* wt, const void* sw, const void* bias,
               void* c, void* aq, void* as, int M, int N, int K, int E, int bm,
               int splits, int share, int out_bf16, int vec, cudaStream_t st) {
  constexpr int BM = QBM;
  if (bm != BM || share < 1) return static_cast<int>(cudaErrorInvalidValue);
  // N tiles rounded up to whole clusters; the CTAs past N only quantize
  dim3 grid = repro::gemm::expert_grid<BM>(M, N, E, splits);
  grid.x = (grid.x + share - 1) / share * share;
  const long long steps = (K + BK - 1) / BK;
  const long long longest = (steps + splits - 1) / splits;  // a split's steps
  // the reduction reuses the ring's shared memory, which holds its partials
  static_assert(repro::gemm::WarpTile<BM>::ACC * 4 * repro::gemm::Tile<BM>::THREADS <=
                RingW<BM>::SMEM);
  const long long smem = RingW<BM>::SMEM + static_cast<long long>(BM) * BK * longest;
  if (splits < 1 || smem > QIN_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const XT* X = static_cast<const XT*>(x);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const float* SW = static_cast<const float*>(sw);
  const float* BI = static_cast<const float*>(bias);
  int8_t* AQ = static_cast<int8_t*>(aq);
  float* AS = static_cast<float*>(as);
  using repro::gemm::launch_upto;
  if (out_bf16)
    return launch_upto<BM, qmatmul_w8a8_qin_kernel<BM, XT, __nv_bfloat16>>(
        static_cast<int>(smem), QIN_SMEM_MAX, share, grid, st, X, Bt, SW, BI,
        static_cast<__nv_bfloat16*>(c), AQ, AS, M, N, K, vec);
  return launch_upto<BM, qmatmul_w8a8_qin_kernel<BM, XT, float>>(
      static_cast<int>(smem), QIN_SMEM_MAX, share, grid, st, X, Bt, SW, BI,
      static_cast<float*>(c), AQ, AS, M, N, K, vec);
}

template <int BM>
int launch_tiles(const void* a, const void* wt, const void* sa, const void* sw,
                 const void* bias, void* c, const repro::q8::Call& q8, int M,
                 int N, int K, int E, int splits, int out_kind, int vec,
                 cudaStream_t st) {
  namespace q8r = repro::q8;
  const dim3 grid = repro::gemm::expert_grid<BM>(M, N, E, splits);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* Bt = static_cast<const int8_t*>(wt);
  const float* SA = static_cast<const float*>(sa);
  const float* SW = static_cast<const float*>(sw);
  const float* BI = static_cast<const float*>(bias);
  const q8r::Args args = q8.args(M, BM);
  constexpr int smem = Ring<BM>::SMEM;
  using repro::gemm::launch;
  if (q8.route != q8r::NONE)
    return q8r::launch<BM, qmatmul_w8a8_kernel<BM, float, q8r::RESIDENT>,
                       qmatmul_w8a8_kernel<BM, float, q8r::WORKSPACE>>(
        q8, smem, grid, st, A, Bt, SA, SW, BI, static_cast<float*>(nullptr),
        args, M, N, K, vec);
  if (out_kind == OUT_BF16)
    return launch<BM, qmatmul_w8a8_kernel<BM, __nv_bfloat16, q8r::NONE>>(
        smem, grid, st, A, Bt, SA, SW, BI, static_cast<__nv_bfloat16*>(c),
        args, M, N, K, vec);
  if (out_kind == OUT_I32)
    return launch<BM, qmatmul_w8a8_kernel<BM, int, q8r::NONE>>(
        smem, grid, st, A, Bt, SA, SW, BI, static_cast<int*>(c), args, M, N,
        K, vec);
  return launch<BM, qmatmul_w8a8_kernel<BM, float, q8r::NONE>>(
      smem, grid, st, A, Bt, SA, SW, BI, static_cast<float*>(c), args, M, N,
      K, vec);
}

int dispatch(const void* a, const void* wt, const void* sa, const void* sw,
             const void* bias, void* c, const repro::q8::Call& q8, int M,
             int N, int K, int E, int bm, int splits, int out_kind, int vec,
             void* stream) {
  if (E < 1 || (E > 1 && q8.route != repro::q8::NONE) || out_kind < OUT_F32 ||
      out_kind > OUT_I32 || (out_kind == OUT_I32 && q8.route != repro::q8::NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16)
    return launch_tiles<16>(a, wt, sa, sw, bias, c, q8, M, N, K, E, splits,
                            out_kind, vec, st);
  if (bm == 64)
    return launch_tiles<64>(a, wt, sa, sw, bias, c, q8, M, N, K, E, splits,
                            out_kind, vec, st);
  if (bm == 128)
    return launch_tiles<128>(a, wt, sa, sw, bias, c, q8, M, N, K, E, splits,
                             out_kind, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BM>
int resident(int splits, int* out) {
  namespace q8r = repro::q8;
  return q8r::residency<BM, qmatmul_w8a8_kernel<BM, float, q8r::RESIDENT>,
                        qmatmul_w8a8_kernel<BM, float, q8r::WORKSPACE>>(Ring<BM>::SMEM,
                                                                        splits, out);
}

}  // namespace

// a [M, K] int8, wt [N, K] int8 (the K-major weight), sa [M], sw [N],
// bias [N] float32, c [M, N] float32 (out_kind 0) or bfloat16 (1) — all
// contiguous; out_kind 2 is the epilogue-free variant: c [M, N] int32, the
// exact accumulator, and sa, sw and bias are not read (may be null); E > 1
// experts in one launch: each operand E of those back to back ([E, M, K],
// [E, N, K], [E, M], [E, N], [E, N], [E, M, N]). bm (16, 64 or 128) and
// splits (1 ... 16, the K splits of a tile) come from kernels/gemm_plan.py.
// `vec` = 1 when K % 16 == 0 and both int8 bases are 16-byte aligned.
extern "C" int repro_qmatmul_w8a8(const void* a, const void* wt, const void* sa,
                                  const void* sw, const void* bias, void* c,
                                  int M, int N, int K, int E, int bm,
                                  int splits, int out_kind, int vec,
                                  void* stream) {
  return dispatch(a, wt, sa, sw, bias, c, repro::q8::Call{}, M, N, K, E, bm,
                  splits, out_kind, vec, stream);
}

// The quantize-in variant: x [M, K] float32 (x_bf16 == 0) or bfloat16 in
// place of a and sa, quantized per row in the launch (the quantize_act
// formula at 8 bits); `share` N tiles (x splits <= 16 CTAs a cluster)
// split the quantization of their A. With aq [M, K] int8 and as [M]
// float32 (else both null) the launch also writes the quantized activation
// out — quantize_act's output — for the other GEMMs that read x. `vec` = 1
// when K % 16 == 0 and the bases of x, wt and aq are 16-byte aligned.
// E > 1 experts in one launch, each operand back to back as
// repro_qmatmul_w8a8's (x and aq [E, M, K], as [E, M]).
// Returns cudaErrorInvalidValue at a tile other than the decode tile (bm
// 16) and where the resident int8 slice does not fit (QIN_SMEM_MAX;
// gemm_plan.GemmPlan.fold).
extern "C" int repro_qmatmul_w8a8_qin(const void* x, const void* wt,
                                      const void* sw, const void* bias,
                                      void* c, void* aq, void* as, int M,
                                      int N, int K, int E, int bm, int splits,
                                      int share, int x_bf16, int out_bf16,
                                      int vec, void* stream) {
  if (E < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_qin<__nv_bfloat16>(x, wt, sw, bias, c, aq, as, M, N, K, E,
                                     bm, splits, share, out_bf16, vec, st);
  return launch_qin<float>(x, wt, sw, bias, c, aq, as, M, N, K, E, bm, splits,
                           share, out_bf16, vec, st);
}

// The quantize-out variant: q [M, N] int8 and s [M] float32 out, at
// qmax = 2^(bits-1) - 1; scratch [M + ceil(M / bm) + 2] uint32, zero on
// entry and left zero (q8_epilogue.cuh). route 1 (RESIDENT) every CTA
// quantizes its own tile, y unused; route 2 (WORKSPACE) y [M, N] float32
// is the workspace, and the last `waiters` CTAs of an M tile to arrive
// quantize it; `ticketed`: tiles by ticket, M tile by M tile. The route,
// waiters and ticketed come from kernels/gemm_plan.py (GemmPlan.q8_route).
extern "C" int repro_qmatmul_w8a8_q8(const void* a, const void* wt,
                                     const void* sa, const void* sw,
                                     const void* bias, void* y, void* scratch,
                                     void* q, void* s, int M, int N, int K,
                                     int bm, int splits, int route, int waiters,
                                     int qmax, int ticketed, int vec, void* stream) {
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
  return dispatch(a, wt, sa, sw, bias, nullptr, q8, M, N, K, 1, bm, splits, 0,
                  vec, stream);
}

// The clusters of `splits` CTAs (CTAs at splits = 1) of the quantize-out
// kernels at bm-row tiles the card keeps resident at once, into *out:
// gemm_plan's residency. Returns the CUDA error.
extern "C" int repro_qmatmul_w8a8_q8_residency(int bm, int splits, int* out) {
  if (bm == 16) return resident<16>(splits, out);
  if (bm == 64) return resident<64>(splits, out);
  if (bm == 128) return resident<128>(splits, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
