// The mainloop the two GEMMs share (qmatmul_w8a8.cu, qmatmul_w8a16.cu): an
// output tile of BM x BN per CTA, K walked in steps of BK elements through
// rings of shared-memory stages filled asynchronously, the partial sums of
// the CTA's warp groups and of the CTAs of a K split added in the same
// launch.
//
// Why: at decode (M = 8) a GEMM of the serving path streams an int8 weight
// of 0.1-4.4 MB and does ~16 operations a byte, so it is bound by bytes —
// and at these sizes by latency. A warp keeps only a few KB of loads in
// flight however deep its ring, so the weight must be read by many warps at
// once, each walking few K steps.
//
//  * The rings: each group of warps of a CTA (Tile<BM>) walks its share of
//    the CTA's K steps through a ring of its own: STAGES stages of
//    (activation tile [BM, BK] + K-major weight tile [BN, BK]). While step k
//    is consumed, the next STAGES - 1 are in flight as 16-byte cp.async.cg
//    copies, one commit group per step. Rows past M or N and bytes past K
//    are zero-filled by the copy's source-size operand. When rows are not
//    16-byte aligned (vec == 0: K % 16 != 0 or an unaligned base) the same
//    rings are filled by a synchronous byte loader.
//  * The ring may carry W only: the quantize-in W8A8 GEMM (qmatmul_w8a8.cu,
//    wherever kernels/gemm_plan.py folds quantize_act into it — every decode
//    tile) quantizes its split's slice of the float activation once, in a
//    prologue that runs while the first weight stages are in flight, into a
//    shared-memory buffer laid out as the ring's A tiles, one a K step; each
//    step then reads its A tile there (Ring<BM, 0, ...>).
//  * Split-K: the grid is N-tiles x M-tiles x S, split z walks K steps
//    [z * steps / S, (z + 1) * steps / S), and the S splits of a tile are one
//    thread block cluster (1, 1, S), S <= MAX_SPLITS — (share, 1, S) in the
//    quantize-in GEMM, whose `share` neighbouring N tiles divide the
//    quantizing. BM, S and share come from the Python planner
//    (kernels/gemm_plan.py, which also holds BN, BK and the rule).
//  * Experts: an expert-batched launch (the MoE block's projections: E
//    experts' [M, K] x [K, N], the operands of each back to back) puts E x
//    m_tiles M tiles on the grid's y axis, expert y / m_tiles, M tile
//    y % m_tiles (expert_tile). No cluster spans y, so a tile's splits and
//    quantize-in neighbours are always one expert's; each CTA offsets its
//    operands to its expert's before anything else.
//  * The reduction, deterministic and in the same launch: the groups add
//    their partials in shared memory in group order; then each split stores
//    its tile's sum to its own shared memory and, after a cluster barrier,
//    rank 0 reads the others through distributed shared memory and adds them
//    in rank order 0 ... S-1 (exact in int32; in float32 the same order
//    whichever split finished first) and alone runs the kernel's epilogue;
//    a second barrier keeps the others resident until it has read them. No
//    global workspace, counter or fence: the partials never leave the GPC.
//  * Fragments: each lane reads 16 contiguous bytes of its row of a stage
//    (lane t of a quad the K bytes [16t, 16t + 16)) and feeds them to the
//    MMAs of that step in order. That permutes K the same way for the A and
//    the B fragment, so every product still pairs A[m, k] with B[k, n]; the
//    eight lanes of a quad-row pair read 128 contiguous bytes, free of bank
//    conflicts in the unpadded int8 rows.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int BK = 64;          // K elements per ring step (gemm_plan.BK)
constexpr int MAX_SPLITS = 16;  // the H100's largest (non-portable) cluster

// The three CTA tiles (gemm_plan.TILES): BM x BN outputs, GROUPS groups of
// WM x WN warps, each group with a ring of its own of STAGES stages
// (STAGES_WIDE for bf16 and float32 activations, whose tiles are 2-4x
// larger). A group walks its share of the CTA's K steps over the whole tile;
// the groups' partials are added in shared memory. A warp keeps only a few
// KB of loads in flight whatever the ring's depth, so the more warps stream
// a tile's weight at once, the sooner it is read.
//  * Decode (M <= 16): 16 x 16, eight one-warp groups.
//  * M <= 256 (a prefill chunk): 64 x 32, two groups of 2 x 2 warps of
//    32 x 16.
//  * Larger M: 128 x 64, one group of 4 x 2 warps of 32 x 32, so that each
//    operand is re-read from L2 by half as many tiles.
template <int BM>
struct Tile;
template <>
struct Tile<16> {
  static constexpr int BN = 16, WM = 1, WN = 1, GROUPS = 8;
  static constexpr int STAGES = 3, STAGES_WIDE = 2;
  static constexpr int GROUP_THREADS = 32 * WM * WN, THREADS = GROUP_THREADS * GROUPS;
};
template <>
struct Tile<64> {
  static constexpr int BN = 32, WM = 2, WN = 2, GROUPS = 2;
  static constexpr int STAGES = 4, STAGES_WIDE = 3;
  static constexpr int GROUP_THREADS = 32 * WM * WN, THREADS = GROUP_THREADS * GROUPS;
};
template <>
struct Tile<128> {
  static constexpr int BN = 64, WM = 4, WN = 2, GROUPS = 1;
  static constexpr int STAGES = 4, STAGES_WIDE = 3;
  static constexpr int GROUP_THREADS = 32 * WM * WN, THREADS = GROUP_THREADS * GROUPS;
};

// The expert-batched grid: blockIdx.y = expert * m_tiles + M tile, where
// M (the rows an expert) takes m_tiles tiles of BM. Returns the expert and
// sets mt to its M tile; with one expert (gridDim.y == m_tiles) the expert
// is 0 and mt blockIdx.y.
template <int BM>
__device__ __forceinline__ int expert_tile(int M, int& mt) {
  const int m_tiles = (M + BM - 1) / BM;
  const int e = static_cast<int>(blockIdx.y) / m_tiles;
  mt = static_cast<int>(blockIdx.y) - e * m_tiles;
  return e;
}

// The grid of E experts' BM x BN tiles of [M, N] with S splits each; an
// invalid grid (y past the hardware's 65535) has y = 0.
template <int BM>
inline dim3 expert_grid(int M, int N, int E, int splits) {
  const long long y = static_cast<long long>(E) * ((M + BM - 1) / BM);
  return dim3((N + Tile<BM>::BN - 1) / Tile<BM>::BN, y <= 65535 ? static_cast<unsigned>(y) : 0u,
              splits);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Byte i of w as the float it holds as an int8, exact: the biased byte in
// the low mantissa of 2^23 gives 2^23 + 128 + x, and the subtraction removes
// both. One PRMT and one FADD, no integer-to-float conversion.
__device__ __forceinline__ float int8_to_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | i)) -
         8388736.0f;
}

// ROWS rows of ROW_BYTES bytes (one K step) of a row-major matrix whose rows
// are `ld` bytes long, from row r0 and byte kb0, into shared rows of LDS
// bytes, by the THREADS threads of a group (this one is `tid`); zero past
// row `rows` and byte `ld`. vec: 16-byte copies in flight (every row 16-byte
// aligned, ld % 16 == 0); else synchronous bytes.
template <int ROWS, int ROW_BYTES, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(char* dst, const char* src, int r0,
                                          int rows, int kb0, int ld, bool vec,
                                          int tid) {
  constexpr int CHUNKS = ROW_BYTES / 16;
  for (int c = tid; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, kc = (c % CHUNKS) * 16;
    const int gr = r0 + r, gk = kb0 + kc;
    const int n = gr < rows ? max(0, min(16, ld - gk)) : 0;
    const char* p = n > 0 ? src + static_cast<size_t>(gr) * ld + gk : src;
    char* d = dst + r * LDS + kc;
    if (vec) {
      cp_async16(d, p, n);
    } else {
      union {
        uint4 v;
        char b[16];
      } ch;
#pragma unroll
      for (int i = 0; i < 16; ++i) ch.b[i] = i < n ? p[i] : 0;
      *reinterpret_cast<uint4*>(d) = ch.v;
    }
  }
}

// The dynamic shared memory, 128-byte aligned: it follows the kernel's
// static shared memory, and a ring that started 144 bytes in (16 past a
// 128-byte boundary) cost the quantize-out W8A8 GEMM 3.4 of its 12.2 µs at
// M = 8, K = 896, N = 4864 on an H100, though its instructions were the
// plain GEMM's (scratch variants timed in one call).
__device__ __forceinline__ char* ring_smem() {
  extern __shared__ __align__(128) char ring[];
  return ring;
}

// The rings of one kernel: A elements of EA bytes in rows of LDA bytes, the
// int8 weight in rows of LDB bytes (LDA, LDB >= the step's bytes; padding
// where a kernel's fragment reads would otherwise conflict); one ring for
// each group of the tile. EA = 0: A is resident, not in the ring — an int8
// buffer of one [BM, LDA] tile a K step of the split, from K step k0 on.
template <int BM, int EA, int LDA, int LDB>
struct Ring {
  using T = Tile<BM>;
  static constexpr int STAGES = EA <= 1 ? T::STAGES : T::STAGES_WIDE;
  static constexpr int A_TILE = BM * LDA;                // one step's A tile
  static constexpr int A_BYTES = EA == 0 ? 0 : A_TILE;   // ... in a stage
  static constexpr int STAGE = A_BYTES + T::BN * LDB;
  static constexpr int SMEM = T::GROUPS * STAGES * STAGE;

  static __device__ __forceinline__ void group_sync(int group) {
    if constexpr (T::GROUP_THREADS == 32) {
      __syncwarp();
    } else if constexpr (T::GROUPS == 1) {
      __syncthreads();
    } else {  // named barrier 1 + group, for the group's threads only; the
              // ids are constants, so the CTA reserves 3 barriers, not 16
      static_assert(T::GROUPS == 2, "one named barrier per group");
      if (group == 0)
        asm volatile("bar.sync 1, %0;\n" ::"n"(T::GROUP_THREADS) : "memory");
      else
        asm volatile("bar.sync 2, %0;\n" ::"n"(T::GROUP_THREADS) : "memory");
    }
  }

  // Walk the group's share of this split's K steps, calling
  // consume(a_tile, b_stage) once per step in K order with the step's
  // tiles complete in shared memory. prologue() runs once, by every thread,
  // after the first STAGES - 1 stages are issued and before the first is
  // consumed (with EA = 0 it writes the resident A, `A`). Every thread of
  // the CTA must call it.
  template <typename Consume, typename Prologue>
  static __device__ __forceinline__ void run(const void* A, const int8_t* Bt,
                                             int M, int N, int K, int m0,
                                             int n0, bool vec,
                                             Consume&& consume,
                                             Prologue&& prologue) {
    constexpr int S = STAGES, GT = T::GROUP_THREADS;
    const int group = threadIdx.x / GT, tid = threadIdx.x % GT;
    char* smem = ring_smem() + group * S * STAGE;
    const char* a = static_cast<const char*>(A);
    const char* b = reinterpret_cast<const char*>(Bt);
    // the split's steps [k0, k1), then the group's share of them
    const long long steps = (K + BK - 1) / BK;
    const long long k0 = blockIdx.z * steps / gridDim.z;
    const long long k1 = (blockIdx.z + 1) * steps / gridDim.z;
    const int kt0 = static_cast<int>(k0 + (k1 - k0) * group / T::GROUPS);
    const int kt1 = static_cast<int>(k0 + (k1 - k0) * (group + 1) / T::GROUPS);
    const auto load = [&](int stage, int kt) {
      char* st = smem + stage * STAGE;
      if constexpr (EA > 0)
        load_tile<BM, BK * EA, LDA, GT>(st, a, m0, M, kt * BK * EA, K * EA, vec, tid);
      load_tile<T::BN, BK, LDB, GT>(st + A_BYTES, b, n0, N, kt * BK, K, vec, tid);
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (kt0 + s < kt1) load(s, kt0 + s);
      cp_async_commit();
    }
    prologue();
    int stage = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      cp_async_wait<S - 2>();  // step kt has landed (this thread's copies)
      group_sync(group);       // ... the group's; step kt-1 is consumed
      if (kt + S - 1 < kt1) load((stage + S - 1) % S, kt + S - 1);
      cp_async_commit();
      const char* st = smem + stage * STAGE;
      consume(EA == 0 ? a + (kt - k0) * A_TILE : st, st + A_BYTES);
      stage = (stage + 1) % S;
    }
    cp_async_wait<0>();
    __syncthreads();  // every group is done with its ring
  }

  template <typename Consume>
  static __device__ __forceinline__ void run(const void* A, const int8_t* Bt,
                                             int M, int N, int K, int m0,
                                             int n0, bool vec,
                                             Consume&& consume) {
    run(A, Bt, M, N, K, m0, n0, vec, consume, [] {});
  }
};

// The warps of a group of Tile<BM> over its m16n8 MMA fragments (every
// group covers the whole tile). The accumulators of a lane are
// acc[(i * NT + j) * 4 + c]: m16 tile i, n8 tile j, and c = 0, 1 at
// fragment row g, 2, 3 at g + 8, column 2t + (c & 1).
template <int BM>
struct WarpTile {
  static constexpr int BN = Tile<BM>::BN, WM = Tile<BM>::WM, WN = Tile<BM>::WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static constexpr int ACC = MT * NT * 4;
  int wm, wn, g, t;

  __device__ __forceinline__ WarpTile() {
    const int warp = (threadIdx.x >> 5) % (WM * WN), lane = threadIdx.x & 31;
    wm = warp / WN;
    wn = warp % WN;
    g = lane >> 2;
    t = lane & 3;
  }
  // tile row of m16 tile i, fragment row g (h = 0) or g + 8 (h = 1)
  __device__ __forceinline__ int row(int i, int h) const {
    return wm * (BM / WM) + i * 16 + g + 8 * h;
  }
  // tile column g of n8 tile j: the weight's row in the stage
  __device__ __forceinline__ int b_row(int j) const { return wn * (BN / WN) + j * 8 + g; }
  // tile column of n8 tile j, accumulator column e (0, 1)
  __device__ __forceinline__ int col(int j, int e) const {
    return wn * (BN / WN) + j * 8 + 2 * t + e;
  }
};

// The epilogue's store of an accumulator pair at columns col, col + 1 of
// one row: one 4- or 8-byte store where both columns exist and the pair is
// aligned (N even; col is even), else one value at a time. Rounds as
// from_f32 does, value by value.
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* c, int row, int col, int N,
                                           float y0, float y1) {
  OutT* p = c + static_cast<size_t>(row) * N + col;
  if (col + 1 < N && N % 2 == 0) {
    if constexpr (std::is_same<OutT, float>::value)
      *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
  } else {
    p[0] = from_f32<OutT>(y0);
    if (col + 1 < N) p[1] = from_f32<OutT>(y1);
  }
}

template <typename T>
__device__ __forceinline__ T add(T x, T y) {
  if constexpr (std::is_floating_point<T>::value)
    return __fadd_rn(x, y);  // float32: never contracted
  else
    return x + y;
}

// The tile's total after the mainloop: the groups' partials added in group
// order in shared memory, then the splits' through distributed shared memory
// in rank order — every thread of every CTA must call it. Returns 0 in a CTA
// that does not reduce its tile (it may exit), 1 in the reducing CTA (rank 0
// of the cluster) for threads outside group 0, 2 for the threads of group 0,
// whose `acc` then holds the total.
template <int BM, typename T, int N>
__device__ __forceinline__ int reduce(T (&acc)[N]) {
  namespace cg = cooperative_groups;
  using C = Tile<BM>;
  constexpr int GT = C::GROUP_THREADS;
  T* buf = reinterpret_cast<T*>(ring_smem());  // the rings are free
  const int group = threadIdx.x / GT, tid = threadIdx.x % GT;
  if constexpr (C::GROUPS > 1) {
    if (group > 0)
#pragma unroll
      for (int i = 0; i < N; ++i) buf[((group - 1) * N + i) * GT + tid] = acc[i];
    __syncthreads();
    if (group == 0)
      for (int q = 1; q < C::GROUPS; ++q)
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = add(acc[i], buf[((q - 1) * N + i) * GT + tid]);
    __syncthreads();
  }
  const bool holds = group == 0;
  if (gridDim.z == 1) return holds ? 2 : 1;
  cg::cluster_group cluster = cg::this_cluster();
  if (holds)
#pragma unroll
    for (int i = 0; i < N; ++i) buf[i * GT + tid] = acc[i];
  cluster.sync();
  // the splits of this tile: the cluster's CTAs at this x (a cluster may
  // also span x: the quantize-in kernel's CTAs that share A)
  const dim3 at = cluster.block_index(), dims = cluster.dim_blocks();
  const bool lead = at.z == 0;
  if (lead && holds) {
    for (unsigned z = 1; z < dims.z; ++z) {
      const T* peer = cluster.map_shared_rank(buf, at.x + dims.x * dims.y * z);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = add(acc[i], peer[i * GT + tid]);
    }
  }
  cluster.sync();  // the peers stay resident until rank 0 has read them
  return lead ? (holds ? 2 : 1) : 0;
}

// Launch `Kernel` (a Tile<BM> kernel) with `smem` bytes of dynamic shared
// memory (opting in past the default 48 KB, which also holds the static
// shared memory, to `smem_max`: a kernel whose smem varies by call opts in
// once to the most it may take) on the split grid, each tile's splits one
// cluster — with `share` > 1, `share` neighbouring tiles along N and their
// splits (grid.x a multiple of it); returns the launch's CUDA error.
template <int BM, auto Kernel, typename... Args>
inline int launch_upto(int smem, int smem_max, int share, dim3 grid,
                       cudaStream_t st, Args... args) {
  const unsigned size = grid.z * share;
  if (size > MAX_SPLITS || smem > smem_max || grid.x % share != 0 || grid.y == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (smem > 40 * 1024)
    e = set_once<Kernel>(cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (e == cudaSuccess && size > 8)
    e = set_once<Kernel>(cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (size == 1) {
    Kernel<<<grid, Tile<BM>::THREADS, smem, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Tile<BM>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, Kernel, args...));
}

template <int BM, auto Kernel, typename... Args>
inline int launch(int smem, dim3 grid, cudaStream_t st, Args... args) {
  return launch_upto<BM, Kernel>(smem, smem, 1, grid, st, args...);
}

// How many clusters of `splits` CTAs (CTAs at splits = 1) of `Kernel`, as
// launch() launches it, the current device keeps resident at once, into
// *out; returns the CUDA error.
template <int BM, auto Kernel>
inline int max_resident(int smem, int splits, int* out) {
  if (splits < 1 || splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && smem > 40 * 1024)
    e = set_once<Kernel>(cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && splits > 8)
    e = set_once<Kernel>(cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits == 1) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, Tile<BM>::THREADS, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *out = per_sm * sms;
    return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(Tile<BM>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, Kernel, &cfg));
}

}  // namespace gemm
}  // namespace repro
