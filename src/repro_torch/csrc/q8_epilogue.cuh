// The quantize-out epilogue the two GEMMs share (qmatmul_w8a8.cu,
// qmatmul_w8a16.cu): the GEMM's own float32 result y, re-quantized per row
// by the quantize_act formula — scale = max(amax, 1e-8) / qmax and
// q = clip(rint(y / scale), -qmax - 1, qmax), both by IEEE division, qmax =
// 2^(bits-1) - 1 — in the GEMM's one launch.
//
// A row's scale needs the max |y| over the whole row, which no CTA holds:
// at the decode tile the gate/up projection (N = 4864) has 304 N tiles of
// 16 x 16. The max is order-free (|y| >= 0, and non-negative floats order
// as unsigned integers, so atomicMax on the bits is fmaxf's), so every
// route is bit-equal to the GEMM to float32 followed by quantize_act.
// kernels/gemm_plan.py picks one of two routes from the shape and the
// card's residency (GemmPlan.q8_route):
//
//  * RESIDENT — every CTA quantizes its own tile from its registers. Where
//    the card can keep every tile of the launch resident at once (CTAs, or
//    clusters under split-K; gemm_plan.q8_plan may take a wider tile for
//    that):
//      1. each cluster keeps blockIdx's tile; where the route is forced on
//         a launch with more tiles than that (but no more N tiles an M tile
//         than fit), clusters take their tiles from a ticket counter
//         instead, M tile by M tile (take_tile);
//      2. after the mainloop the CTA that holds the tile's sum (rank 0 of
//         its cluster) raises its rows' max in the scratch (atomicMax) and
//         arrives on its M tile's counter (arrive);
//      3. it waits (acquire loads, __nanosleep backoff) until every N tile
//         of the M tile has arrived, takes the rows' scales (scales), and
//         quantizes the y it kept in registers; the M tile's first N tile
//         writes the scales;
//      4. a departure counter finds the launch's last CTA, which zeroes the
//         rows' max, the counters and the ticket (depart), so the scratch is
//         zero between calls on one stream and no call clears it (a CUDA
//         graph may capture the launch as it is).
//    No float32 y leaves the chip.
//  * WORKSPACE — where residency is too small (qwen2's vocabulary, N =
//    151936: 9,496 N tiles at the decode tile). Each CTA that holds a sum
//    writes its tile's y to a float32 workspace, raises the rows' max and
//    arrives; the first n_tiles - `waiters` to arrive leave, and the last
//    `waiters` (GemmPlan.q8_waiters: at most 32, fewer than the card keeps
//    resident) wait for the M tile's last arrival and each quantizes its
//    part of the M tile's rows from the workspace (workspace_finish). With
//    more than one M tile the tiles go out by ticket, M tile by M tile.
//    The plan takes this route wherever no tile's launch is resident at
//    once: qwen2's vocabulary, the JAX bench's 4096^3.
// In both routes no CTA quantizes an M tile's rows alone: every CTA of the
// M tile (RESIDENT) or its last `waiters` (WORKSPACE) share them, and the
// steps 2-4 (arrive, scales, depart) are the same code.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "gemm_mainloop.cuh"

namespace repro {
namespace q8 {

enum Route : int { NONE = 0, RESIDENT = 1, WORKSPACE = 2 };

struct Args {
  float* y;          // WORKSPACE: [M, N] float32 workspace; else null
  unsigned* amax;    // [M] running max |y| as float bits, 0 between calls
  unsigned* count;   // [m tiles] arrivals per M tile, 0 between calls
  unsigned* ticket;  // [2] tickets taken, CTAs departed; 0 between calls
  int8_t* q;         // [M, N] int8 out
  float* s;          // [M] float32 scale out
  float qmax;        // 2^(bits-1) - 1
  int ticketed;      // tiles by ticket, M tile by M tile (else blockIdx)
  unsigned waiters;  // WORKSPACE: the last arrivals of an M tile that quantize it
};

// The tile of this CTA's cluster where the plan hands tiles out by ticket
// (`ticketed`, GemmPlan.q8_ticketed): ticket t is N tile t % n_tiles of M
// tile t / n_tiles. Rank 0 of the cluster takes one ticket; the K splits
// that only publish read it from rank 0's shared memory after the cluster
// barrier. Elsewhere the CTA keeps blockIdx's (mt, nt). Every thread of
// every CTA must call it.
__device__ __forceinline__ void take_tile(const Args& a, int n_tiles, int& mt,
                                          int& nt) {
  namespace cg = cooperative_groups;
  __shared__ unsigned t;
  unsigned v;
  if (!a.ticketed) return;
  if (gridDim.z == 1) {
    if (threadIdx.x == 0) t = atomicAdd(a.ticket, 1u);
    __syncthreads();
    v = t;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (cluster.block_rank() == 0 && threadIdx.x == 0) t = atomicAdd(a.ticket, 1u);
    cluster.sync();
    v = *cluster.map_shared_rank(&t, 0);  // rank 0 stays resident: it holds the sum
  }
  mt = static_cast<int>(v / n_tiles);
  nt = static_cast<int>(v % n_tiles);
}

// Wait until *p >= want with acquire loads at GPU scope. No-hang argument:
// the CTAs of an M tile that wait (RESIDENT: all its N tiles; WORKSPACE:
// its last `waiters` arrivals) are never more than the clusters the card
// keeps resident (gemm_plan), and wait only on CTAs of the same M tile.
// Where every tile of the launch is resident at once (RESIDENT without
// tickets), or the launch has one M tile (WORKSPACE without tickets), the
// CTAs waited on can always be scheduled. Elsewhere a cluster holds a
// ticket only while it runs, and tickets go out M tile by M tile. Take the
// lowest M tile that is incomplete. If all its tickets are taken, its
// clusters are resident or done, and the resident ones arrive: no arrival
// waits on anything. If some are not, no ticket of a later M tile is out,
// so every waiting CTA belongs to this M tile: fewer waiting clusters than
// the card keeps resident, so a slot frees and the next ticket is taken.
// (A waiting rank 0 whose K splits have left takes less than a cluster.)
// The argument holds while no other launch that waits on its own CTAs
// holds the card's slots. A wait that outlasts 2^26 polls (seconds; the
// arrivals land in microseconds) traps — a fault reported at the next
// synchronize, never a hang.
__device__ __forceinline__ void wait_at_least(const unsigned* p, unsigned want) {
  unsigned ns = 32;
  for (uint32_t polls = 0;; ++polls) {
    unsigned v;
    asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    if (v >= want) return;
    if (polls == (1u << 26)) __trap();
    __nanosleep(ns);
    if (ns < 128) ns *= 2;
  }
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Steps 2-3 of both routes, after the threads that hold the tile's y have
// raised its rows' max in the CTA's shared `smax` [BM] (zeroed before the
// mainloop): raise the M tile's rows' max in the scratch and arrive on its
// counter (release: the maxima — and on the WORKSPACE route this CTA's y —
// before the arrival; acquire: the last to arrive, which does not wait,
// sees the others'). Returns the arrival's order, 0 ... n_tiles - 1.
// Every thread of the reducing CTA must call it.
template <int BM>
__device__ unsigned arrive(const Args& a, const unsigned* smax, int mt, int M) {
  __shared__ unsigned order;
  const int tid = threadIdx.x, m0 = mt * BM;
  __syncthreads();
  if (tid < BM && m0 + tid < M) atomicMax(&a.amax[m0 + tid], smax[tid]);
  __syncthreads();
  if (tid == 0) order = atom_add_acq_rel(&a.count[mt], 1u);
  __syncthreads();
  return order;
}

// Wait until every N tile of the M tile has arrived (acquire; the last to
// arrive does not wait) and take the rows' scales into shared memory;
// `write_s`: this CTA also writes them out. Every thread of the reducing
// CTA must call it.
template <int BM>
__device__ const float* scales(const Args& a, int mt, int M, unsigned order,
                               bool write_s) {
  __shared__ float scale[BM];
  const int tid = threadIdx.x, m0 = mt * BM;
  const unsigned n_tiles = gridDim.x;
  if (tid == 0 && order != n_tiles - 1) wait_at_least(&a.count[mt], n_tiles);
  __syncthreads();
  if (tid < BM) {
    const bool row = m0 + tid < M;
    const float sc = absmax_scale(row ? __uint_as_float(__ldcg(&a.amax[m0 + tid])) : 0.f,
                                  a.qmax);
    scale[tid] = sc;
    if (row && write_s) a.s[m0 + tid] = sc;
  }
  __syncthreads();
  return scale;
}

// Step 4 of both routes, after the CTA has read the scratch and issued its
// stores: depart (acq_rel: this CTA's reads of the scratch before its
// departure); the launch's last CTA to depart zeroes the rows' max, the
// counters and the ticket, so the scratch is zero between calls on one
// stream and no call clears it. Every thread of the reducing CTA must call
// it.
__device__ __forceinline__ void depart(const Args& a, int M) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const unsigned m_tiles = gridDim.y;
  __syncthreads();
  if (tid == 0) last = atom_add_acq_rel(&a.ticket[1], 1u) == gridDim.x * m_tiles - 1;
  __syncthreads();
  if (last) {
    for (int i = tid; i < M; i += blockDim.x) a.amax[i] = 0u;
    for (int i = tid; i < static_cast<int>(m_tiles); i += blockDim.x) a.count[i] = 0u;
    if (tid == 0) a.ticket[0] = a.ticket[1] = 0u;
  }
}

// An accumulator pair at columns col, col + 1 of one row, quantized: one
// 2-byte store where both columns exist and N is even, else one at a time.
__device__ __forceinline__ void store_q_pair(const Args& a, int row, int col,
                                             int N, float y0, float y1,
                                             float scale) {
  const float lo = -a.qmax - 1.f;
  int8_t* p = a.q + static_cast<size_t>(row) * N + col;
  const int8_t q0 = quantize_one(y0, scale, lo, a.qmax);
  if (col + 1 < N && N % 2 == 0) {
    *reinterpret_cast<char2*>(p) = make_char2(q0, quantize_one(y1, scale, lo, a.qmax));
  } else {
    p[0] = q0;
    if (col + 1 < N) p[1] = quantize_one(y1, scale, lo, a.qmax);
  }
}

// WORKSPACE steps 2-4, after the threads that hold the tile's y have
// written it to `a.y` and raised its rows' max in `smax`. The first
// n_tiles - waiters CTAs to arrive leave; the last `waiters` wait for the
// M tile's last arrival and each quantizes its part of the M tile's rows x
// N values from the workspace (quantize16's exact filter, four values at a
// time where N allows). Every thread of the reducing CTA must call it.
template <int BM>
__device__ void workspace_finish(const Args& a, const unsigned* smax, int mt,
                                 int M, int N) {
  const unsigned n_tiles = gridDim.x, order = arrive<BM>(a, smax, mt, M);
  const unsigned first = n_tiles - a.waiters;  // the first waiter's order
  if (order < first) {
    depart(a, M);
    return;
  }
  const float* scale = scales<BM>(a, mt, M, order, order == first);
  const int tid = threadIdx.x, m0 = mt * BM, rows = min(BM, M - m0);
  const unsigned part = order - first, parts = a.waiters;
  const float lo = -a.qmax - 1.f, hi = a.qmax;
  const size_t base = static_cast<size_t>(m0) * N;
  if (N % 4 == 0) {
    constexpr int UNROLL = 4;
    const int n4 = N / 4, total = rows * n4;
    const int i0 = static_cast<int>(static_cast<long long>(total) * part / parts);
    const int i1 = static_cast<int>(static_cast<long long>(total) * (part + 1) / parts);
    const uint4* y4 = reinterpret_cast<const uint4*>(a.y + base);
    uint32_t* q4 = reinterpret_cast<uint32_t*>(a.q + base);
    for (int ib = i0 + tid; ib < i1; ib += UNROLL * blockDim.x) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = ib + u * blockDim.x;
        if (i < i1) v[u] = __ldcg(y4 + i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = ib + u * blockDim.x;
        if (i < i1) {
          const float sc = scale[i / n4];
          q4[i] = quantize16<float>(v[u], sc, quantize_rcp(sc), lo, hi).x;
        }
      }
    }
  } else {
    const int total = rows * N;
    const int i1 = static_cast<int>(static_cast<long long>(total) * (part + 1) / parts);
    for (int i = static_cast<int>(static_cast<long long>(total) * part / parts) + tid; i < i1;
         i += blockDim.x)
      a.q[base + i] = quantize_one(__ldcg(a.y + base + i), scale[i / N], lo, hi);
  }
  depart(a, M);
}

// A quantize-out call as the host passes it (route NONE: a plain GEMM).
struct Call {
  int route = NONE;
  int qmax = 127;
  int ticketed = 0;
  int waiters = 0;          // WORKSPACE: the CTAs of an M tile that quantize it
  void* y = nullptr;        // WORKSPACE: [M, N] float32
  void* scratch = nullptr;  // uint32 [M + m tiles + 2], zero on entry, left zero
  void* q = nullptr;
  void* s = nullptr;

  // The kernel's operands at BM-row tiles: the scratch is the rows' max
  // [M], one counter per M tile, then the ticket and departure counters.
  Args args(int M, int BM) const {
    unsigned* amax = static_cast<unsigned*>(scratch);
    unsigned* count = amax + M;
    return Args{static_cast<float*>(y), amax, count, count + (M + BM - 1) / BM,
                static_cast<int8_t*>(q), static_cast<float*>(s),
                static_cast<float>(qmax), ticketed, static_cast<unsigned>(waiters)};
  }
};

// Launch the RESIDENT or WORKSPACE instantiation of a Tile<BM> GEMM on its
// tile grid (N tiles, M tiles, splits), each tile's K splits one cluster.
template <int BM, auto Resident, auto Workspace, typename... A>
inline int launch(const Call& c, int smem, dim3 grid, cudaStream_t st, A... args) {
  if (c.route == RESIDENT) return gemm::launch<BM, Resident>(smem, grid, st, args...);
  const unsigned n_tiles = grid.x;
  if (c.route != WORKSPACE || c.waiters < 1 || static_cast<unsigned>(c.waiters) > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  return gemm::launch<BM, Workspace>(smem, grid, st, args...);
}

// The clusters of `splits` CTAs (CTAs at splits = 1) of a Tile<BM> GEMM's
// quantize-out instantiations that the current device keeps resident at
// once — the fewer of the two routes' kernels — into *out: gemm_plan's
// residency. Returns the CUDA error.
template <int BM, auto Resident, auto Workspace>
inline int residency(int smem, int splits, int* out) {
  int r = 0, w = 0;
  int e = gemm::max_resident<BM, Resident>(smem, splits, &r);
  if (e == 0) e = gemm::max_resident<BM, Workspace>(smem, splits, &w);
  *out = r < w ? r : w;
  return e;
}

}  // namespace q8
}  // namespace repro
