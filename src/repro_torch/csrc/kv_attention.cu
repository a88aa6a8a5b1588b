// Single-token decode attention over an int8 KV cache (the unfused decode).
//
// Replaces: kv_attention_pallas (src/repro/kernels/kv_attention/kernel.py:95).
// Computes, for each batch row b (one block each): online softmax over the S
// cache positions with float32 m, l, acc; scores (q_h . (k_t * ks_t)) /
// sqrt(hd); a position whose K scale is 0 is masked with -1e30 (never -inf:
// a fully masked row with zero V scales gives exactly 0); GQA by h / group;
// out = (acc - e) / max(l, 1e-30) cast to q's dtype, where e = sum_t p_t *
// v_err[t] with the optional V error means v_err [B, S, Hkv] (the V bias
// correction; the TPU kernel lacks it and the JAX op computes it on XLA) and
// 0 without them. Any S: the last tile is masked, nothing is padded.
// Bound on the H100: bytes. The int8 cache and its scales are read once,
// B*S*Hkv*(hd+4)*2 bytes (+ 4 per position and head with v_err): 1.1 MB at
// the main path's decode shape (0.3 us at 3.35 TB/s), 553 MB at the JAX
// bench's long context (B=8 S=32768 Hkv=8 hd=128: 165 us), against
// ~4*B*Hq*S*hd float32 operations (~16 a cache byte at GQA 4).
// Design (simple and right first): the attention body of
// decode_attention.cuh, shared with fused_decode.cu, one block of 256
// threads per batch row. Shared memory grows with Hq*hd and Hkv*hd (177 KB
// at Hq=32 Hkv=8 hd=128): past 48 KB the kernel opts into up to 227 KB.
// B blocks leave most of the 132 SMs idle (8 of 132 at decode); splitting S
// across blocks (flash-decoding) is a later PR, for both kernels together.
#include "decode_attention.cuh"

namespace {

using namespace repro::attn;

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_attention_kernel(const T* __restrict__ q, const int8_t* kq, const float* ks,
                    const int8_t* vq, const float* vs, const float* ve,
                    T* __restrict__ out, int S, int Hq, int Hkv, int hd,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, HD = Hq * hd;
  const Smem sm = carve(smem_raw, Hq, Hkv, hd, ve != nullptr);
  const size_t pos0 = static_cast<size_t>(b) * S;
  attend<T>(sm, q + static_cast<size_t>(b) * HD, kq + pos0 * Hkv * hd,
            ks + pos0 * Hkv, vq + pos0 * Hkv * hd, vs + pos0 * Hkv,
            ve == nullptr ? nullptr : ve + pos0 * Hkv, nullptr, S, Hq, Hkv, hd,
            scale);
  finish<T>(sm, out + static_cast<size_t>(b) * HD, Hq, hd);
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* ve, void* out, int B, int S, int Hq,
           int Hkv, int hd, float scale, cudaStream_t st) {
  const size_t bytes = smem_bytes(Hq, Hkv, hd, ve != nullptr);
  const cudaError_t e = reserve_smem(kv_attention_kernel<T>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_attention_kernel<T><<<B, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(ve),
      static_cast<T*>(out), S, Hq, Hkv, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory the attention body needs, in bytes (the wrappers
// refuse a shape past the card's 227 KB before they launch).
extern "C" long long repro_decode_attention_smem(int Hq, int Hkv, int hd,
                                                 int with_err) {
  return static_cast<long long>(smem_bytes(Hq, Hkv, hd, with_err != 0));
}

// q [B, Hq, hd] and out [B, Hq, hd] float32 (is_bf16 == 0) or bfloat16;
// kq / vq [B, S, Hkv, hd] int8; ks / vs [B, S, Hkv] float32; ve [B, S, Hkv]
// float32 or NULL. All contiguous; kq / vq 4-byte aligned.
extern "C" int repro_kv_attention(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* ve,
                                  void* out, int B, int S, int Hq, int Hkv,
                                  int hd, float scale, int is_bf16,
                                  void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, ve, out, B, S, Hq, Hkv, hd,
                                 scale, st);
  return launch<float>(q, kq, ks, vq, vs, ve, out, B, S, Hq, Hkv, hd, scale, st);
}
