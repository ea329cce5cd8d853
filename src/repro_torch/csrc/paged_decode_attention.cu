// Paged decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attention/kernel.py
//   paged_decode_attention_pallas (body _paged_decode_kernel).
// Plain version: repro_torch/kernels/decode_attention/ops.py
//   paged_decode_attention_plain (dense gather + masked softmax).
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its live
// K and V pages once (2 * live_tokens * hd * sizeof(T)) and does 4 * G
// flops per element read, far below the ~295 flop/byte the card needs to
// be compute-bound.  So the design moves only the live bytes:
//   * one CTA per (row, kv head); it loads its own block-table row and
//     position and walks only the row's live blocks, 0 .. pos // bs (the
//     Pallas grid walks all nbt table entries of every row);
//   * the CTA is split into sub-warps of hd / VEC lanes, one token per
//     sub-warp per iteration, each lane issuing one 16-byte load of K and
//     one of V, so a warp keeps several tokens' loads in flight;
//   * each sub-warp keeps its own online-softmax state (fp32) for the G
//     query heads of the kv head, and the sub-warps are merged once in
//     shared memory at the end: no second pass, no atomics.
// Split-K over a row's pages (for few rows with very long caches) and a
// TMA page ring are later work.
//
// Exactness contract with the reference: a -1 table entry is never read
// as live (the null block 0 holds other rows' garbage), positions past
// `pos` and negative positions are masked, and a row with no valid key
// (e.g. a decode_mask'ed row whose table is all -1) outputs 0.  Walking
// only logical blocks 0 .. pos // bs relies on the paged-cache invariant
// that logical block j holds positions in [j*bs, (j+1)*bs) or -1; blocks
// past it can hold only positions > pos, which the reference masks.

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kDecodeThreads = 128;
constexpr int kMaxG = 8;   // query heads per kv head handled by one CTA

template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ kv_pos_pool,
                    const int* __restrict__ block_tab,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    int H, int K, int G, int bs, int nbt, int window,
                    float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPT = HD / VEC;                 // lanes per token
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0,
                "head dim does not map onto sub-warps");
  constexpr int NSUB = kDecodeThreads / LPT;    // tokens per iteration

  __shared__ float s_m[NSUB][kMaxG];
  __shared__ float s_l[NSUB][kMaxG];
  __shared__ float s_acc[NSUB][kMaxG][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid / LPT;
  const int lane = tid % LPT;
  const int pos = pos_arr[b];
  const int n_blk = pos < 0 ? 0 : min(pos / bs + 1, nbt);
  const int n_tok = n_blk * bs;
  const int* tab = block_tab + static_cast<size_t>(b) * nbt;

  float qr[kMaxG][VEC];
  float m[kMaxG], l[kMaxG], acc[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = 0.f;
    }
    if (g < G) {
      const T* qp = q + (static_cast<size_t>(b) * H + kvh * G + g) * HD;
      Vec16<T>::load(qp + lane * VEC, qr[g]);
    }
  }

  // Every thread runs the same trip count, so the sub-warp shuffles below
  // are always executed by the whole warp.
  for (int base = 0; base < n_tok; base += NSUB) {
    const int t = base + sub;
    const int phys = t < n_tok ? tab[t / bs] : -1;
    const bool live = phys >= 0;
    const int off = live ? t % bs : 0;
    const int kp = live ? kv_pos_pool[static_cast<size_t>(phys) * bs + off]
                        : -1;
    const bool valid = kp >= 0 && kp <= pos &&
                       (window <= 0 || pos - kp < window);
    // a masked slot still loads (from the null block when unset) so the
    // control flow stays uniform; its score is never used
    const size_t row =
        (static_cast<size_t>(live ? phys : 0) * bs + off) * K + kvh;
    float kv[VEC], vv[VEC];
    Vec16<T>::load(k_pool + row * HD + lane * VEC, kv);
    Vec16<T>::load(v_pool + row * HD + lane * VEC, vv);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d += qr[g][i] * kv[i];
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (valid) {
        const float s = d * scale;
        const float mn = fmaxf(m[g], s);
        const float a = expf(m[g] - mn);
        const float p = expf(s - mn);
        l[g] = l[g] * a + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * a + p * vv[i];
        m[g] = mn;
      }
    }
  }

  // merge the sub-warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      s_m[sub][g] = m[g];
      s_l[sub][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[sub][g][lane * VEC + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kDecodeThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
    for (int s = 0; s < NSUB; ++s) mx = fmaxf(mx, s_m[s][g]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < NSUB; ++s) {
      const float w = s_l[s][g] > 0.f ? expf(s_m[s][g] - mx) : 0.f;
      lsum += s_l[s][g] * w;
      o += s_acc[s][g][d] * w;
    }
    store(out + (static_cast<size_t>(b) * H + kvh * G + g) * HD + d,
          lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch_typed(const void* q, const void* k_pool,
                         const void* v_pool, const int* kv_pos_pool,
                         const int* block_tab, const int* pos, void* out,
                         int B, int H, int K, int bs, int nbt, int window,
                         float scale, cudaStream_t stream) {
  const dim3 grid(K, B);
  paged_decode_kernel<T, HD><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), kv_pos_pool, block_tab, pos,
      static_cast<T*>(out), H, K, H / K, bs, nbt, window, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k_pool,
                      const void* v_pool, const int* kv_pos_pool,
                      const int* block_tab, const int* pos, void* out, int B,
                      int H, int K, int bs, int nbt, int window, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_typed<T, 64>(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                 pos, out, B, H, K, bs, nbt, window, scale,
                                 stream);
    case 128:
      return launch_typed<T, 128>(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                  pos, out, B, H, K, bs, nbt, window, scale,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* pos, void* out,
    int B, int H, int K, int hd, int bs, int nbt, int window, float scale,
    int dtype, cudaStream_t stream) {
  using namespace repro_torch;
  if (K <= 0 || H % K != 0 || H / K > kMaxG || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, kv_pos_pool,
                                    block_tab, pos, out, B, H, K, bs, nbt,
                                    window, scale, stream);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, q, k_pool, v_pool, kv_pos_pool, block_tab,
                            pos, out, B, H, K, bs, nbt, window, scale,
                            stream);
  return cudaErrorInvalidValue;
}
