// Dense decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attention/kernel.py
//   decode_attention_pallas (body _decode_kernel).
// Plain version: repro_torch/kernels/decode_attention/ops.py
//   decode_attention_plain (einsum scores + masked softmax).
//
// One query token per row over the row's dense (B, S, K, hd) cache, which
// on the padded plane is a max_len row per slot and, for sliding-window
// models, a ring of S = min(window, max_len) entries indexed pos % S.
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads each live
// K and V entry once (2 * hd * sizeof(T) bytes) and does 4 * G flops per
// element read, far below the ~295 flop/byte the card needs to be
// compute-bound.  So the time is set by how many bytes are in flight
// across the card, and the design keeps many in flight while moving only
// the bytes it must:
//   * split-K over the cache: the grid is (kv head, row, split); split s
//     of a row takes the cache indices [s * per, (s + 1) * per) of the
//     walk below, per = a whole number of 16-index units, so a long row
//     is read by many CTAs at once (one CTA per (kv head, row) would give
//     128 CTAs at the padded plane's 4 rows × 32 kv heads, the
//     1,088-token row behind one of them).  The split count comes
//     from the shapes and the card alone (`decode_splits` of ops.py on
//     ceil(S / 16) units: 9 splits of 128 indices at 4 × 32 × 1088 on 132
//     SMs), never from `pos`.  A split past the row's walk exits with
//     l = 0; the splits cut a wrapped ring or a window anywhere, since
//     every index is masked on its own kv_pos;
//   * the G query heads of a kv head share the CTA, so each K/V entry is
//     read once for all G heads (the Pallas grid is (B*K, S / block_kv)
//     with the softmax state carried across grid steps);
//   * the CTA is split into sub-warps of hd / VEC lanes, each lane issuing
//     16-byte loads; every sub-warp takes UNROLL tokens per iteration and
//     issues all their loads before the arithmetic, so a warp keeps
//     several tokens in flight;
//   * a masked entry (empty, past pos, or outside the window) is never
//     loaded: its kv_pos is read and its K/V bytes are skipped;
//   * each sub-warp keeps its own fp32 online-softmax state for the G
//     heads; the sub-warps are merged once at the end through shared
//     memory, one head at a time, into the output (one split) or the
//     split's fp32 partial (m, l, acc) in scratch the wrapper allocates;
//     paged decode's merge kernel (paged_decode_attention.cu, through
//     launch_decode_merge) then combines the splits by log-sum-exp: no
//     atomics.
//
// What holds it back now: at 128 indices a split each CTA's fixed cost
// (q loads, the sub-warp merge, the partial's store) and the merge
// kernel's second launch weigh against about 64 KB of K/V per CTA
// (PERF.md has the times).
//
// The splits together walk indices 0 .. min(S, pos + 1) - 1.  That is exact
// (equal to walking all S) under the dense-cache invariant that index i
// holds -1 or a position p with p % S == i: then for pos < S every index
// past pos holds -1 or a position > pos, which the reference masks; for
// pos >= S (a wrapped ring) the loop walks all S.  Every engine path keeps
// the invariant (attn_decode / attn_extend write position p at p % S,
// cache_join copies a whole row); a cache with arbitrary kv_pos does not,
// and is held against the plain version only.
//
// Masks, as the reference: valid iff 0 <= kv_pos <= pos and, with
// window > 0, pos - kv_pos < window.  A row with no valid key gives 0.
// Any S is taken (the Pallas kernel needs S % block_kv == 0).

#include <type_traits>

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kDenseThreads = 128;
constexpr int kDenseMaxG = 8;    // query heads per kv head one CTA handles
constexpr int kSplitUnit = 16;   // cache indices per unit of a split

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kDenseThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int H, int S, int K, int G,
                    int per, int window, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPT = HD / VEC;                 // lanes per token
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0,
                "head dim does not map onto sub-warps");
  constexpr int NSUB = kDenseThreads / LPT;     // sub-warps per CTA
  constexpr int UNROLL = GMAX == 1 ? 8 : GMAX == 2 ? 4 : 2;
  constexpr int STEP = NSUB * UNROLL;           // tokens per iteration

  __shared__ float s_m[NSUB][GMAX];
  __shared__ float s_l[NSUB][GMAX];
  __shared__ float s_acc[NSUB][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int sub = tid / LPT;
  const int lane = tid % LPT;
  const int pos = pos_arr[b];
  const int n = pos < 0 ? 0 : min(S, pos + 1);
  const int t_beg = split * per;                // this split's indices
  const int t_end = min(n, t_beg + per);
  const int* row_pos = kv_pos + static_cast<size_t>(b) * S;
  // element offset of (row b, index 0, kv head kvh, this lane's slice)
  const size_t base = (static_cast<size_t>(b) * S * K + kvh) * HD + lane * VEC;
  const size_t stride = static_cast<size_t>(K) * HD;   // one cache index

  float qr[GMAX][VEC];
  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = 0.f;
    }
    if (g < G && t_end > t_beg) {
      const T* qp = q + (static_cast<size_t>(b) * H + kvh * G + g) * HD;
      Vec16<T>::load(qp + lane * VEC, qr[g]);
    }
  }

  // Every thread runs the same trip count, so the sub-warp shuffles below
  // are always executed by the whole warp.
  for (int t0 = t_beg; t0 < t_end; t0 += STEP) {
    bool valid[UNROLL];
    uint4 kraw[UNROLL], vraw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * NSUB + sub;
      const int kp = t < t_end ? row_pos[t] : -1;
      valid[u] = kp >= 0 && kp <= pos && (window <= 0 || pos - kp < window);
      kraw[u] = make_uint4(0u, 0u, 0u, 0u);
      vraw[u] = kraw[u];
      if (valid[u]) {
        const size_t off = base + static_cast<size_t>(t) * stride;
        kraw[u] = *reinterpret_cast<const uint4*>(k_cache + off);
        vraw[u] = *reinterpret_cast<const uint4*>(v_cache + off);
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[UNROLL];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kv[VEC];
        widen<T>(kraw[u], kv);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qr[g][i] * kv[i];
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = d * scale;
        if (valid[u]) mx = fmaxf(mx, s[u]);
      }
      if (mx <= kNegInf) continue;              // no valid token this step
      const float mn = fmaxf(m[g], mx);
      const float a = expf(m[g] - mn);
      l[g] *= a;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= a;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!valid[u]) continue;
        const float p = expf(s[u] - mn);
        float vv[VEC];
        widen<T>(vraw[u], vv);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += p * vv[i];
      }
      m[g] = mn;
    }
  }

  // merge the sub-warps' partial softmax states, one head at a time, into
  // the output (one split) or this split's partial (m, l, acc)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      s_m[sub][g] = m[g];
      s_l[sub][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    __syncthreads();          // s_acc free (previous head consumed)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[sub][lane * VEC + i] = acc[g][i];
    __syncthreads();
    const size_t bh = static_cast<size_t>(b) * H + kvh * G + g;
    for (int d = tid; d < HD; d += kDenseThreads) {
      float mx = kNegInf;
      for (int s = 0; s < NSUB; ++s) mx = fmaxf(mx, s_m[s][g]);
      float lsum = 0.f, o = 0.f;
      for (int s = 0; s < NSUB; ++s) {
        const float w = s_l[s][g] > 0.f ? expf(s_m[s][g] - mx) : 0.f;
        lsum += s_l[s][g] * w;
        o += s_acc[s][d] * w;
      }
      if (n_split == 1) {
        store(out + bh * HD + d, lsum > 0.f ? o / lsum : 0.f);
      } else {
        const size_t ps = bh * n_split + split;
        part_acc[ps * HD + d] = o;
        if (d == 0) {
          part_ml[2 * ps] = mx;
          part_ml[2 * ps + 1] = lsum;
        }
      }
    }
  }
}

template <typename T, int HD, int GMAX>
cudaError_t launch_typed(const void* q, const void* k_cache,
                         const void* v_cache, const int* kv_pos,
                         const int* pos, void* out, float* part_ml,
                         float* part_acc, int B, int H, int S, int K,
                         int n_split, int window, float scale,
                         cudaStream_t stream) {
  const int units = (S + kSplitUnit - 1) / kSplitUnit;
  const int per = (units + n_split - 1) / n_split * kSplitUnit;
  const dim3 grid(K, B, n_split);
  dense_decode_kernel<T, HD, GMAX><<<grid, kDenseThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), kv_pos, pos, static_cast<T*>(out),
      part_ml, part_acc, H, S, K, H / K, per, window, scale);
  if (n_split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_decode_merge(part_ml, part_acc, out, B * H, HD, n_split,
                               std::is_same<T, float>::value ? kFloat32
                                                             : kBFloat16,
                               stream);
  }
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_group(const void* q, const void* k_cache,
                         const void* v_cache, const int* kv_pos,
                         const int* pos, void* out, float* part_ml,
                         float* part_acc, int B, int H, int S, int K,
                         int n_split, int window, float scale,
                         cudaStream_t stream) {
#define REPRO_DENSE_CASE(GM)                                                 \
  return launch_typed<T, HD, GM>(q, k_cache, v_cache, kv_pos, pos, out,      \
                                 part_ml, part_acc, B, H, S, K, n_split,     \
                                 window, scale, stream)
  const int G = H / K;
  if (G <= 1) REPRO_DENSE_CASE(1);
  if (G <= 2) REPRO_DENSE_CASE(2);
  if (G <= 4) REPRO_DENSE_CASE(4);
  REPRO_DENSE_CASE(8);
#undef REPRO_DENSE_CASE
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k_cache,
                      const void* v_cache, const int* kv_pos, const int* pos,
                      void* out, float* part_ml, float* part_acc, int B,
                      int H, int S, int K, int n_split, int window,
                      float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_group<T, 64>(q, k_cache, v_cache, kv_pos, pos, out,
                                 part_ml, part_acc, B, H, S, K, n_split,
                                 window, scale, stream);
    case 128:
      return launch_group<T, 128>(q, k_cache, v_cache, kv_pos, pos, out,
                                  part_ml, part_acc, B, H, S, K, n_split,
                                  window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const int* kv_pos, const int* pos, void* out, float* part_ml,
    float* part_acc, int B, int H, int S, int K, int hd, int n_split,
    int window, float scale, int dtype, cudaStream_t stream) {
  using namespace repro_torch;
  if (K <= 0 || H % K != 0 || H / K > kDenseMaxG || S <= 0 || n_split <= 0 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  // every split must own at least one unit of indices
  const int units = (S + kSplitUnit - 1) / kSplitUnit;
  const int upers = (units + n_split - 1) / n_split;
  if (n_split > units || (n_split - 1) * upers >= units)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kv_pos, pos,
                                    out, part_ml, part_acc, B, H, S, K,
                                    n_split, window, scale, stream);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, q, k_cache, v_cache, kv_pos, pos, out,
                            part_ml, part_acc, B, H, S, K, n_split, window,
                            scale, stream);
  return cudaErrorInvalidValue;
}
