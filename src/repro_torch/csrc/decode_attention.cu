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
// compute-bound.  So the design moves only the bytes it must:
//   * one CTA per (kv head, row), the G query heads of the group in the
//     CTA, so each K/V entry is read once for all G heads (the Pallas grid
//     is (B*K, S / block_kv) with the softmax state carried across grid
//     steps; here the kv loop runs inside the CTA);
//   * the CTA is split into sub-warps of hd / VEC lanes, each lane issuing
//     16-byte loads; every sub-warp takes UNROLL tokens per iteration and
//     issues all their loads before the arithmetic, so a warp keeps
//     several tokens in flight;
//   * a masked entry (empty, past pos, or outside the window) is never
//     loaded: its kv_pos is read and its K/V bytes are skipped;
//   * each sub-warp keeps its own fp32 online-softmax state for the G
//     heads; the sub-warps are merged once at the end through shared
//     memory, one head at a time: no second pass, no atomics.
//
// The kv loop walks indices 0 .. min(S, pos + 1) - 1.  That is exact
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

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kDenseThreads = 256;
constexpr int kDenseMaxG = 8;    // query heads per kv head one CTA handles

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kDenseThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    int H, int S, int K, int G, int window, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPT = HD / VEC;                 // lanes per token
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0,
                "head dim does not map onto sub-warps");
  constexpr int NSUB = kDenseThreads / LPT;     // sub-warps per CTA
  constexpr int UNROLL = GMAX <= 2 ? 4 : 2;     // tokens per sub-warp step
  constexpr int STEP = NSUB * UNROLL;

  __shared__ float s_m[NSUB][GMAX];
  __shared__ float s_l[NSUB][GMAX];
  __shared__ float s_acc[NSUB][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid / LPT;
  const int lane = tid % LPT;
  const int pos = pos_arr[b];
  const int n = pos < 0 ? 0 : min(S, pos + 1);
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
    if (g < G) {
      const T* qp = q + (static_cast<size_t>(b) * H + kvh * G + g) * HD;
      Vec16<T>::load(qp + lane * VEC, qr[g]);
    }
  }

  // Every thread runs the same trip count, so the sub-warp shuffles below
  // are always executed by the whole warp.
  for (int t0 = 0; t0 < n; t0 += STEP) {
    bool valid[UNROLL];
    uint4 kraw[UNROLL], vraw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * NSUB + sub;
      const int kp = t < n ? row_pos[t] : -1;
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

  // merge the sub-warps' partial softmax states, one head at a time
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
    for (int d = tid; d < HD; d += kDenseThreads) {
      float mx = kNegInf;
      for (int s = 0; s < NSUB; ++s) mx = fmaxf(mx, s_m[s][g]);
      float lsum = 0.f, o = 0.f;
      for (int s = 0; s < NSUB; ++s) {
        const float w = s_l[s][g] > 0.f ? expf(s_m[s][g] - mx) : 0.f;
        lsum += s_l[s][g] * w;
        o += s_acc[s][d] * w;
      }
      store(out + (static_cast<size_t>(b) * H + kvh * G + g) * HD + d,
            lsum > 0.f ? o / lsum : 0.f);
    }
  }
}

template <typename T, int HD, int GMAX>
cudaError_t launch_typed(const void* q, const void* k_cache,
                         const void* v_cache, const int* kv_pos,
                         const int* pos, void* out, int B, int H, int S,
                         int K, int window, float scale,
                         cudaStream_t stream) {
  const dim3 grid(K, B);
  dense_decode_kernel<T, HD, GMAX><<<grid, kDenseThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), kv_pos, pos, static_cast<T*>(out), H,
      S, K, H / K, window, scale);
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_group(const void* q, const void* k_cache,
                         const void* v_cache, const int* kv_pos,
                         const int* pos, void* out, int B, int H, int S,
                         int K, int window, float scale,
                         cudaStream_t stream) {
  const int G = H / K;
  if (G <= 1)
    return launch_typed<T, HD, 1>(q, k_cache, v_cache, kv_pos, pos, out, B,
                                  H, S, K, window, scale, stream);
  if (G <= 2)
    return launch_typed<T, HD, 2>(q, k_cache, v_cache, kv_pos, pos, out, B,
                                  H, S, K, window, scale, stream);
  if (G <= 4)
    return launch_typed<T, HD, 4>(q, k_cache, v_cache, kv_pos, pos, out, B,
                                  H, S, K, window, scale, stream);
  return launch_typed<T, HD, 8>(q, k_cache, v_cache, kv_pos, pos, out, B, H,
                                S, K, window, scale, stream);
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k_cache,
                      const void* v_cache, const int* kv_pos, const int* pos,
                      void* out, int B, int H, int S, int K, int window,
                      float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_group<T, 64>(q, k_cache, v_cache, kv_pos, pos, out, B, H,
                                 S, K, window, scale, stream);
    case 128:
      return launch_group<T, 128>(q, k_cache, v_cache, kv_pos, pos, out, B,
                                  H, S, K, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const int* kv_pos, const int* pos, void* out, int B, int H, int S, int K,
    int hd, int window, float scale, int dtype, cudaStream_t stream) {
  using namespace repro_torch;
  if (K <= 0 || H % K != 0 || H / K > kDenseMaxG || S <= 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kv_pos, pos,
                                    out, B, H, S, K, window, scale, stream);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, q, k_cache, v_cache, kv_pos, pos, out, B, H,
                            S, K, window, scale, stream);
  return cudaErrorInvalidValue;
}
