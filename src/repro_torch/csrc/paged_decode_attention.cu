// Paged decode attention for Hopper (sm_90a): a split kernel and a merge.
//
// Replaces: repro/kernels/decode_attention/kernel.py
//   paged_decode_attention_pallas (body _paged_decode_kernel).
// Plain version: repro_torch/kernels/decode_attention/ops.py
//   paged_decode_attention_plain (dense gather + masked softmax).
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its live
// K and V once (2 * live_tokens * hd * sizeof(T)) and does 4 * G flops
// per element read, far below the ~295 flop/byte the card needs to be
// compute-bound.  So the time is set by how many bytes are in flight
// across the card, and the design keeps as many in flight as it can
// while moving only the live bytes:
//   * split-K over pages: the grid is (kv head, row, split); split s of a
//     row takes the contiguous range of logical blocks
//     [s * bps, (s + 1) * bps) of the row's table, so a long row is read
//     by many CTAs at once (one CTA per (row, kv head) would give 256
//     CTAs at the serve's shape, the longest row's pages all behind one
//     of them).  The number of splits comes from the shapes and the
//     card alone (B, K, nbt, SM count; `decode_splits` in ops.py): the
//     host never reads
//     `pos`, which would cost a sync per layer.  A split past the row's
//     live blocks (0 .. pos // bs) exits at once with l = 0;
//   * one dependent load per token: the CTA stages its table entries in
//     shared memory, then resolves each staged token's kv_pos to its K/V
//     row or to "masked" (-1 entry, kv_pos < 0, past pos, outside the
//     window), all loads of a stage issued together; the token loop then
//     reads a row index from shared memory and issues the K/V loads;
//   * several tokens in flight per sub-warp (as kernel #3,
//     decode_attention.cu): sub-warps of hd / VEC lanes, each lane
//     issuing 16-byte loads of K and V for UNROLL tokens before any
//     arithmetic; a masked token is never loaded;
//   * each sub-warp keeps an fp32 online-softmax state for the G <= 8
//     query heads of the kv head (K/V read once for the group); the
//     sub-warps merge once in shared memory, and each split writes its
//     partial (m, l, acc) in fp32 to scratch that the wrapper allocates;
//   * a second small kernel merges the splits of each (row, head) with
//     the log-sum-exp rule: no atomics.  With one split the first kernel
//     writes the output itself and the merge is not launched.
// What a TMA version would add: one bulk copy per page (16 tokens x hd
// contiguous per kv head only when K = 1; otherwise 16 rows at a stride
// of K * hd, one 2-d box) into a shared-memory ring, with no registers
// spent on addresses; it matters when few rows are live and the
// per-thread loads cannot keep enough bytes in flight.
//
// Exactness contract with the reference: a -1 table entry is never read
// as live (the null block 0 holds other rows' garbage), positions past
// `pos` and negative positions are masked, and a row with no valid key
// (e.g. a decode_mask'ed row whose table is all -1) outputs exactly 0.
// Walking only logical blocks 0 .. pos // bs relies on the paged-cache
// invariant that logical block j holds positions in [j*bs, (j+1)*bs) or
// -1; blocks past it can hold only positions > pos, which the reference
// masks.

#include <type_traits>

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kDecodeThreads = 128;
constexpr int kMaxG = 8;          // query heads per kv head handled by one CTA
constexpr int kStageTokens = 512; // tokens resolved in shared memory at once

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ kv_pos_pool,
                    const int* __restrict__ block_tab,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int H, int K, int G,
                    int bs, int nbt, int bps, int window, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPT = HD / VEC;                 // lanes per token
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0,
                "head dim does not map onto sub-warps");
  constexpr int NSUB = kDecodeThreads / LPT;    // sub-warps per CTA
  constexpr int UNROLL = GMAX == 1 ? 8 : GMAX == 2 ? 4 : 2;
  constexpr int STEP = NSUB * UNROLL;           // tokens per iteration

  __shared__ int s_tab[kStageTokens];   // table entries of the stage
  __shared__ int s_row[kStageTokens];   // K/V row of each token, -1 masked
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
  const int n_blk = pos < 0 ? 0 : min(pos / bs + 1, nbt);
  const int blk0 = split * bps;
  const int blk1 = min(blk0 + bps, n_blk);
  const int tok0 = blk0 * bs;
  const int tok1 = blk1 > blk0 ? blk1 * bs : tok0;
  const int* tab = block_tab + static_cast<size_t>(b) * nbt;

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
    if (g < G && tok1 > tok0) {
      const T* qp = q + (static_cast<size_t>(b) * H + kvh * G + g) * HD;
      Vec16<T>::load(qp + lane * VEC, qr[g]);
    }
  }

  for (int c0 = tok0; c0 < tok1; c0 += kStageTokens) {
    const int n = min(kStageTokens, tok1 - c0);
    const int pg0 = c0 / bs;
    const int npg = (c0 + n - 1) / bs - pg0 + 1;
    for (int i = tid; i < npg; i += kDecodeThreads) s_tab[i] = tab[pg0 + i];
    __syncthreads();
    for (int i = tid; i < n; i += kDecodeThreads) {
      const int t = c0 + i;
      const int phys = s_tab[t / bs - pg0];
      int row = -1;
      if (phys >= 0) {
        const long long tok = static_cast<long long>(phys) * bs + t % bs;
        const int kp = kv_pos_pool[tok];
        if (kp >= 0 && kp <= pos && (window <= 0 || pos - kp < window))
          row = static_cast<int>(tok * K + kvh);
      }
      s_row[i] = row;
    }
    __syncthreads();

    // Every thread runs the same trip count, so the sub-warp shuffles
    // below are always executed by the whole warp.
    for (int t0 = 0; t0 < n; t0 += STEP) {
      int row[UNROLL];
      uint4 kraw[UNROLL], vraw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = t0 + u * NSUB + sub;
        row[u] = i < n ? s_row[i] : -1;
        kraw[u] = make_uint4(0u, 0u, 0u, 0u);
        vraw[u] = kraw[u];
        if (row[u] >= 0) {
          const size_t off = static_cast<size_t>(row[u]) * HD + lane * VEC;
          kraw[u] = *reinterpret_cast<const uint4*>(k_pool + off);
          vraw[u] = *reinterpret_cast<const uint4*>(v_pool + off);
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
          if (row[u] >= 0) mx = fmaxf(mx, s[u]);
        }
        if (mx <= kNegInf) continue;            // no valid token this step
        const float mn = fmaxf(m[g], mx);
        const float a = expf(m[g] - mn);
        l[g] *= a;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= a;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (row[u] < 0) continue;
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
    __syncthreads();   // before the next stage overwrites s_tab / s_row
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
    const int h = kvh * G + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int d = tid; d < HD; d += kDecodeThreads) {
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

// One CTA per (row, head): the splits' partials merged by log-sum-exp.
// A split with l = 0 (past the row's live blocks, or all masked) adds
// nothing and its acc is never read; a row with no valid key gives 0.
// Shared with the dense decode kernel (decode_attention.cu) through
// launch_decode_merge.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_merge_kernel(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {
      const float w = expf(ml[2 * s] - mx);
      lsum += ls * w;
      o += part_acc[(bh * n_split + s) * HD + d] * w;
    }
  }
  store(out + bh * HD + d, lsum > 0.f ? o / lsum : 0.f);
}

template <typename T, int HD, int GMAX>
cudaError_t launch_typed(const void* q, const void* k_pool,
                         const void* v_pool, const int* kv_pos_pool,
                         const int* block_tab, const int* pos, void* out,
                         float* part_ml, float* part_acc, int B, int H,
                         int K, int bs, int nbt, int n_split, int window,
                         float scale, cudaStream_t stream) {
  const int bps = (nbt + n_split - 1) / n_split;
  const dim3 grid(K, B, n_split);
  paged_decode_kernel<T, HD, GMAX><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), kv_pos_pool, block_tab, pos,
      static_cast<T*>(out), part_ml, part_acc, H, K, H / K, bs, nbt, bps,
      window, scale);
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
cudaError_t launch_group(const void* q, const void* k_pool,
                         const void* v_pool, const int* kv_pos_pool,
                         const int* block_tab, const int* pos, void* out,
                         float* part_ml, float* part_acc, int B, int H,
                         int K, int bs, int nbt, int n_split, int window,
                         float scale, cudaStream_t stream) {
#define REPRO_PAGED_CASE(GM)                                                \
  return launch_typed<T, HD, GM>(q, k_pool, v_pool, kv_pos_pool, block_tab, \
                                 pos, out, part_ml, part_acc, B, H, K, bs,  \
                                 nbt, n_split, window, scale, stream)
  const int G = H / K;
  if (G <= 1) REPRO_PAGED_CASE(1);
  if (G <= 2) REPRO_PAGED_CASE(2);
  if (G <= 4) REPRO_PAGED_CASE(4);
  REPRO_PAGED_CASE(8);
#undef REPRO_PAGED_CASE
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k_pool,
                      const void* v_pool, const int* kv_pos_pool,
                      const int* block_tab, const int* pos, void* out,
                      float* part_ml, float* part_acc, int B, int H, int K,
                      int bs, int nbt, int n_split, int window, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_group<T, 64>(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                 pos, out, part_ml, part_acc, B, H, K, bs,
                                 nbt, n_split, window, scale, stream);
    case 128:
      return launch_group<T, 128>(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                  pos, out, part_ml, part_acc, B, H, K, bs,
                                  nbt, n_split, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_decode_merge(const float* part_ml, const float* part_acc,
                                void* out, int BH, int hd, int n_split,
                                int dtype, cudaStream_t stream) {
  using namespace repro_torch;
#define REPRO_MERGE(T, HD)                                                 \
  paged_decode_merge_kernel<T, HD><<<BH, HD, 0, stream>>>(                \
      part_ml, part_acc, static_cast<T*>(out), n_split);                  \
  return cudaSuccess
  if (BH == 0) return cudaSuccess;
  if (dtype == kBFloat16 && hd == 64) { REPRO_MERGE(__nv_bfloat16, 64); }
  if (dtype == kBFloat16 && hd == 128) { REPRO_MERGE(__nv_bfloat16, 128); }
  if (dtype == kFloat32 && hd == 64) { REPRO_MERGE(float, 64); }
  if (dtype == kFloat32 && hd == 128) { REPRO_MERGE(float, 128); }
#undef REPRO_MERGE
  return cudaErrorInvalidValue;
}

cudaError_t launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* pos, void* out,
    float* part_ml, float* part_acc, int B, int H, int K, int hd, int bs,
    int nbt, int n_split, int window, float scale, int dtype,
    cudaStream_t stream) {
  using namespace repro_torch;
  if (K <= 0 || H % K != 0 || H / K > kMaxG || bs <= 0 || nbt <= 0 ||
      n_split <= 0 || n_split > nbt ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  // every split must own at least one table entry
  const int bps = (nbt + n_split - 1) / n_split;
  if ((n_split - 1) * bps >= nbt) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, kv_pos_pool,
                                    block_tab, pos, out, part_ml, part_acc,
                                    B, H, K, bs, nbt, n_split, window, scale,
                                    stream);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, q, k_pool, v_pool, kv_pos_pool, block_tab,
                            pos, out, part_ml, part_acc, B, H, K, bs, nbt,
                            n_split, window, scale, stream);
  return cudaErrorInvalidValue;
}
