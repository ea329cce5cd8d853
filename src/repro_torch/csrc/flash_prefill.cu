// Flash prefill attention for Hopper (sm_90a): one kernel, two entries.
//
// Replaces: repro/kernels/flash_prefill/kernel.py flash_prefill_pallas
//   (body _flash_kernel) -- entry launch_flash_prefill, contiguous
//   packed-varlen K/V with segment ids;
// and the gather + attend of attn_extend_paged
//   (repro/models/blocks.py:464-475) -- entry
//   launch_paged_prefill_attention, K/V read through the block table.
// Plain versions: repro_torch/kernels/flash_prefill/ops.py
//   flash_prefill_plain and paged_prefill_attention_plain.
//
// What bounds it on the H100: operations.  A chunk of Sq queries over
// Skv keys does 4 * Sq * Skv * hd flops per head for 2 * Skv * hd *
// sizeof(T) bytes of K/V, i.e. ~Sq flop/byte: above the card's ridge for
// any chunk of more than a few hundred tokens.  This first version keeps
// the arithmetic right and the bytes low, not the tensor cores busy:
//   * one CTA per (32-query tile, query head, row); K/V stream through
//     shared memory in 32-key tiles with an online softmax in fp32, so
//     nothing of size Sq x Skv is ever written to device memory (the
//     gather path of the reference materialises the whole table view);
//   * the kv loop runs inside the CTA in place of the Pallas sequential
//     grid axis; on the paged entry it stops at the tile's last live
//     logical block, max(q_pos) // bs, instead of the full table;
//   * the products are fp32 FMAs from shared memory (4 threads per query
//     row, each owning a quarter of the scores and of the output dims).
// wgmma with TMA-fed tiles is the follow-up that makes it compute-bound.
//
// Masks, as the reference: kv_pos < 0 (empty, or a -1 table entry),
// causal on positions, the optional window, and on the contiguous entry
// segment equality with segment -1 = pad.  A fully masked query row
// outputs 0.  The paged entry's early stop relies on the paged-cache
// invariant that logical block j holds positions in [j*bs, (j+1)*bs) or
// -1, so blocks past max(q_pos) // bs hold only keys causality masks.

#include <limits.h>

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kBQ = 32;          // query rows per CTA
constexpr int kBK = 32;          // keys per shared-memory tile
constexpr int kFlashThreads = 128;

template <int HD>
constexpr size_t flash_smem_bytes() {
  // rowoff (int64) | Q, K, V tiles (fp32, padded rows) | P tile | kv pos,
  // kv seg (int32)
  return kBK * sizeof(long long) +
         (kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * (kBK + 1)) *
             sizeof(float) +
         2 * kBK * sizeof(int);
}

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, const int* __restrict__ q_seg,
             const int* __restrict__ kv_seg,
             const int* __restrict__ block_tab, T* __restrict__ out, int Sq,
             int Skv, int H, int K, int bs, int nbt, int causal, int window,
             float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = kBK + 1;
  constexpr int DPT = HD / 4;      // output dims per thread
  constexpr int SPT = kBK / 4;     // scores per thread per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rowoff = reinterpret_cast<long long*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(rowoff + kBK);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;
  int* kvp_s = reinterpret_cast<int*>(Ps + kBQ * PLD);
  int* kvs_s = kvp_s + kBK;
  __shared__ int s_qpos[kBQ];
  __shared__ int s_qseg[kBQ];
  __shared__ int s_qok[kBQ];
  __shared__ int s_nkv;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quad = tid & 3;
  const int q0 = qt * kBQ;

  for (int idx = tid; idx < kBQ * HD; idx += kFlashThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int qi = q0 + r;
    Qs[r * LD + d] =
        qi < Sq ? to_float(q[((static_cast<size_t>(b) * Sq + qi) * H + h) *
                                 HD + d])
                : 0.f;
  }
  if (tid < kBQ) {
    const int qi = q0 + tid;
    const bool in = qi < Sq;
    const size_t at = static_cast<size_t>(b) * Sq + qi;
    const int seg = (!in || PAGED) ? 0 : q_seg[at];
    s_qpos[tid] = in ? q_pos[at] : INT_MIN;
    s_qseg[tid] = seg;
    s_qok[tid] = in && seg >= 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = Skv;
    if (PAGED) {
      // causal: keys past the tile's largest position are all masked
      int mx = -1;
      for (int r = 0; r < kBQ; ++r)
        if (s_qok[r]) mx = max(mx, s_qpos[r]);
      n = mx < 0 ? 0 : min(mx / bs + 1, nbt) * bs;
    }
    s_nkv = n;
  }
  __syncthreads();
  const int n_kv = s_nkv;
  const int qp = s_qpos[row];
  const int qs = s_qseg[row];
  const bool qok = s_qok[row] != 0;

  float m_i = kNegInf, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += kBK) {
    if (tid < kBK) {
      const int t = kv0 + tid;
      long long off = -1;
      int p = -1, sg = -1;
      if (t < n_kv) {
        if (PAGED) {
          const int phys = block_tab[static_cast<size_t>(b) * nbt + t / bs];
          if (phys >= 0) {
            const int o = t % bs;
            p = kv_pos[static_cast<size_t>(phys) * bs + o];
            off = (static_cast<long long>(phys) * bs + o) * K + kvh;
          }
        } else {
          const size_t at = static_cast<size_t>(b) * Skv + t;
          p = kv_pos[at];
          sg = kv_seg[at];
          off = static_cast<long long>(at) * K + kvh;
        }
      }
      rowoff[tid] = off;
      kvp_s[tid] = p;
      kvs_s[tid] = sg;
    }
    __syncthreads();
    for (int idx = tid; idx < kBK * HD; idx += kFlashThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const long long o = rowoff[r];
      float kk = 0.f, vv = 0.f;
      if (o >= 0) {
        kk = to_float(k[o * HD + d]);
        vv = to_float(v[o * HD + d]);
      }
      Ks[r * LD + d] = kk;
      Vs[r * LD + d] = vv;
    }
    __syncthreads();

    // scores of this thread's query row against keys quad + 4c
    float s[SPT];
#pragma unroll
    for (int c = 0; c < SPT; ++c) s[c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[row * LD + d];
#pragma unroll
      for (int c = 0; c < SPT; ++c) s[c] += qd * Ks[(quad + 4 * c) * LD + d];
    }
    unsigned ok_bits = 0u;
    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const int j = quad + 4 * c;
      const int kp = kvp_s[j];
      const bool ok = qok && kp >= 0 && (!causal || qp >= kp) &&
                      (window <= 0 || qp - kp < window) &&
                      (PAGED || kvs_s[j] == qs);
      s[c] *= scale;
      if (ok) {
        ok_bits |= 1u << c;
        tmax = fmaxf(tmax, s[c]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const float p = (ok_bits >> c) & 1u ? expf(s[c] - m_new) : 0.f;
      Ps[row * PLD + quad + 4 * c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();   // the row's P entries come from the 4 lanes of its quad

#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[jj] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[row * PLD + j];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[jj] += p * Vs[j * LD + quad + 4 * jj];
    }
    __syncthreads();   // before the next tile overwrites K, V and P
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    T* op = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      store(op + quad + 4 * jj, l_i > 0.f ? acc[jj] / l_i : 0.f);
  }
}

template <typename T, int HD, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos,
                         const int* q_seg, const int* kv_seg,
                         const int* block_tab, void* out, int B, int Sq,
                         int Skv, int H, int K, int bs, int nbt, int causal,
                         int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  auto kern = flash_kernel<T, HD, PAGED>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, q_seg, kv_seg, block_tab,
      static_cast<T*>(out), Sq, Skv, H, K, bs, nbt, causal, window, scale);
  return cudaSuccess;
}

template <bool PAGED>
cudaError_t dispatch(int dtype, int hd, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     const int* q_seg, const int* kv_seg,
                     const int* block_tab, void* out, int B, int Sq, int Skv,
                     int H, int K, int bs, int nbt, int causal, int window,
                     float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(T, HD)                                            \
  return launch_typed<T, HD, PAGED>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, \
                                    block_tab, out, B, Sq, Skv, H, K, bs,  \
                                    nbt, causal, window, scale, stream)
  if (dtype == kBFloat16) {
    if (hd == 64) REPRO_FLASH_CASE(__nv_bfloat16, 64);
    if (hd == 128) REPRO_FLASH_CASE(__nv_bfloat16, 128);
  } else if (dtype == kFloat32) {
    if (hd == 64) REPRO_FLASH_CASE(float, 64);
    if (hd == 128) REPRO_FLASH_CASE(float, 128);
  }
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_flash_prefill(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, const int* q_seg, const int* kv_seg, void* out, int B,
    int Sq, int Skv, int H, int K, int hd, int causal, int window,
    float scale, int dtype, cudaStream_t stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  return repro_torch::dispatch<false>(dtype, hd, q, k, v, q_pos, kv_pos,
                                      q_seg, kv_seg, nullptr, out, B, Sq,
                                      Skv, H, K, 1, 1, causal, window, scale,
                                      stream);
}

cudaError_t launch_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* q_pos,
    void* out, int B, int Sq, int H, int K, int hd, int bs, int nbt,
    int window, float scale, int dtype, cudaStream_t stream) {
  if (K <= 0 || H % K != 0 || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  return repro_torch::dispatch<true>(dtype, hd, q, k_pool, v_pool, q_pos,
                                     kv_pos_pool, nullptr, nullptr,
                                     block_tab, out, B, Sq, nbt * bs, H, K,
                                     bs, nbt, 1, window, scale, stream);
}
