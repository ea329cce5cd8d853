// Flash prefill attention for Hopper (sm_90a): one kernel, two entries,
// two bodies (bf16 on the tensor cores, fp32 by FMA).
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
// What bounds it on the H100: at the serve's shapes (B = 1, a 240-256
// token chunk over a cache of about 1000 keys, 32 heads of 128), bytes.
// Each K/V element fetched serves 4 * Sq flops across the chunk's
// queries, about 160 flop/byte after the causal half is dropped, against
// a ridge near 295 flop/byte for the bf16 tensor cores; and a per-SM
// view is the same: a 64-key tile of K and V (32 KB in bf16) feeds
// 2 * 64 * 64 * 128 * 2 flops for a 64-row query tile.  The bound is
// only reached if the tile loads overlap the products and the products
// do not run from shared memory at FMA rate.  So the bf16 body:
//   * runs both products, S = Q.K^T and O = P.V, on the tensor cores:
//     mma.sync.m16n8k16 with bf16 operands and fp32 accumulators.  A CTA
//     owns 64 query rows and runs two warp groups over them, 4 warps of
//     16 rows each; each warp keeps its Q rows as A fragments in
//     registers for the whole KV walk, its 16 x 64 score tile and its
//     16 x hd output in fp32 registers (about 240 registers a thread);
//   * the two groups walk alternate live K/V tiles, each with its own
//     ring, and merge their (m, l, O) through shared memory at the end.
//     With one group (4 warps an SM, one CTA per SM at these shapes) the
//     latencies of ldmatrix, mma and the softmax were all exposed: a
//     tile took as long with 4 CTAs on the card as with 128.  Two groups
//     put 8 warps on each SM;
//   * takes the fragments from shared memory with ldmatrix (K as stored,
//     V with ldmatrix.trans, so both keep their (key, hd) layout), in
//     tiles of 64 keys whose rows are padded by 16 bytes, so the 8 row
//     addresses of each ldmatrix phase fall in distinct bank groups;
//   * streams K/V in with 16-byte cp.async copies into a two-stage ring
//     per group: a group's next tile (and the row indices of the one
//     after) are in flight while its current tile is multiplied.  Each copy names its own row, so the paged
//     entry's 16-token pages and the contiguous entry's rows are gathered
//     alike; a key with kv_pos < 0 (an unset page, an empty slot, the
//     cache tail) is zero-filled and never read;
//   * keeps the online softmax (m, l) in fp32 per row and per thread,
//     rescales O by exp2 of the running max change, and rounds P to bf16
//     only as the operand of P.V (as FlashAttention-2); a tile whose keys
//     are all valid for every row of a warp (from the tile's smallest and
//     largest kv_pos and segments) skips the per-element mask;
//   * packs the G = H / K query heads of a kv head into the 64 rows of a
//     CTA when G divides 64 (64 / G queries x G heads), so each K/V tile
//     is loaded once for the whole group, as the Pallas kernel's Q block
//     holds the group's heads.  For another G each CTA takes one head.
//   At the serve's shapes this is 4 q-tiles x 32 heads = 128 CTAs, one
//   per SM, each walking at most 17 tiles.
// Both bodies skip, from the data, every K/V tile in which no key can be
// valid for any query row of the tile: a key can be valid only if
// kv_pos >= 0, (causal) kv_pos <= the tile's largest query position and
// (window) kv_pos > its smallest query position - window.  This reads
// the tile's actual kv_pos, not index ranges (a sliding-window ring does
// not keep positions in index order), so it is exact for any input: the
// contiguous entry no longer walks the empty tail of attn_extend's
// cache, nor the bf16 body a tile that only the window masks.  The paged
// entry also stops at logical block max(q_pos) // bs (see below).
//
// The fp32 body keeps the FMA design of the first port (32-row query
// tiles, 32-key fp32 tiles in shared memory, one head per CTA): the
// tensor cores would need TF32, whose 10-bit mantissa cannot hold the
// 1e-4 fp32 tolerance, and fp32 is the type of the CPU-parity server
// tests, not of the serve.  The wrapper picks the body by dtype alone.
//
// What a wgmma/TMA version would add (the next step): wgmma reads B
// from shared memory without the ldmatrix round trip through registers
// and issues a 64-row product per warpgroup asynchronously, so the
// softmax of one tile could overlap the products of the next
// (FlashAttention-3's ping-pong); TMA would move the contiguous entry's
// tiles with one thread and an mbarrier instead of 128 threads of
// cp.async.  A paged tile is four pages at unrelated addresses, so it
// needs one TMA box per page (or cp.async as here).
//
// Head dims: 64 and 128 on both entries, and 120 (h2o-danube-3-4b) on
// the contiguous entry, the one its padded plane runs.  The bf16 body
// needs whole k16 steps and pairs of 8-column tiles, so at 120 it runs
// the 128-wide body: Q, K and V rows are copied with their 15 real
// 16-byte chunks and the 16th is zero-filled in shared memory (cp.async
// with no source bytes), zero columns add nothing to Q.K^T, and the
// output columns 120..127 of P.V are never stored.  The fp32 body loads
// and stores element by element, so it takes 120 as it is.  Rows stay
// 16-byte aligned: 120 bf16 are 240 bytes.
//
// Masks, as the reference: kv_pos < 0 (empty, or a -1 table entry),
// causal on positions, the optional window, and on the contiguous entry
// segment equality with segment -1 = pad.  A fully masked query row
// outputs exactly 0.  The paged entry's early stop relies on the
// paged-cache invariant that logical block j holds positions in
// [j*bs, (j+1)*bs) or -1, so blocks past max(q_pos) // bs hold only keys
// causality masks.

#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// Position of key t for the tile-skip pre-pass and the row metadata:
// through the block table (paged) or straight from kv_pos (contiguous).
// *row gets the key's K/V row ((token * K) + kv head), or -1 when the key
// has kv_pos < 0 (nothing of it is read).
template <bool PAGED>
__device__ __forceinline__ int key_meta(int t, int b, int kvh, int K,
                                        int Skv, int bs, int nbt,
                                        const int* __restrict__ kv_pos,
                                        const int* __restrict__ kv_seg,
                                        const int* __restrict__ block_tab,
                                        int* row, int* seg) {
  int kp = -1, r = -1, sg = -1;
  if (PAGED) {
    const int phys = block_tab[static_cast<size_t>(b) * nbt + t / bs];
    if (phys >= 0) {
      const long long tok = static_cast<long long>(phys) * bs + t % bs;
      kp = kv_pos[tok];
      r = static_cast<int>(tok * K + kvh);
    }
  } else if (t < Skv) {
    const size_t at = static_cast<size_t>(b) * Skv + t;
    kp = kv_pos[at];
    sg = kv_seg[at];
    r = static_cast<int>(static_cast<long long>(at) * K + kvh);
  }
  *row = kp >= 0 ? r : -1;
  *seg = sg;
  return kp;
}

// Whether a key at position kp can be valid for some query of a tile
// whose valid rows span positions [qmin, qmax].
__device__ __forceinline__ bool key_can_attend(int kp, int qmin, int qmax,
                                               int causal, int window) {
  return kp >= 0 && (!causal || kp <= qmax) &&
         (window <= 0 || kp > qmin - window);
}

// ---------------------------------------------------------------------------
// fp32 body: FMA from shared memory
// ---------------------------------------------------------------------------

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

template <int HD, bool PAGED>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, const int* __restrict__ q_seg,
             const int* __restrict__ kv_seg,
             const int* __restrict__ block_tab, float* __restrict__ out,
             int Sq, int Skv, int H, int K, int bs, int nbt, int causal,
             int window, float scale) {
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
  __shared__ int s_nkv, s_qmin, s_qmax;

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
        qi < Sq ? q[((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + d]
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
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = 0; r < kBQ; ++r)
      if (s_qok[r]) {
        mn = min(mn, s_qpos[r]);
        mx = max(mx, s_qpos[r]);
      }
    int n = mx == INT_MIN ? 0 : Skv;     // no valid query row: nothing
    // paged, causal: keys past the tile's largest position are all masked
    if (PAGED) n = mx < 0 ? 0 : min(mx / bs + 1, nbt) * bs;
    s_nkv = n;
    s_qmin = mn;
    s_qmax = mx;
  }
  __syncthreads();
  const int n_kv = s_nkv;
  const int qmin = s_qmin, qmax = s_qmax;
  const int qp = s_qpos[row];
  const int qs = s_qseg[row];
  const bool qok = s_qok[row] != 0;

  float m_i = kNegInf, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += kBK) {
    bool can = false;
    if (tid < kBK) {
      const int t = kv0 + tid;
      int p = -1, sg = -1, r = -1;
      if (t < n_kv)
        p = key_meta<PAGED>(t, b, kvh, K, Skv, bs, nbt, kv_pos, kv_seg,
                            block_tab, &r, &sg);
      rowoff[tid] = r;
      kvp_s[tid] = p;
      kvs_s[tid] = sg;
      can = key_can_attend(p, qmin, qmax, causal, window);
    }
    // a tile no query of this CTA can attend to is skipped whole (every
    // thread gets the same answer, and the previous tile's last barrier
    // already ordered its reads of these buffers)
    if (!__syncthreads_or(can)) continue;
    for (int idx = tid; idx < kBK * HD; idx += kFlashThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      const long long o = rowoff[r];
      float kk = 0.f, vv = 0.f;
      if (o >= 0) {
        kk = k[o * HD + d];
        vv = v[o * HD + d];
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
    float* op = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      op[quad + 4 * jj] = l_i > 0.f ? acc[jj] / l_i : 0.f;
  }
}

template <int HD, bool PAGED>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos,
                        const int* q_seg, const int* kv_seg,
                        const int* block_tab, void* out, int B, int Sq,
                        int Skv, int H, int K, int bs, int nbt, int causal,
                        int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  auto kern = flash_kernel<HD, PAGED>;
  const cudaError_t attr = allow_dynamic_smem(
      reinterpret_cast<const void*>(kern), static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, kv_pos, q_seg, kv_seg, block_tab,
      static_cast<float*>(out), Sq, Skv, H, K, bs, nbt, causal, window,
      scale);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;        // (query, head) rows per CTA, 16 per warp
constexpr int kMmaKeys = 64;        // keys per K/V tile
constexpr int kGroups = 2;          // warp groups walking alternate tiles
constexpr int kGroupThreads = 128;  // 4 warps: all 64 rows of the CTA
constexpr int kMmaThreads = kGroups * kGroupThreads;
constexpr int kStages = 2;          // K/V tiles in flight per group
constexpr int kMetaRing = 3;        // tiles whose row metadata is in smem
constexpr int kMetaSlot = 3 * kMmaKeys + 8;   // ints: rows, pos, seg, summary
constexpr int kPrePassUnroll = 8;   // kv_pos loads in flight per thread

// Barrier of one warp group (named barrier 1 + g; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kGroupThreads)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The bf16 body's head dim: whole pairs of k16 steps.
constexpr int mma_hd(int hd) { return (hd + 31) / 32 * 32; }

template <int HD>
struct MmaLayout {
  static constexpr int LD = HD + 8;                     // padded row (elems)
  static constexpr int kTileElems = kMmaKeys * LD;
  static constexpr size_t kQBytes = size_t(kMmaRows) * LD * 2;
  static constexpr size_t kKVBytes =
      size_t(kGroups) * 2 * kStages * kTileElems * 2;
  static constexpr size_t kMetaBytes =
      size_t(kGroups) * kMetaRing * kMetaSlot * 4;
  static constexpr size_t kFixed = kQBytes + kKVBytes + kMetaBytes;
  // the end-of-walk exchange of one group's (m, l, O) reuses its tiles
  static_assert(size_t(4 + HD / 2) * kGroupThreads * 4 <=
                    size_t(2) * kStages * kTileElems * 2,
                "exchange does not fit a group's tiles");
};

template <int HD, bool PAGED>
__global__ void __launch_bounds__(kMmaThreads)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 const int* __restrict__ block_tab,
                 __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                 int K, int bs, int nbt, int causal, int window,
                 float scale_log2, int gp) {
  constexpr int HDP = mma_hd(HD);     // the body's head dim
  using L = MmaLayout<HDP>;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = HDP / 16;    // k-steps of Q.K^T
  constexpr int NT_S = kMmaKeys / 8;  // n-tiles of a score tile
  constexpr int NT_O = HDP / 8;       // n-tiles of the output
  constexpr int CPR = HDP / 8;        // 16-byte chunks per shared row
  constexpr int CPR_IN = HD / 8;      // ... of them read from a global row
  static_assert(HD % 8 == 0 && KSTEPS % 2 == 0 && NT_O % 2 == 0,
                "head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // per group: kStages K tiles, then kStages V tiles
  __nv_bfloat16* KVs = Qs + kMmaRows * LD;
  int* meta = reinterpret_cast<int*>(KVs + kGroups * 2 * kStages *
                                               L::kTileElems);
  // per half-tile of 32 keys: can any key of it be valid (pre-pass)
  unsigned char* live =
      reinterpret_cast<unsigned char*>(meta + kGroups * kMetaRing * kMetaSlot);
  __shared__ int s_qpos[kMmaRows], s_qseg[kMmaRows], s_qok[kMmaRows];
  __shared__ int s_wmin[kMmaThreads / 32], s_wmax[kMmaThreads / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = tid / kGroupThreads;         // warp group
  const int gtid = tid % kGroupThreads;
  const int gwarp = gtid >> 5;                 // warp in the group
  const int QR = kMmaRows / gp;                // queries per CTA
  const int q0 = blockIdx.x * QR;
  const int h0 = blockIdx.y * gp;              // first head of the CTA
  const int kvh = h0 / (H / K);
  const int b = blockIdx.z;

  // ---- Q rows (row r = query q0 + r / gp, head h0 + r % gp) -> smem ----
  for (int idx = tid; idx < kMmaRows * CPR; idx += kMmaThreads) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    const int qi = q0 + r / gp;
    const bool in = qi < Sq && c < CPR_IN;   // zero-fill the padding
    const __nv_bfloat16* src =
        in ? q + ((static_cast<size_t>(b) * Sq + qi) * H + h0 + r % gp) *
                         HD + c * 8
           : q;
    cp_async16(Qs + r * LD + c * 8, src, in ? 16 : 0);
  }
  cp_async_commit();

  int qmn = INT_MAX, qmx = INT_MIN;
  if (tid < kMmaRows) {
    const int qi = q0 + tid / gp;
    const bool in = qi < Sq;
    const size_t at = static_cast<size_t>(b) * Sq + qi;
    const int seg = (!in || PAGED) ? 0 : q_seg[at];
    const int p = in ? q_pos[at] : 0;
    const bool ok = in && seg >= 0;
    s_qpos[tid] = p;
    s_qseg[tid] = seg;
    s_qok[tid] = ok;
    if (ok) {
      qmn = p;
      qmx = p;
    }
  }
  qmn = __reduce_min_sync(0xffffffffu, qmn);
  qmx = __reduce_max_sync(0xffffffffu, qmx);
  if (lane == 0) {
    s_wmin[warp] = qmn;
    s_wmax[warp] = qmx;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < kMmaThreads / 32; ++w) {
    qmin = min(qmin, s_wmin[w]);
    qmax = max(qmax, s_wmax[w]);
  }
  int n_kv = qmax == INT_MIN ? 0 : Skv;   // no valid query row: nothing
  if (PAGED) n_kv = qmax < 0 ? 0 : min(qmax / bs + 1, nbt) * bs;
  const int n_tiles = (n_kv + kMmaKeys - 1) / kMmaKeys;

  // ---- pre-pass: which tiles hold a key some query can attend to ----
  // Warp w covers keys [base + 256u + 32w, +32): half of one tile, so
  // each half-tile flag has exactly one writer.
  for (int base = 0; base < n_kv; base += kPrePassUnroll * kMmaThreads) {
    int kp[kPrePassUnroll];
#pragma unroll
    for (int u = 0; u < kPrePassUnroll; ++u) {
      const int t = base + u * kMmaThreads + tid;
      int r, sg;
      kp[u] = t < n_kv ? key_meta<PAGED>(t, b, kvh, K, Skv, bs, nbt, kv_pos,
                                         kv_seg, block_tab, &r, &sg)
                       : -1;
    }
#pragma unroll
    for (int u = 0; u < kPrePassUnroll; ++u) {
      const int t0 = base + u * kMmaThreads + warp * 32;
      const bool any = __any_sync(
          0xffffffffu, key_can_attend(kp[u], qmin, qmax, causal, window));
      if (lane == 0 && t0 < n_kv) live[t0 / 32] = any;
    }
  }
  __syncthreads();
  const int n_halves = (n_kv + 31) / 32;
  auto next_live = [&](int j) {
    for (++j; j < n_tiles; ++j)
      if (live[2 * j] || (2 * j + 1 < n_halves && live[2 * j + 1])) break;
    return j;
  };
  // group g takes the live tiles of ordinal g, g + kGroups, ...
  auto next_own = [&](int j) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) j = next_live(j);
    return j;
  };

  // ---- per-thread row state: rows r0 = 16 gwarp + lane/4, r1 = r0 + 8 ----
  const int r0 = gwarp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int qp0 = s_qpos[r0], qp1 = s_qpos[r1];
  const int qs0 = s_qseg[r0], qs1 = s_qseg[r1];
  const bool ok0 = s_qok[r0] != 0, ok1 = s_qok[r1] != 0;
  // the warp's rows, for tiles whose keys are all valid for all of them
  const bool w_ok = __all_sync(0xffffffffu, ok0 && ok1);
  const int w_qmin = __reduce_min_sync(0xffffffffu, min(qp0, qp1));
  const int w_qmax = __reduce_max_sync(0xffffffffu, max(qp0, qp1));
  const int w_seg0 = __shfl_sync(0xffffffffu, qs0, 0);
  const int w_seg =
      __all_sync(0xffffffffu, qs0 == w_seg0 && qs1 == w_seg0) ? w_seg0
                                                               : INT_MIN;

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  __nv_bfloat16* Kg = KVs + grp * 2 * kStages * L::kTileElems;
  __nv_bfloat16* Vg = Kg + kStages * L::kTileElems;
  int* meta_g = meta + grp * kMetaRing * kMetaSlot;

  // the key metadata of one tile: group thread t < 64 holds key t
  int mr = -1, mp = -1, ms = -1;
  auto fetch_meta = [&](int j) {
    mr = mp = ms = -1;
    const int t = j * kMmaKeys + gtid;
    if (gtid < kMmaKeys && t < n_kv)
      mp = key_meta<PAGED>(t, b, kvh, K, Skv, bs, nbt, kv_pos, kv_seg,
                           block_tab, &mr, &ms);
  };
  // slot layout: rows[64] | pos[64] | seg[64] | per 32 keys: min pos,
  // max pos, their one segment (INT_MIN if they differ)
  auto store_meta = [&](int slot) {
    if (gtid < kMmaKeys) {           // warps 0 and 1 of the group
      int* s = meta_g + slot * kMetaSlot;
      s[gtid] = mr;
      s[kMmaKeys + gtid] = mp;
      s[2 * kMmaKeys + gtid] = ms;
      const int kmn = __reduce_min_sync(0xffffffffu, mp);
      const int kmx = __reduce_max_sync(0xffffffffu, mp);
      const int s0 = __shfl_sync(0xffffffffu, ms, 0);
      const bool uni = __all_sync(0xffffffffu, ms == s0);
      if (lane == 0) {
        s[3 * kMmaKeys + 3 * gwarp] = kmn;
        s[3 * kMmaKeys + 3 * gwarp + 1] = kmx;
        s[3 * kMmaKeys + 3 * gwarp + 2] = uni ? s0 : INT_MIN;
      }
    }
  };
  auto issue_tile = [&](int stage, int slot) {
    __nv_bfloat16* kd = Kg + stage * L::kTileElems;
    __nv_bfloat16* vd = Vg + stage * L::kTileElems;
    const int* rows = meta_g + slot * kMetaSlot;
#pragma unroll
    for (int i = 0; i < kMmaKeys * CPR / kGroupThreads; ++i) {
      const int idx = i * kGroupThreads + gtid;
      const int r = idx / CPR;
      const int c = idx % CPR;
      const int row = rows[r];
      const bool ld = row >= 0 && c < CPR_IN;   // zero-fill the padding
      const size_t off = ld ? static_cast<size_t>(row) * HD + c * 8 : 0;
      cp_async16(kd + r * LD + c * 8, k + off, ld ? 16 : 0);
      cp_async16(vd + r * LD + c * 8, v + off, ld ? 16 : 0);
    }
  };

  int j = grp == 0 ? next_live(-1) : next_live(next_live(-1));
  if (j < n_tiles) {
    const int jn = next_own(j);
    fetch_meta(jn < n_tiles ? jn : j);   // both tiles' loads in flight
    const int nr = mr, np = mp, ns = ms;
    fetch_meta(j);
    store_meta(0);
    mr = nr;
    mp = np;
    ms = ns;
    store_meta(1);
    group_sync(grp);
    issue_tile(0, 0);
  }
  cp_async_commit();
  cp_async_wait<1>();           // this thread's Q copies have landed
  __syncthreads();              // everyone's have

  // Q fragments (A operands), held for the whole walk
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (gwarp * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * LD +
                             kk * 16 + (lane >> 4) * 8);

  const int c2 = 2 * (lane & 3);    // this thread's first column of a tile
  for (int it = 0; j < n_tiles; ++it) {
    const int stage = it % kStages;
    const int slot = it % kMetaRing;
    const int jn = next_own(j);
    if (jn < n_tiles) issue_tile(stage ^ 1, (it + 1) % kMetaRing);
    cp_async_commit();
    const int jnn = jn < n_tiles ? next_own(jn) : n_tiles;
    if (jnn < n_tiles) fetch_meta(jnn);   // in flight during the products
    cp_async_wait<1>();
    group_sync(grp);

    const __nv_bfloat16* kt = Kg + stage * L::kTileElems;
    const __nv_bfloat16* vt = Vg + stage * L::kTileElems;
    const int* kpos = meta_g + slot * kMetaSlot + kMmaKeys;
    const int* kseg = kpos + kMmaKeys;
    const int* ksum = kseg + kMmaKeys;

    // S = Q.K^T (16 x 64 per warp)
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        unsigned bf[4];
        ldmatrix_x4(bf, kt + (n * 8 + (lane & 7)) * LD + kk * 16 +
                            (lane >> 3) * 8);
        mma_bf16(s[n], qf[kk], bf[0], bf[1]);
        mma_bf16(s[n], qf[kk + 1], bf[2], bf[3]);
      }
    }

    // masks (skipped when every key of the tile is valid for every row
    // of the warp) and the online softmax
    const int kmin = min(ksum[0], ksum[3]), kmax = max(ksum[1], ksum[4]);
    const bool full = w_ok && kmin >= 0 && (!causal || kmax <= w_qmin) &&
                      (window <= 0 || kmin > w_qmax - window) &&
                      (PAGED || (w_seg != INT_MIN && ksum[2] == w_seg &&
                                 ksum[5] == w_seg));
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (full) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = n * 8 + c2 + e;
          const int kp = kpos[key];
          const bool kv_ok = kp >= 0;
          const int ks = PAGED ? 0 : kseg[key];
          const bool v0 = ok0 && kv_ok && (!causal || qp0 >= kp) &&
                          (window <= 0 || qp0 - kp < window) &&
                          (PAGED || ks == qs0);
          const bool v1 = ok1 && kv_ok && (!causal || qp1 >= kp) &&
                          (window <= 0 || qp1 - kp < window) &&
                          (PAGED || ks == qs1);
          s[n][e] = v0 ? s[n][e] : -INFINITY;
          s[n][2 + e] = v1 ? s[n][2 + e] : -INFINITY;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // m is kept on the raw score scale; p = 2^(s * scale_log2 - m'),
    // one FFMA and one ex2 per score
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no valid key yet keeps everything at 0 (no inf - inf)
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
    const float a0 = mn0 == m0 ? 1.f : ex2(fmaf(m0, scale_log2, -mu0));
    const float a1 = mn1 == m1 ? 1.f : ex2(fmaf(m1, scale_log2, -mu1));
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, -mu0));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, -mu0));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, -mu1));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, -mu1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    // rescale O only if some row's running max moved (most tiles after
    // the first few leave it in place)
    if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
    }

    // O += P.V: P's C fragments are the A fragments of P.V (bf16)
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], pa, bf[0], bf[1]);
        mma_bf16(o[n + 1], pa, bf[2], bf[3]);
      }
    }

    store_meta((it + 2) % kMetaRing);   // tile jnn's rows, for next time
    group_sync(grp);                    // stage and slot free for reuse
    j = jn;
  }
  cp_async_wait<0>();

  // ---- merge the two groups' (m, l, O) and write O / l ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // group 1 hands its state to the thread of group 0 holding the same
  // fragment, through its own (now idle) tiles; element-major, so the
  // 128 threads of a group write and read consecutive words
  float* xch = reinterpret_cast<float*>(KVs + 2 * kStages * L::kTileElems);
  __syncthreads();
  if (grp == 1) {
    xch[0 * kGroupThreads + gtid] = m0;
    xch[1 * kGroupThreads + gtid] = m1;
    xch[2 * kGroupThreads + gtid] = l0;
    xch[3 * kGroupThreads + gtid] = l1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(4 + 4 * n + e) * kGroupThreads + gtid] = o[n][e];
  }
  __syncthreads();
  if (grp == 1) return;
  {
    const float pm0 = xch[gtid], pm1 = xch[kGroupThreads + gtid];
    const float M0 = fmaxf(m0, pm0), M1 = fmaxf(m1, pm1);
    const float u0 = M0 == -INFINITY ? 0.f : M0 * scale_log2;
    const float u1 = M1 == -INFINITY ? 0.f : M1 * scale_log2;
    const float fa0 = ex2(fmaf(m0, scale_log2, -u0));
    const float fb0 = ex2(fmaf(pm0, scale_log2, -u0));
    const float fa1 = ex2(fmaf(m1, scale_log2, -u1));
    const float fb1 = ex2(fmaf(pm1, scale_log2, -u1));
    l0 = l0 * fa0 + xch[2 * kGroupThreads + gtid] * fb0;
    l1 = l1 * fa1 + xch[3 * kGroupThreads + gtid] * fb1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const float* px = xch + (4 + 4 * n) * kGroupThreads + gtid;
      o[n][0] = o[n][0] * fa0 + px[0] * fb0;
      o[n][1] = o[n][1] * fa0 + px[kGroupThreads] * fb0;
      o[n][2] = o[n][2] * fa1 + px[2 * kGroupThreads] * fb1;
      o[n][3] = o[n][3] * fa1 + px[3 * kGroupThreads] * fb1;
    }
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int qi0 = q0 + r0 / gp, qi1 = q0 + r1 / gp;
  __nv_bfloat16* o0 =
      out + ((static_cast<size_t>(b) * Sq + qi0) * H + h0 + r0 % gp) * HD;
  __nv_bfloat16* o1 =
      out + ((static_cast<size_t>(b) * Sq + qi1) * H + h0 + r1 % gp) * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {     // the real columns only
    if (qi0 < Sq)
      *reinterpret_cast<unsigned*>(o0 + n * 8 + c2) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (qi1 < Sq)
      *reinterpret_cast<unsigned*>(o1 + n * 8 + c2) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD, bool PAGED>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos,
                        const int* q_seg, const int* kv_seg,
                        const int* block_tab, void* out, int B, int Sq,
                        int Skv, int H, int K, int bs, int nbt, int causal,
                        int window, float scale, cudaStream_t stream) {
  using L = MmaLayout<mma_hd(HD)>;
  // 227 KB a block, less 2 KB for the kernel's static shared memory
  constexpr int kMaxSmem = 232448 - 2048;
  const int n_kv = PAGED ? nbt * bs : Skv;
  const size_t smem = L::kFixed + ((n_kv + 31) / 32 + 15) / 16 * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_kernel_mma<HD, PAGED>;
  // allow the largest size once a device; each launch asks only for what
  // it needs
  const cudaError_t attr =
      allow_dynamic_smem(reinterpret_cast<const void*>(kern), kMaxSmem);
  if (attr != cudaSuccess) return attr;
  // the G heads of a kv head share the CTA's rows when G divides them
  const int G = H / K;
  const int gp = kMmaRows % G == 0 ? G : 1;
  const int qr = kMmaRows / gp;
  const dim3 grid((Sq + qr - 1) / qr, H / gp, B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos, q_seg, kv_seg,
      block_tab, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, K, bs, nbt,
      causal, window, scale * 1.4426950408889634f, gp);
  return cudaSuccess;
}

template <bool PAGED>
cudaError_t dispatch(int dtype, int hd, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     const int* q_seg, const int* kv_seg,
                     const int* block_tab, void* out, int B, int Sq, int Skv,
                     int H, int K, int bs, int nbt, int causal, int window,
                     float scale, cudaStream_t stream) {
  // K/V rows (token * K + kv head) are indexed in int32: a K tensor of
  // 2^31 rows of hd >= 64 elements would not fit in the card's memory.
#define REPRO_FLASH_CASE(FN, HD)                                            \
  return FN<HD, PAGED>(q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_tab,   \
                       out, B, Sq, Skv, H, K, bs, nbt, causal, window, scale, \
                       stream)
  if (dtype == kBFloat16) {
    if (hd == 64) REPRO_FLASH_CASE(launch_bf16, 64);
    if (hd == 128) REPRO_FLASH_CASE(launch_bf16, 128);
  } else if (dtype == kFloat32) {
    if (hd == 64) REPRO_FLASH_CASE(launch_fp32, 64);
    if (hd == 128) REPRO_FLASH_CASE(launch_fp32, 128);
  }
  if constexpr (!PAGED) {               // head dim 120: contiguous only
    if (hd == 120 && dtype == kBFloat16) REPRO_FLASH_CASE(launch_bf16, 120);
    if (hd == 120 && dtype == kFloat32) REPRO_FLASH_CASE(launch_fp32, 120);
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
