// Flash prefill attention for Hopper (sm_90a): one kernel, two entries,
// two bodies (bf16 on wgmma, fp32 by FMA).
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
// What bounds it on the H100.  Two regimes meet in this kernel:
//   * many queries (whisper-large-v3's encoder, 4 x 1500^2 at 20 heads of
//     64): operations, 46.1 GFLOP (0.0466 ms at 989 TFLOP/s).  At head
//     dim 64 the exps are as costly as the products: a 64 x 64 score
//     tile is 4096 ex2 on 16 special-function lanes an SM (256 cycles)
//     beside 256 cycles of wgmma, so the bound is reached only if the
//     softmax of one tile overlaps the products of another;
//   * few queries (its decode step's and chunk's cross-attention, 1 or
//     16 queries over 1500 keys): bytes, 30.7 MB of K/V (0.00917 ms at
//     3.35 TB/s), and a grid of 80 (head, row) CTAs that would leave 52
//     of 132 SMs idle and walk 24 tiles each in series;
//   and the serve's causal chunks (a 240-256-token chunk over about
//   1000 keys, hd 128 and 120) sit between them.
// The bf16 body, for both entries, causal or not, every head dim:
//   * CTAs of 64, 128 or 192 (query, head) rows (192 at head dim 64
//     only; flash_splits takes the count whose busiest SM walks the
//     fewest rows, ceil(CTAs / SMs) x rows): one to three consumer
//     warpgroups of 64 rows, plus a producer warp.  Both products run on
//     wgmma: S = Q.K^T (m64n64k16; Q and K from shared memory, K in its
//     (key, hd) layout) and O += P.V (m64nHDk16: P from registers
//     in the accumulator's layout, V from shared memory with the
//     transpose bit, so V keeps its (key, hd) layout).  Tiles are 64-key
//     blocks of 128-byte rows in the 128-byte swizzle that TMA writes and
//     the wgmma descriptors read (hd 128 is two such blocks);
//   * one 4-stage K/V ring shared by the warpgroups, with a full and an
//     empty mbarrier a stage.  The producer fills it with TMA (one 4-d
//     box of 64 columns by 64 keys of one kv head, hd 128 two, issued by
//     one lane) on the contiguous entry when all of a tile's keys are
//     alive, and with cp.async otherwise: the paged entry (a 64-key tile
//     is four 16-token pages at unrelated addresses: four small boxes
//     timed slower than cp.async) and tiles with dead keys (kv_pos < 0
//     or, contiguous, segment < 0), whose rows are zero-filled and never
//     read, so NaN in their memory never reaches P.V (TMA would copy
//     it, and 0 x NaN is NaN).  Before the first tile the producer
//     prefetches the split's first 8 tiles into L2 (TMA prefetch), while
//     the pre-pass runs;
//   * a pre-pass over each window of 32 tiles, by all warps: every key's
//     position (-1 when dead) and segment into shared memory, and per 32
//     keys their position range, their one segment and whether all are
//     alive; a tile no query of the CTA can attend to (kv_pos < 0,
//     causality, the window) is skipped, from the data.  The softmax
//     then settles each row of a tile from that summary (every key
//     valid, or a padding row: no per-key work) and masks key by key
//     only on the causal diagonal, at ragged edges and segment borders.
//     The producer and the masks read shared memory only (the paged
//     cp.async path also the block table);
//   * the consumer pipeline of FlashAttention-3: tile i's S is issued,
//     then tile i-1's P.V; tile i's softmax runs while P.V is on the
//     tensor cores; O is rescaled once P.V lands, only if a row's max
//     moved.  The first S and the last P.V are peeled off the loop: a
//     wgmma issued under a condition, or an operand register written
//     while a product is in flight, makes ptxas serialise every wgmma
//     (its C7513/C7520 notes).  Warpgroups taking turns to issue
//     (FlashAttention-3's ping-pong) and Q held in registers measured
//     no faster, so neither is kept;
//   * a split over keys: when a call that is not causal (every key
//     live, as whisper's cross-attention) has (q-tiles x heads x B)
//     CTAs that leave more than a quarter of the SMs idle, each row's
//     keys are cut into ranges of whole tiles (flash_splits in ops.py,
//     from the shapes and the CTAs an SM holds, which
//     flash_bf16_occupancy reads from this file's compiled kernels, so
//     a step graph replays the same plan), each CTA writes fp32 (m, l,
//     O) partials and launch_decode_merge (shared with #1 and #3)
//     combines them; a row whose splits all have l = 0 comes out
//     exactly 0.  Causal calls never split: their live keys are a
//     prefix of the range that only the kernel sees (the paged entry's
//     max(q_pos) / bs), so ranges cut over the whole range would leave
//     the later splits empty;
//   * the G = H / K query heads of a kv head share the CTA's rows when G
//     divides them (each K/V tile is loaded once for the group); for
//     another G (internvl2-1b's 7) one head a CTA.
// What it gives ("NVIDIA H100 80GB HBM3, 700.00 W", chip_smoke.py,
// PERF.md section 6): the encoder at 0.190 ms (0.385 before;
// SDPA, a cuDNN wgmma kernel, 0.136), the cross-attention at 1 and 16
// queries 0.0246-0.0249 ms (2.7x their byte bound; SDPA 0.017 and
// 0.022), the serve's chunks 5-23% faster than the mma.sync body it
// replaces (scripts/flash_prefill_plans.py times every plan).  What
// remains: at head dim 64 a warpgroup's tile is a serial chain (Q.K^T,
// then the softmax) that three warpgroups hide only in part, and a
// few-query CTA waits on the pre-pass and its first loads before its
// first tile; 128-key tiles, an exp2 partly on the FMA pipes (as
// FlashAttention-4) and a persistent grid would shorten them.
//
// The fp32 body keeps the FMA design of the first port (32-row query
// tiles, 32-key fp32 tiles in shared memory, one head per CTA): the
// tensor cores would need TF32, whose 10-bit mantissa cannot hold the
// 1e-4 fp32 tolerance, and fp32 is the type of the CPU-parity server
// tests and of training, not of the serve.  It skips the same tiles as
// the bf16 body.  The wrapper picks the body by dtype alone.
//
// Head dims: 64 and 128 on both entries, and 120 (h2o-danube-3-4b) on
// the contiguous entry.  At 120 the bf16 body runs the 128-wide layout:
// TMA reads zeros past column 120, cp.async zero-fills the 16th chunk,
// zero columns add nothing to Q.K^T, and columns 120..127 of P.V are
// never stored.  Rows stay 16-byte aligned: 120 bf16 are 240 bytes.
//
// Masks, as the reference: kv_pos < 0 (empty, or a -1 table entry),
// causal on positions, the optional window, and on the contiguous entry
// segment equality with segment -1 = pad.  A fully masked query row
// outputs exactly 0.  The paged entry walks logical blocks 0 ..
// max(q_pos) // bs only: the paged-cache invariant that logical block j
// holds positions in [j*bs, (j+1)*bs) or -1 leaves past it only keys
// causality masks.

#include <cuda.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

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
// bf16 body: wgmma on the tensor cores, a producer warp filling a K/V ring
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kWgRows = 64;          // query rows per consumer warpgroup
constexpr int kWindowTiles = 32;     // K/V tiles one pre-pass summarises
constexpr int kBlockBytes = kKeys * 128;   // one 64-column block of a tile
constexpr int kPreUnroll = 8;        // half-tiles a warp summarises at once
constexpr int kPrefetchTiles = 8;    // tiles a CTA prefetches into L2

// The bf16 body's head dim: whole 64-column (128-byte) blocks.
constexpr int mma_hd(int hd) { return (hd + 63) / 64 * 64; }

// Shared memory of a CTA with NWG consumer warpgroups at head dim HDP:
// Q (64 rows a warpgroup) | the ring's K, V tiles | a window's key
// positions (-1: dead) and segments, its summaries (one int4 per 32
// keys) and its live tiles | the ring's full and empty barriers.  Tiles
// are 64-column blocks of 128-byte rows, 1024-byte aligned, in the
// 128-byte swizzle of TMA and of wgmma's descriptors.
template <int HDP, int NWG>
struct WgCfg {
  static constexpr int kThreads = NWG * 128 + 32;   // + the producer warp
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = NWG * kWgRows;
  // two CTAs an SM for one warpgroup at 64 columns, else one (the
  // pipelined consumer's registers; a four-stage ring)
  static constexpr int kMinBlocks = (NWG == 1 && HDP == 64) ? 2 : 1;
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kRows * HDP * 2;
  static constexpr int kTileBytes = kKeys * HDP * 2;
  static constexpr int kKVOff = kQBytes;
  static constexpr int kPosOff = kKVOff + kStages * 2 * kTileBytes;
  static constexpr int kSegOff = kPosOff + kWindowTiles * kKeys * 4;
  static constexpr int kSumOff = kSegOff + kWindowTiles * kKeys * 4;
  static constexpr int kListOff = kSumOff + 2 * kWindowTiles * 16;
  static constexpr int kBarOff = kListOff + kWindowTiles * 4;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + align
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "align");
};

// Byte offset of 16-byte chunk c of row r in a tile of 64 rows: 64-column
// blocks of 128-byte rows, chunk c % 8 stored at (c % 8) ^ (r % 8) (the
// 128-byte swizzle, on a 1024-byte aligned base).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t wg_desc(unsigned saddr, unsigned lbo,
                                            unsigned sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across the async product.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// ... and of P's registers, which an in-flight P.V reads.
template <int N>
__device__ __forceinline__ void wg_hold(unsigned (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) before
// async-proxy reads of them (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Holds the phase of `bar` open until every cp.async this thread has
// issued has landed (a pending arrival, added now and made then).
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// An arrival that also expects `bytes` from TMA copies on `bar`.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// TMA: the box at (c0, c1, c2, c3) of `map` into the L2 cache only.
__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* map,
                                                int c0, int c1, int c2,
                                                int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global [%0, {%1, %2, %3, %4}];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// TMA: the box at (c0, c1, c2, c3) of `map` into shared memory at dst,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Waits for the phase of `bar` with this parity to complete.  A wait
// that never ends (a fault in the ring's counts) traps after about 2^26
// tries, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Barrier of one consumer warpgroup (named barrier 1 + wg; 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
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

// d (+)= A * B^T: A (64 x 16) and B (N x 16) K-major in shared memory
// (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                            uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A * B: A (64 x 16 bf16) in registers in the accumulator's
// layout, B (16 x N) N-major in shared memory (descriptor db, transpose
// bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B: A (64 x 16 bf16) in registers in the accumulator's
// layout, B (16 x N) N-major in shared memory (descriptor db, transpose
// bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// One CTA: NWG * 64 (query, head) rows of one kv head over one split's
// range of key tiles.  Warps 0 .. 4 NWG - 1 are the consumer
// warpgroups (64 rows each: S = Q.K^T and O += P.V on wgmma, the online
// softmax in registers); the last warp is the producer (each live
// tile's K and V into the ring: TMA when all its keys are alive on the
// contiguous entry, else cp.async with dead keys zero-filled; the
// stage's full barrier completes when they land).  The key range is
// walked in windows of 32 tiles: all warps first summarise the window
// (each key's position and segment, each half-tile's position range,
// segment, whether all its keys are alive and whether some query can
// attend to one), then stream its live tiles.  With n_split > 1 each
// CTA writes its rows' fp32 (m, l, O) partials for launch_decode_merge.
template <int HD, bool PAGED, int NWG>
__global__ void __launch_bounds__(WgCfg<mma_hd(HD), NWG>::kThreads,
                                  WgCfg<mma_hd(HD), NWG>::kMinBlocks)
flash_kernel_wg(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos,
                const int* __restrict__ q_seg,
                const int* __restrict__ kv_seg,
                const int* __restrict__ block_tab,
                __nv_bfloat16* __restrict__ out,
                float* __restrict__ part_ml, float* __restrict__ part_acc,
                int Sq, int Skv, int H, int K, int bs, int nbt, int causal,
                int window, float scale_log2, float scale, int gp,
                int n_split, int split_tiles,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, int use_tma) {
  constexpr int HDP = mma_hd(HD);     // the body's head dim
  using C = WgCfg<HDP, NWG>;
  constexpr int ROWS = C::kRows;
  constexpr int NW = C::kWarps;
  constexpr int S = C::kStages;
  constexpr int KSTEPS = HDP / 16;    // k-steps of Q.K^T
  constexpr int NT_S = kKeys / 8;     // 8-column tiles of a score tile
  constexpr int NT_O = HDP / 8;       // ... of the output
  constexpr int CPR = HDP / 8;        // 16-byte chunks of a shared row
  constexpr int CPR_IN = HD / 8;      // ... of them read from a global row
  static_assert(HD % 8 == 0 && HDP % 64 == 0, "head dim");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* wpos = reinterpret_cast<int*>(sm + C::kPosOff);
  int* wseg = reinterpret_cast<int*>(sm + C::kSegOff);
  int4* hsum = reinterpret_cast<int4*>(sm + C::kSumOff);
  int* list = reinterpret_cast<int*>(sm + C::kListOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* empty = full + S;
  __shared__ int s_qpos[ROWS], s_qseg[ROWS], s_qok[ROWS];
  __shared__ int s_wmin[NW], s_wmax[NW], s_nlive;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool producer = warp == 4 * NWG;
  const int wg = producer ? 0 : warp >> 2;    // consumer warpgroup
  const int gtid = tid & 127;
  const int gwarp = warp & 3;
  const int QR = ROWS / gp;                    // queries per CTA
  const int q0 = blockIdx.x * QR;
  const int h0 = blockIdx.y * gp;              // first head of the CTA
  const int kvh = h0 / (H / K);
  const int b = blockIdx.z / n_split;
  const int split = blockIdx.z % n_split;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);          // the producer's lanes
      mbar_init(empty + s, 4 * NWG);    // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ---- Q rows (row R = query q0 + R / gp, head h0 + R % gp) -> smem ----
  unsigned char* qtile = sm + wg * (kWgRows * HDP * 2);
  if (!producer) {
    for (int idx = gtid; idx < kWgRows * CPR; idx += 128) {
      const int r = idx / CPR;
      const int c = idx % CPR;
      const int R = wg * kWgRows + r;
      const int qi = q0 + R / gp;
      const bool in = qi < Sq && c < CPR_IN;   // zero-fill the padding
      const __nv_bfloat16* src =
          in ? q + ((static_cast<size_t>(b) * Sq + qi) * H + h0 + R % gp) *
                           HD + c * 8
             : q;
      cp_async16(qtile + swz(r, c), src, in ? 16 : 0);
    }
    cp_async_commit();
  }

  // ---- the first tiles of the split's range into L2 while the pre-pass
  // reads positions (contiguous entry): a call that streams each key once
  // (few queries) then finds them there ----
  const int t_begin = split * split_tiles;
  if (!PAGED && use_tma && warp == 4 * NWG && lane == 0) {
    const int t_last = min((Skv + kKeys - 1) / kKeys, t_begin + split_tiles);
    for (int t = t_begin; t < min(t_last, t_begin + kPrefetchTiles); ++t)
#pragma unroll
      for (int blk = 0; blk < HDP / 64; ++blk) {
        tma_prefetch_4d(&tm_k, blk * 64, kvh, t * kKeys, b);
        tma_prefetch_4d(&tm_v, blk * 64, kvh, t * kKeys, b);
      }
  }

  // ---- the pre-pass's loads: each warp reads whole 32-key halves of a
  // window (kp = -1 for a dead key); the first window's are issued now,
  // over the split's keys up to all the kernel could walk, so that they
  // are in flight with the queries' rows ----
  int kp[kPreUnroll], sg[kPreUnroll];
  auto load_window = [&](int w0, int hb, int nt, int key_end) {
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int hh = hb + warp + u * NW;
      const int t = (2 * w0 + hh) * 32 + lane;
      int p = -1, g = -1;
      if (hh < 2 * nt && t < key_end) {
        if (PAGED) {
          const int phys = block_tab[static_cast<size_t>(b) * nbt + t / bs];
          if (phys >= 0) p = kv_pos[static_cast<size_t>(phys) * bs + t % bs];
        } else {
          p = kv_pos[static_cast<size_t>(b) * Skv + t];
          g = kv_seg[static_cast<size_t>(b) * Skv + t];
        }
      }
      kp[u] = p;
      sg[u] = g;
    }
  };
  {
    const int n_all = PAGED ? nbt * bs : Skv;
    const int nt = max(0, min(min((n_all + kKeys - 1) / kKeys,
                                  t_begin + split_tiles) - t_begin,
                              kWindowTiles));
    load_window(t_begin, 0, nt, min(n_all, (t_begin + nt) * kKeys));
  }

  int qmn = INT_MAX, qmx = INT_MIN;
  if (tid < ROWS) {
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
  __syncthreads();              // also publishes the barriers' init
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    qmin = min(qmin, s_wmin[w]);
    qmax = max(qmax, s_wmax[w]);
  }
  int n_kv = qmax == INT_MIN ? 0 : Skv;   // no valid query row: nothing
  if (PAGED) n_kv = qmax < 0 ? 0 : min(qmax / bs + 1, nbt) * bs;
  const int t_end =
      min((n_kv + kKeys - 1) / kKeys, t_begin + split_tiles);

  // ---- consumer row state: rows r0 = 16 gwarp + lane/4, r1 = r0 + 8 ----
  const int R0 = wg * kWgRows + gwarp * 16 + (lane >> 2);
  const int R1 = R0 + 8;
  const int qp0 = s_qpos[R0], qp1 = s_qpos[R1];
  const int qs0 = s_qseg[R0], qs1 = s_qseg[R1];
  const bool ok0 = s_qok[R0] != 0, ok1 = s_qok[R1] != 0;

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int c2 = 2 * (lane & 3);    // this thread's first column of a tile
  const unsigned q_addr = smem_addr(qtile);
  bool q_ready = false;
  int it = 0;                       // tiles through the ring so far

  for (int w0 = t_begin; w0 < t_end; w0 += kWindowTiles) {
    const int nt = min(t_end - w0, kWindowTiles);
    const int key_end = min(n_kv, (w0 + nt) * kKeys);
    // ---- pre-pass: summarise the window's 32-key halves ----
    // {min pos, max pos (alive keys), their one segment (INT_MIN if they
    // differ or one is dead), flags: 1 some query can attend, 2 all alive}
    for (int hb = 0; hb < 2 * nt; hb += kPreUnroll * NW) {
      if (w0 != t_begin || hb != 0) load_window(w0, hb, nt, key_end);
#pragma unroll
      for (int u = 0; u < kPreUnroll; ++u) {
        const int hh = hb + warp + u * NW;
        if (hh >= 2 * nt) continue;             // whole warps
        const int tw = hh * 32 + lane;          // the key in the window
        const int t = w0 * kKeys + tw;
        const bool al = t < key_end && kp[u] >= 0 && (PAGED || sg[u] >= 0);
        const int p = al ? kp[u] : -1;
        wpos[tw] = p;
        wseg[tw] = sg[u];
        const int kmn = __reduce_min_sync(0xffffffffu, al ? p : INT_MAX);
        const int kmx = __reduce_max_sync(0xffffffffu, al ? p : INT_MIN);
        const bool all = __all_sync(0xffffffffu, al);
        const int s0 = __shfl_sync(0xffffffffu, sg[u], 0);
        const bool uni = __all_sync(0xffffffffu, sg[u] == s0);
        const bool can = __any_sync(
            0xffffffffu, al && key_can_attend(p, qmin, qmax, causal, window));
        if (lane == 0)
          hsum[hh] = make_int4(kmn, kmx, all && uni ? s0 : INT_MIN,
                               (can ? 1 : 0) | (all ? 2 : 0));
      }
    }
    __syncthreads();
    if (warp == 0) {          // the window's live tiles, in order
      int n = 0;
      for (int base = 0; base < nt; base += 32) {
        const int j = base + lane;
        const bool live =
            j < nt && ((hsum[2 * j].w | hsum[2 * j + 1].w) & 1) != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        if (live) list[n + __popc(bal & ((1u << lane) - 1u))] = w0 + j;
        n += __popc(bal);
      }
      if (lane == 0) s_nlive = n;
    }
    __syncthreads();
    const int n_live = s_nlive;

    if (producer) {
      // ---- producer: the window's live tiles into the ring, in order;
      // it reads the pre-pass's positions, and the block table only on
      // the paged entry ----
      for (int i = 0; i < n_live; ++i) {
        const int j = list[i];
        const int s = (it + i) % S;
        const int use = (it + i) / S;
        const int t0 = (j - w0) * kKeys;        // the tile in the window
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* kd = sm + C::kKVOff + s * 2 * C::kTileBytes;
        unsigned char* vd = kd + C::kTileBytes;
        if (use_tma && (hsum[2 * (j - w0)].w & hsum[2 * (j - w0) + 1].w &
                        2)) {
          // every key alive (contiguous entry): TMA boxes of 64 columns
          // by the tile's 64 keys, issued by lane 0
          if (lane == 0) {
            mbar_arrive_expect(full + s, 2 * C::kTileBytes);
#pragma unroll
            for (int blk = 0; blk < HDP / 64; ++blk) {
              tma_load_4d(kd + blk * kBlockBytes, &tm_k, blk * 64, kvh,
                          j * kKeys, b, full + s);
              tma_load_4d(vd + blk * kBlockBytes, &tm_v, blk * 64, kvh,
                          j * kKeys, b, full + s);
            }
          } else {
            mbar_arrive(full + s);
          }
        } else {
          // lane l finds the rows of keys l and l + 32 (-1: dead), then
          // copies chunk l % 8 of each 64-column block of keys l / 8 +
          // 4 i (8 lanes read a key's 128 bytes); dead keys and the
          // padding of hd 120 are zero-filled
          int row[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = lane + 32 * u;
            const int t = j * kKeys + key;
            row[u] = -1;
            if (wpos[t0 + key] >= 0) {
              long long tok = static_cast<long long>(b) * Skv + t;
              if (PAGED)
                tok = static_cast<long long>(
                          block_tab[static_cast<size_t>(b) * nbt + t / bs]) *
                          bs + t % bs;
              row[u] = static_cast<int>(tok * K + kvh);
            }
          }
#pragma unroll
          for (int i2 = 0; i2 < kKeys / 4; ++i2) {
            const int key = (lane >> 3) + 4 * i2;
            const int r = __shfl_sync(0xffffffffu, row[i2 / 8], key & 31);
            const size_t base = r >= 0 ? static_cast<size_t>(r) * HD : 0;
#pragma unroll
            for (int blk = 0; blk < HDP / 64; ++blk) {
              const int c = (lane & 7) + 8 * blk;
              const bool ld = r >= 0 && c < CPR_IN;
              const size_t off = ld ? base + c * 8 : 0;
              cp_async16(kd + swz(key, c), k + off, ld ? 16 : 0);
              cp_async16(vd + swz(key, c), v + off, ld ? 16 : 0);
            }
          }
          mbar_track_cp_async(full + s);
          mbar_arrive(full + s);
        }
      }
    } else if (n_live > 0) {
      if (!q_ready) {
        cp_async_wait<0>();     // this thread's Q copies have landed
        fence_proxy_async();
        wg_sync(wg);            // everyone's have
        q_ready = true;
      }
      // Software pipeline (as FlashAttention-3's): tile i's S = Q.K^T is
      // issued, then tile i-1's O += P.V; the softmax of tile i runs
      // while P.V is on the tensor cores, and O is rescaled by tile i's
      // max change once that P.V has landed.  The first tile's S and the
      // last tile's P.V are peeled off the loop, so no wgmma is issued
      // under a condition (ptxas would serialise them).
      float sc[NT_S][4];                               // S, then P, of tile i
      unsigned pa[kKeys / 16][4];                      // P of tile i-1
      float a0 = 1.f, a1 = 1.f;                       // tile i's max change
      auto stage_addr = [&](int st) {
        return smem_addr(sm + C::kKVOff + st * 2 * C::kTileBytes);
      };
      auto s_issue = [&](int st) {
        const unsigned k_addr = stage_addr(st);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const unsigned off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
          wgmma_ss_n64(sc, wg_desc(q_addr + off, 16, 1024),
                       wg_desc(k_addr + off, 16, 1024), kk > 0);
        }
        wg_commit();
      };
      auto pv_issue = [&](int st) {
        const unsigned v_addr = stage_addr(st) + C::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs<HDP>(o, pa[kk],
                        wg_desc(v_addr + kk * 16 * 128, kBlockBytes, 1024));
        wg_commit();
      };
      auto arrive_full = [&](int i) {
        const int st = (it + i) % S;
        mbar_wait(full + st, ((it + i) / S) & 1);
        fence_proxy_async();
        return st;
      };
      // the masks (only for the rows the tile's summary cannot settle),
      // the online softmax of S in place, and the max change (a0, a1)
      auto softmax = [&](int j) {
        wg_hold(sc);
        const int* kpos = wpos + (j - w0) * kKeys;
        const int* kseg = wseg + (j - w0) * kKeys;
        const int4 ha = hsum[2 * (j - w0)], hb = hsum[2 * (j - w0) + 1];
        const int kmin = min(ha.x, hb.x), kmax = max(ha.y, hb.y);
        const bool all_alive = (ha.w & hb.w & 2) != 0;
        // per row: 2 = every key of the tile valid for it, 0 = none (a
        // padding row), 1 = check each key
        auto row_state = [&](bool ok, int qp, int qs) {
          if (!ok) return 0;
          return all_alive && (!causal || kmax <= qp) &&
                         (window <= 0 || kmin > qp - window) &&
                         (PAGED || (ha.z == qs && hb.z == qs))
                     ? 2
                     : 1;
        };
        const int st0 = row_state(ok0, qp0, qs0);
        const int st1 = row_state(ok1, qp1, qs1);
        if (st0 == 1 || st1 == 1) {
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
            const int2 kp2 =
                *reinterpret_cast<const int2*>(kpos + n * 8 + c2);
            const int2 ks2 =
                PAGED ? make_int2(0, 0)
                      : *reinterpret_cast<const int2*>(kseg + n * 8 + c2);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = e ? kp2.y : kp2.x;
              const int ks = e ? ks2.y : ks2.x;
              const bool v0 =
                  st0 == 2 ||
                  (st0 == 1 && kp >= 0 && (!causal || qp0 >= kp) &&
                   (window <= 0 || qp0 - kp < window) && (PAGED || ks == qs0));
              const bool v1 =
                  st1 == 2 ||
                  (st1 == 1 && kp >= 0 && (!causal || qp1 >= kp) &&
                   (window <= 0 || qp1 - kp < window) && (PAGED || ks == qs1));
              sc[n][e] = v0 ? sc[n][e] : -INFINITY;
              sc[n][2 + e] = v1 ? sc[n][2 + e] : -INFINITY;
            }
          }
        } else if (st0 == 0 || st1 == 0) {
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
            if (st0 == 0) sc[n][0] = sc[n][1] = -INFINITY;
            if (st1 == 0) sc[n][2] = sc[n][3] = -INFINITY;
          }
        }
        // row maxima and sums as trees (short dependence chains)
        float t0[NT_S], t1[NT_S];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          t0[n] = fmaxf(sc[n][0], sc[n][1]);
          t1[n] = fmaxf(sc[n][2], sc[n][3]);
        }
#pragma unroll
        for (int w = NT_S / 2; w > 0; w /= 2)
#pragma unroll
          for (int n = 0; n < w; ++n) {
            t0[n] = fmaxf(t0[n], t0[n + w]);
            t1[n] = fmaxf(t1[n], t1[n + w]);
          }
        float mx0 = t0[0], mx1 = t1[0];
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
        a0 = mn0 == m0 ? 1.f : ex2(fmaf(m0, scale_log2, -mu0));
        a1 = mn1 == m1 ? 1.f : ex2(fmaf(m1, scale_log2, -mu1));
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          sc[n][0] = ex2(fmaf(sc[n][0], scale_log2, -mu0));
          sc[n][1] = ex2(fmaf(sc[n][1], scale_log2, -mu0));
          sc[n][2] = ex2(fmaf(sc[n][2], scale_log2, -mu1));
          sc[n][3] = ex2(fmaf(sc[n][3], scale_log2, -mu1));
          t0[n] = sc[n][0] + sc[n][1];
          t1[n] = sc[n][2] + sc[n][3];
        }
#pragma unroll
        for (int w = NT_S / 2; w > 0; w /= 2)
#pragma unroll
          for (int n = 0; n < w; ++n) {
            t0[n] += t0[n + w];
            t1[n] += t1[n + w];
          }
        l0 = l0 * a0 + t0[0];
        l1 = l1 * a1 + t1[0];
      };
      // once the previous P.V has landed: O *= the max change, only if
      // some row's max moved (most tiles after the first few leave it in
      // place), and P (bf16) into P.V's A fragments (the accumulator's
      // fragments are its A fragments)
      auto rescale_and_take_p = [&]() {
        if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            o[n][0] *= a0;
            o[n][1] *= a0;
            o[n][2] *= a1;
            o[n][3] *= a1;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }
      };
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);   // the stage is free
      };

      int s_prev = arrive_full(0);
      wg_fence();
      s_issue(s_prev);
      wg_wait<0>();
      softmax(list[0]);
      rescale_and_take_p();
      for (int i = 1; i < n_live; ++i) {
        const int s = arrive_full(i);
          wg_fence();
        s_issue(s);
        pv_issue(s_prev);
          wg_wait<1>();           // S has landed; P.V may still run
        softmax(list[i]);
        wg_wait<0>();           // the previous tile's P.V has landed
        wg_hold(o);
        wg_hold(pa);
        release(s_prev);
        rescale_and_take_p();
        s_prev = s;
      }
      wg_fence();
      pv_issue(s_prev);
      wg_wait<0>();
      wg_hold(o);
      wg_hold(pa);
      release(s_prev);
    }
    it += n_live;
    __syncthreads();          // the window's summaries and list reused
  }
  if (producer) return;
  if (!q_ready) cp_async_wait<0>();

  // ---- write O / l, or the split's (m, l, O) partials ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? R1 : R0;
    const int qi = q0 + R / gp;
    if (qi >= Sq) continue;
    const float l = half ? l1 : l0;
    const float m = half ? m1 : m0;
    const size_t row = (static_cast<size_t>(b) * Sq + qi) * H + h0 + R % gp;
    if (n_split == 1) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat16* op = out + row * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)   // the real columns only
        *reinterpret_cast<unsigned*>(op + n * 8 + c2) =
            pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    } else {
      const size_t pr = row * n_split + split;
      float* pacc = part_acc + pr * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(pacc + n * 8 + c2) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
      if ((lane & 3) == 0) {
        part_ml[2 * pr] = m * scale;   // natural-log scale; -inf if l = 0
        part_ml[2 * pr + 1] = l;
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// extension links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map over bf16 K or V rows (hd, K kv heads, rows, outer) whose
// boxes are 64 columns (128 bytes, 128-byte swizzle) by `box_rows` rows
// of one kv head; columns and rows past the edges read as zeros.
inline cudaError_t kv_map(CUtensorMap* map, const void* base, int hd, int K,
                          int rows, int outer, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[3] = {row, row * K, row * K * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool PAGED, int NWG>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos,
                        const int* q_seg, const int* kv_seg,
                        const int* block_tab, void* out, float* part_ml,
                        float* part_acc, int B, int Sq, int Skv, int H,
                        int K, int bs, int nbt, int causal, int window,
                        float scale, int n_split, cudaStream_t stream) {
  using C = WgCfg<mma_hd(HD), NWG>;
  const int n_keys = PAGED ? nbt * bs : Skv;
  const int n_tiles = max(1, (n_keys + kKeys - 1) / kKeys);
  if (n_split < 1 || n_split > n_tiles ||
      static_cast<long long>(B) * n_split > 65535 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  auto kern = flash_kernel_wg<HD, PAGED, NWG>;
  const cudaError_t attr =
      allow_dynamic_smem(reinterpret_cast<const void*>(kern), C::kSmem);
  if (attr != cudaSuccess) return attr;
  // the G heads of a kv head share the CTA's rows when G divides them
  const int G = H / K;
  const int gp = C::kRows % G == 0 ? G : 1;
  const int qr = C::kRows / gp;
  const int per = (n_tiles + n_split - 1) / n_split;
  const dim3 grid((Sq + qr - 1) / qr, H / gp, B * n_split);
  // TMA maps (contiguous entry) over (hd, K, Skv, B): boxes of 64
  // columns by a tile's 64 keys, for the tiles whose keys are all alive
  CUtensorMap tm_k{}, tm_v{};
  const int use_tma = !PAGED && Skv > 0;
  if (use_tma) {
    cudaError_t e = kv_map(&tm_k, k, HD, K, Skv, B, kKeys);
    if (e == cudaSuccess) e = kv_map(&tm_v, v, HD, K, Skv, B, kKeys);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos, q_seg, kv_seg,
      block_tab, static_cast<__nv_bfloat16*>(out), part_ml, part_acc, Sq,
      Skv, H, K, bs, nbt, causal, window, scale * 1.4426950408889634f,
      scale, gp, n_split, per, tm_k, tm_v, use_tma);
  if (n_split == 1) return cudaSuccess;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_merge(part_ml, part_acc, out, B * Sq * H, HD, n_split,
                             kBFloat16, stream);
}

// Calls f(std::integral_constant<int, NWG>{}) for the bf16 body with
// `rows` = 64 NWG (query, head) rows a CTA: 64 or 128 rows, and 192 at
// head dim 64 only; cudaErrorNotSupported for any other row count.
template <int HD, class F>
cudaError_t with_rows(int rows, F&& f) {
  if (rows == 64) return f(std::integral_constant<int, 1>{});
  if (rows == 128) return f(std::integral_constant<int, 2>{});
  if constexpr (HD == 64) {
    if (rows == 192) return f(std::integral_constant<int, 3>{});
  }
  return cudaErrorNotSupported;
}

template <int HD, bool PAGED>
cudaError_t launch_bf16_rows(int rows, const void* q, const void* k,
                             const void* v, const int* q_pos,
                             const int* kv_pos, const int* q_seg,
                             const int* kv_seg, const int* block_tab,
                             void* out, float* part_ml, float* part_acc,
                             int B, int Sq, int Skv, int H, int K, int bs,
                             int nbt, int causal, int window, float scale,
                             int n_split, cudaStream_t stream) {
  return with_rows<HD>(rows, [&](auto nwg) {
    return launch_bf16<HD, PAGED, decltype(nwg)::value>(
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_tab, out, part_ml,
        part_acc, B, Sq, Skv, H, K, bs, nbt, causal, window, scale, n_split,
        stream);
  });
}

// CTAs of the bf16 body with `rows` rows an SM holds on the current
// device (its registers, shared memory and __launch_bounds__), as the
// occupancy calculator reads them from the compiled kernel.
template <int HD, bool PAGED>
cudaError_t bf16_ctas_per_sm(int rows, int* ctas) {
  return with_rows<HD>(rows, [&](auto nwg) {
    constexpr int NWG = decltype(nwg)::value;
    using C = WgCfg<mma_hd(HD), NWG>;
    auto kern = flash_kernel_wg<HD, PAGED, NWG>;
    const cudaError_t attr =
        allow_dynamic_smem(reinterpret_cast<const void*>(kern), C::kSmem);
    if (attr != cudaSuccess) return attr;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern,
                                                         C::kThreads,
                                                         C::kSmem);
  });
}

template <bool PAGED>
cudaError_t dispatch(int dtype, int hd, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     const int* q_seg, const int* kv_seg,
                     const int* block_tab, void* out, float* part_ml,
                     float* part_acc, int B, int Sq, int Skv, int H, int K,
                     int bs, int nbt, int causal, int window, float scale,
                     int rows, int n_split, cudaStream_t stream) {
  // K/V rows (token * K + kv head) are indexed in int32: a K tensor of
  // 2^31 rows of hd >= 64 elements would not fit in the card's memory.
#define REPRO_BF16_CASE(HD)                                                 \
  return launch_bf16_rows<HD, PAGED>(rows, q, k, v, q_pos, kv_pos, q_seg,  \
                                     kv_seg, block_tab, out, part_ml,      \
                                     part_acc, B, Sq, Skv, H, K, bs, nbt,  \
                                     causal, window, scale, n_split, stream)
#define REPRO_FP32_CASE(HD)                                                 \
  return launch_fp32<HD, PAGED>(q, k, v, q_pos, kv_pos, q_seg, kv_seg,     \
                                block_tab, out, B, Sq, Skv, H, K, bs, nbt, \
                                causal, window, scale, stream)
  if (dtype == kBFloat16) {
    if (hd == 64) REPRO_BF16_CASE(64);
    if (hd == 128) REPRO_BF16_CASE(128);
  } else if (dtype == kFloat32 && n_split == 1) {     // the FMA body: no split
    if (hd == 64) REPRO_FP32_CASE(64);
    if (hd == 128) REPRO_FP32_CASE(128);
  }
  if constexpr (!PAGED) {               // head dim 120: contiguous only
    if (hd == 120 && dtype == kBFloat16) REPRO_BF16_CASE(120);
    if (hd == 120 && dtype == kFloat32 && n_split == 1) REPRO_FP32_CASE(120);
  }
#undef REPRO_BF16_CASE
#undef REPRO_FP32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_flash_prefill(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, const int* q_seg, const int* kv_seg, void* out,
    float* part_ml, float* part_acc, int B, int Sq, int Skv, int H, int K,
    int hd, int causal, int window, float scale, int dtype, int rows,
    int n_split, cudaStream_t stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  return repro_torch::dispatch<false>(dtype, hd, q, k, v, q_pos, kv_pos,
                                      q_seg, kv_seg, nullptr, out, part_ml,
                                      part_acc, B, Sq, Skv, H, K, 1, 1,
                                      causal, window, scale, rows, n_split,
                                      stream);
}

cudaError_t launch_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* q_pos,
    void* out, float* part_ml, float* part_acc, int B, int Sq, int H, int K,
    int hd, int bs, int nbt, int window, float scale, int dtype, int rows,
    int n_split, cudaStream_t stream) {
  if (K <= 0 || H % K != 0 || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  return repro_torch::dispatch<true>(dtype, hd, q, k_pool, v_pool, q_pos,
                                     kv_pos_pool, nullptr, nullptr,
                                     block_tab, out, part_ml, part_acc, B,
                                     Sq, nbt * bs, H, K, bs, nbt, 1, window,
                                     scale, rows, n_split, stream);
}

cudaError_t flash_bf16_occupancy(int hd, int paged, int rows, int* ctas) {
  *ctas = 0;
  cudaError_t err = cudaErrorNotSupported;
  if (hd == 64)
    err = paged ? repro_torch::bf16_ctas_per_sm<64, true>(rows, ctas)
                : repro_torch::bf16_ctas_per_sm<64, false>(rows, ctas);
  else if (hd == 128)
    err = paged ? repro_torch::bf16_ctas_per_sm<128, true>(rows, ctas)
                : repro_torch::bf16_ctas_per_sm<128, false>(rows, ctas);
  else if (hd == 120 && !paged)
    err = repro_torch::bf16_ctas_per_sm<120, false>(rows, ctas);
  return err == cudaErrorNotSupported ? cudaSuccess : err;
}

int flash_bf16_tile_keys() { return repro_torch::kKeys; }
