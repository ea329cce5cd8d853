// Flash prefill attention for Hopper (sm_90a): one kernel, two entries,
// one body on wgmma for bf16 and, as split-precision TF32, for fp32.
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
//   1000 keys, hd 128 and 120) sit between them.  In fp32 (training)
//   the products are three TF32 products each: operations, at 495
//   TFLOP/s (minicpm-2b's training forward, 2 x 512 causal at 36 heads
//   of 64: 3 x 2.42 GFLOP, 0.0147 ms).
// The body, for both entries, causal or not, every head dim (bf16; the
// fp32 paragraph below says what differs):
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
//     flash_occupancy reads from this file's compiled kernels, so
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
// The fp32 body is the same kernel instantiated for float: the same
// producer, ring, pre-pass, tile skip, consumer order, rows by waves and
// splits.  Both products run on the tensor cores as split-precision
// TF32 (3xTF32): each operand x = big + small, big the nearest TF32
// value (ties away from zero: what cvt.rna.tf32.f32 gives for finite x,
// computed with an integer add and mask, as the cvt itself timed slow
// on the split's path in development builds), small the exact fp32
// remainder, of which the tensor cores read the leading TF32 bits;
// small.big + big.small + big.big is summed, small.small dropped.  That
// holds fp32's accuracy (about 1e-6 of a head vector's largest element,
// where one TF32 product is 1e-3 off: tests/test_torch_flash_tf32.py)
// whatever torch's allow_tf32 flag says.  What differs from bf16:
//   * wgmma reads a TF32 operand from shared memory only K-major (no
//     transpose bit) and only as it is stored, so every stage is split
//     by the consumers once it lands: K in place into its big part and a
//     small tile (K-major for S = Q.K^T as loaded); V transposed into
//     V^T big and small tiles, the K-major B of O += P.V, each group of 8
//     keys in the order 0 2 4 6 1 3 5 7, in which a thread's S columns
//     (2t, 2t + 1) of each 8 are its A fragment's k-indices (t, t + 4),
//     so P goes from the S registers into P.V's A operand (big and
//     small) without a shuffle.  Q is split once a CTA, into two tiles.
//   * a stage holds one tile's K and the previous live tile's V (raw V
//     lands in the K-small slot and is transposed out of it before K's
//     small part is written there), so S(i) and P.V(i-1), issued
//     together, read one stage and free it together.  Four fp32 tiles a
//     stage and Q's two tiles leave room for two stages at head dim 64
//     and one at 128 (where a tile's loads wait for the previous tile),
//     and for CTAs of 64 rows, or 128 at head dim 64.
//   * the split is shared by every consumer warp of the CTA (two named
//     barriers a tile) and sits on each tile's critical path, with the
//     three products of each (m64n64k8 for S, both operands read from
//     shared memory).
// What it gives (chip_smoke.py and scripts/flash_prefill_plans.py,
// PERF.md section 6): the training forward 3.4x faster than the FMA
// body it replaces, and under SDPA's fp32 time; the other fp32 shapes
// the FMA body served 4-6x faster.  What remains: a converter warpgroup
// (the split off the consumers' path), Q.K^T with Q from registers, and
// a third stage.  The wrapper picks the body by dtype alone.
//
// Head dims: 64 and 128 on both entries, and 120 (h2o-danube-3-4b) on
// the contiguous entry.  At 120 the body runs the 128-wide layout: TMA
// reads zeros past column 120, cp.async zero-fills the chunks past it,
// zero columns add nothing to Q.K^T, and columns 120..127 of P.V are
// never stored.  Rows stay 16-byte aligned: 120 bf16 are 240 bytes, 120
// fp32 480.
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

// Whether a key at position kp can be valid for some query of a tile
// whose valid rows span positions [qmin, qmax].
__device__ __forceinline__ bool key_can_attend(int kp, int qmin, int qmax,
                                               int causal, int window) {
  return kp >= 0 && (!causal || kp <= qmax) &&
         (window <= 0 || kp > qmin - window);
}

// ---------------------------------------------------------------------------
// the body: wgmma on the tensor cores, a producer warp filling a K/V ring
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kWgRows = 64;          // query rows per consumer warpgroup
constexpr int kWindowTiles = 32;     // K/V tiles one pre-pass summarises
constexpr int kBlockBytes = kKeys * 128;   // a 128-byte column block
constexpr int kPreUnroll = 8;        // half-tiles a warp summarises at once
constexpr int kPrefetchTiles = 8;    // tiles a CTA prefetches into L2

// The body's head dim: whole 64-column blocks.
constexpr int mma_hd(int hd) { return (hd + 63) / 64 * 64; }

// Shared memory of a CTA of element type T with NWG consumer warpgroups
// at head dim HDP: Q (64 rows a warpgroup; fp32: its tf32 big, then
// small part) | the ring's stages | a window's key positions (-1: dead)
// and segments, its summaries (one int4 per 32 keys) and its live tiles
// | the ring's full and empty barriers.  A bf16 stage is one tile's K
// and V; an fp32 stage is K's big and small parts, then V^T's big and
// small parts (see the source note).  Tiles are 128-byte column blocks
// of 128-byte rows, 1024-byte aligned, in the 128-byte swizzle of TMA
// and of wgmma's descriptors.
template <typename T, int HDP, int NWG>
struct WgCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kThreads = NWG * 128 + 32;   // + the producer warp
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = NWG * kWgRows;
  // two CTAs an SM for one bf16 warpgroup at 64 columns, else one (the
  // pipelined consumer's registers; shared memory)
  static constexpr int kMinBlocks = (!kF32 && NWG == 1 && HDP == 64) ? 2 : 1;
  // bf16: a four-stage ring; an fp32 stage is four tiles of twice the
  // bytes, so two stages at head dim 64 and one at 128
  static constexpr int kStages = kF32 ? (HDP == 64 ? 2 : 1) : 4;
  static constexpr int kQTileBytes = kWgRows * HDP * int(sizeof(T));
  static constexpr int kQBytes = NWG * kQTileBytes * (kF32 ? 2 : 1);
  static constexpr int kTileBytes = kKeys * HDP * int(sizeof(T));
  static constexpr int kStageBytes = (kF32 ? 4 : 2) * kTileBytes;
  static constexpr int kKVOff = kQBytes;
  static constexpr int kPosOff = kKVOff + kStages * kStageBytes;
  static constexpr int kSegOff = kPosOff + kWindowTiles * kKeys * 4;
  static constexpr int kSumOff = kSegOff + kWindowTiles * kKeys * 4;
  static constexpr int kListOff = kSumOff + 2 * kWindowTiles * 16;
  static constexpr int kBarOff = kListOff + kWindowTiles * 4;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + align
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "align");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows:
// 128-byte column blocks of 128-byte rows, chunk c % 8 stored at (c % 8)
// ^ (r % 8) (the 128-byte swizzle, on a 1024-byte aligned base).  ROWS
// is a template argument so that the 64-row form folds to a constant
// block stride before ptxas sees it (as a runtime argument the bf16
// producer's addresses came out in a different order).
template <int ROWS = kKeys>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
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

// Barrier of all NWG consumer warpgroups (named barrier NWG + 1).
template <int NWG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(NWG + 1), "n"(NWG * 128)
               : "memory");
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

// x = big + small for 3xTF32: big the nearest TF32 value, ties away
// from zero (cvt.rna.tf32.f32's value for finite x: half of the 13
// dropped bits added to the magnitude, then dropped), small the exact
// fp32 remainder, of which the tensor cores read the leading TF32 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
__device__ __forceinline__ void split_tf32(const float4& x, float4& big,
                                           float4& small) {
  unsigned b[4], s[4];
  split_tf32(x.x, b[0], s[0]);
  split_tf32(x.y, b[1], s[1]);
  split_tf32(x.z, b[2], s[2]);
  split_tf32(x.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                      __uint_as_float(s[2]), __uint_as_float(s[3]));
}

// The accumulator operands of an m64nN product: N / 8 tiles of 4.
#define REPRO_D8(d)                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),             \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),         \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),         \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),         \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),         \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),         \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),         \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define REPRO_D16(d)                                                       \
  REPRO_D8(d), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),               \
      "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]),         \
      "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]),      \
      "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),     \
      "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),     \
      "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),     \
      "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]),     \
      "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]),     \
      "+f"(d[15][3])
#define REPRO_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define REPRO_R64                                                          \
  REPRO_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "  \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// S (+)= A * B^T over one 32-byte k-step (16 bf16 or 8 tf32): A (64 rows)
// and B (64 rows) K-major in shared memory (descriptors da, db);
// scale_d = 0 overwrites S.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                            uint64_t da, uint64_t db,
                                            int scale_d) {
  if constexpr (std::is_same<T, float>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" REPRO_R32 "}, %32, %33, p, 1, 1;\n}\n"
        : REPRO_D8(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" REPRO_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : REPRO_D8(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// O += A * B over one 32-byte k-step: A (64 rows) from registers in the
// accumulator's layout (bf16 pairs) or in tf32's A-fragment layout, B
// (N columns) in shared memory: bf16 N-major (descriptor with the
// transpose bit), tf32 K-major (no transpose exists for tf32).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if constexpr (N == 64 && F32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" REPRO_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : REPRO_D8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" REPRO_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : REPRO_D8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (F32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" REPRO_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : REPRO_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" REPRO_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : REPRO_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
#undef REPRO_D8
#undef REPRO_D16
#undef REPRO_R32
#undef REPRO_R64

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
// T = float runs both products as 3xTF32: an fp32 stage holds one
// tile's K and the previous live tile's V, each split into tf32 big and
// small tiles by the consumers once it lands (V transposed, as tf32's B
// operand must be K-major), so S(i) and P.V(i-1) read one stage.
template <typename T, int HD, bool PAGED, int NWG>
__global__ void __launch_bounds__(WgCfg<T, mma_hd(HD), NWG>::kThreads,
                                  WgCfg<T, mma_hd(HD), NWG>::kMinBlocks)
flash_kernel_wg(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos,
                const int* __restrict__ q_seg,
                const int* __restrict__ kv_seg,
                const int* __restrict__ block_tab, T* __restrict__ out,
                float* __restrict__ part_ml, float* __restrict__ part_acc,
                int Sq, int Skv, int H, int K, int bs, int nbt, int causal,
                int window, float scale_log2, float scale, int gp,
                int n_split, int split_tiles,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, int use_tma) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int HDP = mma_hd(HD);     // the body's head dim
  using C = WgCfg<T, HDP, NWG>;
  constexpr int ROWS = C::kRows;
  constexpr int NW = C::kWarps;
  constexpr int S = C::kStages;
  constexpr int E16 = 16 / int(sizeof(T));   // elements in 16 bytes
  constexpr int KSTEPS = HDP / (2 * E16);    // 32-byte k-steps of Q.K^T
  constexpr int PSTEPS = kKeys / (2 * E16);  // ... of P.V
  constexpr int NT_S = kKeys / 8;     // 8-column tiles of a score tile
  constexpr int NT_O = HDP / 8;       // ... of the output
  constexpr int CPR = HDP / E16;      // 16-byte chunks of a shared row
  constexpr int CPR_IN = HD / E16;    // ... of them read from a global row
  constexpr int NBLK = CPR / 8;       // 128-byte column blocks of a row
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
  // (fp32: the rows as loaded become their tf32 big part, and the small
  // part follows in a tile of its own)
  unsigned char* qtile = sm + wg * C::kQBytes / NWG;
  if (!producer) {
    for (int idx = gtid; idx < kWgRows * CPR; idx += 128) {
      const int r = idx / CPR;
      const int c = idx % CPR;
      const int R = wg * kWgRows + r;
      const int qi = q0 + R / gp;
      const bool in = qi < Sq && c < CPR_IN;   // zero-fill the padding
      const T* src =
          in ? q + ((static_cast<size_t>(b) * Sq + qi) * H + h0 + R % gp) *
                           HD + c * E16
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
      for (int blk = 0; blk < NBLK; ++blk) {
        tma_prefetch_4d(&tm_k, blk * 8 * E16, kvh, t * kKeys, b);
        tma_prefetch_4d(&tm_v, blk * 8 * E16, kvh, t * kKeys, b);
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
      // the paged entry.  A tile whose keys are all alive (contiguous
      // entry) comes by TMA: boxes of 128 bytes of columns by its 64
      // keys, issued by lane 0; any other by cp.async ----
      auto alive = [&](int j) {
        return use_tma &&
               (hsum[2 * (j - w0)].w & hsum[2 * (j - w0) + 1].w & 2) != 0;
      };
      auto tma_tile = [&](unsigned char* dst, const CUtensorMap* map,
                          int j, uint64_t* bar) {
#pragma unroll
        for (int blk = 0; blk < NBLK; ++blk)
          tma_load_4d(dst + blk * kBlockBytes, map, blk * 8 * E16, kvh,
                      j * kKeys, b, bar);
      };
      // lane l finds the rows of tile j's keys l and l + 32 (-1: dead)
      auto key_rows = [&](int j, int (&row)[2]) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = lane + 32 * u;
          const int t = j * kKeys + key;
          row[u] = -1;
          if (wpos[(j - w0) * kKeys + key] >= 0) {
            long long tok = static_cast<long long>(b) * Skv + t;
            if (PAGED)
              tok = static_cast<long long>(
                        block_tab[static_cast<size_t>(b) * nbt + t / bs]) *
                        bs + t % bs;
            row[u] = static_cast<int>(tok * K + kvh);
          }
        }
      };
      // ... then copies chunk l % 8 of each 128-byte block of keys l / 8
      // + 4 i of src (8 lanes read a key's 128 bytes); dead keys and the
      // padding of hd 120 are zero-filled
      auto cp_tile = [&](unsigned char* dst, const T* src,
                         const int (&row)[2]) {
#pragma unroll
        for (int i2 = 0; i2 < kKeys / 4; ++i2) {
          const int key = (lane >> 3) + 4 * i2;
          const int r = __shfl_sync(0xffffffffu, row[i2 / 8], key & 31);
          const size_t base = r >= 0 ? static_cast<size_t>(r) * HD : 0;
#pragma unroll
          for (int blk = 0; blk < NBLK; ++blk) {
            const int c = (lane & 7) + 8 * blk;
            const bool ld = r >= 0 && c < CPR_IN;
            const size_t off = ld ? base + c * E16 : 0;
            cp_async16(dst + swz(key, c), src + off, ld ? 16 : 0);
          }
        }
      };
      if constexpr (!F32) {
        for (int i = 0; i < n_live; ++i) {
          const int j = list[i];
          const int s = (it + i) % S;
          const int use = (it + i) / S;
          const int t0 = (j - w0) * kKeys;        // the tile in the window
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          unsigned char* kd = sm + C::kKVOff + s * C::kStageBytes;
          unsigned char* vd = kd + C::kTileBytes;
          if (use_tma && (hsum[2 * (j - w0)].w & hsum[2 * (j - w0) + 1].w &
                          2)) {
            // every key alive (contiguous entry): TMA, issued by lane 0
            if (lane == 0) {
              mbar_arrive_expect(full + s, 2 * C::kTileBytes);
#pragma unroll
              for (int blk = 0; blk < NBLK; ++blk) {
                tma_load_4d(kd + blk * kBlockBytes, &tm_k, blk * 8 * E16,
                            kvh, j * kKeys, b, full + s);
                tma_load_4d(vd + blk * kBlockBytes, &tm_v, blk * 8 * E16,
                            kvh, j * kKeys, b, full + s);
              }
            } else {
              mbar_arrive(full + s);
            }
          } else {
            // key_rows and cp_tile written out with K and V copied
            // together: through the lambdas the paged entry timed slower
            // in development builds
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
                            block_tab[static_cast<size_t>(b) * nbt +
                                      t / bs]) * bs + t % bs;
                row[u] = static_cast<int>(tok * K + kvh);
              }
            }
#pragma unroll
            for (int i2 = 0; i2 < kKeys / 4; ++i2) {
              const int key = (lane >> 3) + 4 * i2;
              const int r =
                  __shfl_sync(0xffffffffu, row[i2 / 8], key & 31);
              const size_t base =
                  r >= 0 ? static_cast<size_t>(r) * HD : 0;
#pragma unroll
              for (int blk = 0; blk < NBLK; ++blk) {
                const int c = (lane & 7) + 8 * blk;
                const bool ld = r >= 0 && c < CPR_IN;
                const size_t off = ld ? base + c * E16 : 0;
                cp_async16(kd + swz(key, c), k + off, ld ? 16 : 0);
                cp_async16(vd + swz(key, c), v + off, ld ? 16 : 0);
              }
            }
            mbar_track_cp_async(full + s);
            mbar_arrive(full + s);
          }
        }
      } else {
        // stage i: tile i's K (i < n_live) and tile i-1's V (i > 0), raw,
        // in the stage's K-big and K-small slots, where the consumers
        // split them
        for (int i = 0; i < (n_live > 0 ? n_live + 1 : 0); ++i) {
          const int s = (it + i) % S;
          const int use = (it + i) / S;
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          unsigned char* kd = sm + C::kKVOff + s * C::kStageBytes;
          unsigned char* vd = kd + C::kTileBytes;
          const bool has_k = i < n_live, has_v = i > 0;
          const int jk = has_k ? list[i] : 0, jv = has_v ? list[i - 1] : 0;
          const bool tk = has_k && alive(jk), tv = has_v && alive(jv);
          int row[2];
          if (has_k && !tk) {
            key_rows(jk, row);
            cp_tile(kd, k, row);
          }
          if (has_v && !tv) {
            key_rows(jv, row);
            cp_tile(vd, v, row);
          }
          if ((has_k && !tk) || (has_v && !tv))
            mbar_track_cp_async(full + s);
          // lane 0 arrives after its copies, expecting the TMA bytes
          if (lane == 0 && (tk || tv)) {
            mbar_arrive_expect(full + s, (tk + tv) * C::kTileBytes);
            if (tk) tma_tile(kd, &tm_k, jk, full + s);
            if (tv) tma_tile(vd, &tm_v, jv, full + s);
          } else {
            mbar_arrive(full + s);
          }
        }
      }
    } else if (n_live > 0) {
      if (!q_ready) {
        cp_async_wait<0>();     // this thread's Q copies have landed
        if constexpr (F32) {    // ... split into tf32 big and small parts
          for (int idx = gtid; idx < kWgRows * CPR; idx += 128) {
            const int off = swz(idx / CPR, idx % CPR);
            float4* x = reinterpret_cast<float4*>(qtile + off);
            float4 big, small;
            split_tf32(*x, big, small);
            *x = big;
            *reinterpret_cast<float4*>(qtile + C::kQTileBytes + off) = small;
          }
        }
        fence_proxy_async();
        wg_sync(wg);            // everyone's have
        q_ready = true;
      }
      // Software pipeline (as FlashAttention-3's): tile i's S = Q.K^T is
      // issued, then tile i-1's O += P.V; the softmax of tile i runs
      // while P.V is on the tensor cores, and O is rescaled by tile i's
      // max change once that P.V has landed.  The first tile's S and the
      // last tile's P.V are peeled off the loop, so no wgmma is issued
      // under a condition (ptxas would serialise them).  fp32 runs each
      // product as three tf32 products, small.big + big.small + big.big,
      // small.small dropped (3xTF32).
      float sc[NT_S][4];                               // S, then P, of tile i
      unsigned pa[PSTEPS][4];        // P of tile i-1 (fp32: its big part)
      unsigned ps[F32 ? PSTEPS : 1][4];    // fp32: ... its small part
      float a0 = 1.f, a1 = 1.f;                       // tile i's max change
      auto stage_addr = [&](int st) {
        return smem_addr(sm + C::kKVOff + st * C::kStageBytes);
      };
      auto s_issue = [&](int st) {
        const unsigned k_addr = stage_addr(st);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const unsigned off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
          const uint64_t qd = wg_desc(q_addr + off, 16, 1024);
          const uint64_t kd = wg_desc(k_addr + off, 16, 1024);
          if constexpr (F32) {    // small.big, big.small, then big.big
            wgmma_ss_n64<T>(
                sc, wg_desc(q_addr + C::kQTileBytes + off, 16, 1024), kd,
                kk > 0);
            wgmma_ss_n64<T>(
                sc, qd, wg_desc(k_addr + C::kTileBytes + off, 16, 1024), 1);
          }
          wgmma_ss_n64<T>(sc, qd, kd, F32 || kk > 0);
        }
        wg_commit();
      };
      auto pv_issue = [&](int st) {
        const unsigned v_addr =
            stage_addr(st) + (F32 ? 2 : 1) * C::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk) {
          if constexpr (F32) {
            // V^T: HDP rows of 64 keys, K-major, 32 keys a 128-byte block
            const unsigned off = (kk >> 2) * (HDP * 128) + (kk & 3) * 32;
            const uint64_t vb = wg_desc(v_addr + off, 16, 1024);
            wgmma_rs<T, HDP>(o, ps[kk], vb);
            wgmma_rs<T, HDP>(
                o, pa[kk], wg_desc(v_addr + C::kTileBytes + off, 16, 1024));
            wgmma_rs<T, HDP>(o, pa[kk], vb);
          } else {
            wgmma_rs<T, HDP>(
                o, pa[kk], wg_desc(v_addr + kk * 16 * 128, kBlockBytes, 1024));
          }
        }
        wg_commit();
      };
      auto arrive_full = [&](int i) {
        const int st = (it + i) % S;
        mbar_wait(full + st, ((it + i) / S) & 1);
        fence_proxy_async();
        return st;
      };
      // fp32: stage st's raw V (has_v, landed in the K-small slot)
      // transposed into V^T big and small tiles, each group of 8 keys
      // stored in the order 0 2 4 6 1 3 5 7, the order in which P's
      // accumulator registers are its A fragments; then its raw K (has_k)
      // split in place into its big part and a small tile.  Every
      // consumer thread takes a share; they meet at a named barrier once
      // all raw V is read and once the split tiles are written.
      auto convert = [&](int st, bool has_k, bool has_v) {
        if constexpr (F32) {
          constexpr int NC = NWG * 128;
          constexpr int NB = kKeys / 4 * CPR;     // 4 x 4 blocks of V
          static_assert(NB % NC == 0 && kKeys * CPR % NC == 0, "shares");
          unsigned char* kb = sm + C::kKVOff + st * C::kStageBytes;
          unsigned char* ks = kb + C::kTileBytes;
          unsigned char* vb = ks + C::kTileBytes;
          unsigned char* vs = vb + C::kTileBytes;
          // x[j] (keys k0 + 2j, columns 4c .. 4c + 3) -> V^T rows 4c + e,
          // 16-byte chunk `quad` (key positions 4 quad .. 4 quad + 3)
          auto put = [&](unsigned char* dst, int c, int quad,
                         const float4 (&x)[4]) {
            *reinterpret_cast<float4*>(dst + swz<HDP>(4 * c, quad)) =
                make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
            *reinterpret_cast<float4*>(dst + swz<HDP>(4 * c + 1, quad)) =
                make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
            *reinterpret_cast<float4*>(dst + swz<HDP>(4 * c + 2, quad)) =
                make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
            *reinterpret_cast<float4*>(dst + swz<HDP>(4 * c + 3, quad)) =
                make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
          };
          if (has_v) {
            // block b: keys 8g + h + 2j (j < 4) at columns 4c .. 4c + 3;
            // the eight blocks of a quarter-warp take c = c0 + 2m and g =
            // g0 + m (m < 4), h = 0 and 1: no bank conflict on either side
#pragma unroll
            for (int u = 0; u < NB / NC; ++u) {
              const int bi = tid + u * NC;
              const int m = bi & 3, h = (bi >> 2) & 1;
              const int g = ((bi >> 3) + m) & 7;
              const int ci = bi >> 6;
              const int c = (ci >> 1) * 8 + (ci & 1) + 2 * m;
              float4 hi[4], lo[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                split_tf32(*reinterpret_cast<const float4*>(
                               ks + swz(8 * g + h + 2 * j, c)),
                           hi[j], lo[j]);
              put(vb, c, 2 * g + h, hi);
              put(vs, c, 2 * g + h, lo);
            }
          }
          consumers_sync<NWG>();    // raw V read before K's small part lands
          if (has_k) {
#pragma unroll
            for (int idx = tid; idx < kKeys * CPR; idx += NC) {
              const int off = swz(idx / CPR, idx % CPR);
              float4* x = reinterpret_cast<float4*>(kb + off);
              float4 big, small;
              split_tf32(*x, big, small);
              *x = big;
              *reinterpret_cast<float4*>(ks + off) = small;
            }
          }
          fence_proxy_async();
          consumers_sync<NWG>();    // the split tiles before any wgmma
        }
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
      // place), and P into P.V's A fragments: bf16 pairs packed (the
      // accumulator's fragments are its A fragments); fp32 split into big
      // and small parts, k-step kk's positions t and t + 4 being keys
      // 8 kk + 2t and 8 kk + 2t + 1 (V^T's key order)
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
        if constexpr (F32) {
#pragma unroll
          for (int kk = 0; kk < PSTEPS; ++kk) {
            split_tf32(sc[kk][0], pa[kk][0], ps[kk][0]);   // row g
            split_tf32(sc[kk][2], pa[kk][1], ps[kk][1]);   // row g + 8
            split_tf32(sc[kk][1], pa[kk][2], ps[kk][2]);
            split_tf32(sc[kk][3], pa[kk][3], ps[kk][3]);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < PSTEPS; ++kk) {
            pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
            pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
            pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
            pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
          }
        }
      };
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);   // the stage is free
      };

      if constexpr (F32) {
        // stage i holds tile i's K and tile i-1's V (see the producer), so
        // one stage feeds S(i) and P.V(i-1) and is released after both
        int s = arrive_full(0);
        convert(s, true, false);
        wg_fence();
        s_issue(s);
        wg_wait<0>();
        release(s);
        softmax(list[0]);
        rescale_and_take_p();
        for (int i = 1; i < n_live; ++i) {
          s = arrive_full(i);
          convert(s, true, true);
          wg_fence();
          s_issue(s);
          pv_issue(s);
          wg_wait<1>();           // S has landed; P.V may still run
          softmax(list[i]);
          wg_wait<0>();           // the previous tile's P.V has landed
          wg_hold(o);
          wg_hold(pa);
          wg_hold(ps);
          release(s);
          rescale_and_take_p();
        }
        s = arrive_full(n_live);
        convert(s, false, true);
        wg_fence();
        pv_issue(s);
        wg_wait<0>();
        wg_hold(o);
        wg_hold(pa);
        wg_hold(ps);
        release(s);
      } else {
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
    }
    it += F32 && n_live > 0 ? n_live + 1 : n_live;   // stages used
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
      T* op = out + row * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {   // the real columns only
        const float x = o[n][2 * half] * inv, y = o[n][2 * half + 1] * inv;
        if constexpr (F32)
          *reinterpret_cast<float2*>(op + n * 8 + c2) = make_float2(x, y);
        else
          *reinterpret_cast<unsigned*>(op + n * 8 + c2) = pack_bf16(x, y);
      }
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

// A TMA map over K or V rows of element type T (hd, K kv heads, rows,
// outer) whose boxes are 128 bytes of columns (128-byte swizzle) by
// `box_rows` rows of one kv head; columns and rows past the edges read
// as zeros.
template <typename T>
inline cudaError_t kv_map(CUtensorMap* map, const void* base, int hd, int K,
                          int rows, int outer, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[3] = {row, row * K, row * K * rows};
  const cuuint32_t box[4] = {128 / sizeof(T), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map,
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD, bool PAGED, int NWG>
cudaError_t launch_wg(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* kv_pos, const int* q_seg,
                      const int* kv_seg, const int* block_tab, void* out,
                      float* part_ml, float* part_acc, int B, int Sq,
                      int Skv, int H, int K, int bs, int nbt, int causal,
                      int window, float scale, int n_split,
                      cudaStream_t stream) {
  using C = WgCfg<T, mma_hd(HD), NWG>;
  const int n_keys = PAGED ? nbt * bs : Skv;
  const int n_tiles = max(1, (n_keys + kKeys - 1) / kKeys);
  if (n_split < 1 || n_split > n_tiles ||
      static_cast<long long>(B) * n_split > 65535 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  auto kern = flash_kernel_wg<T, HD, PAGED, NWG>;
  const cudaError_t attr =
      allow_dynamic_smem(reinterpret_cast<const void*>(kern), C::kSmem);
  if (attr != cudaSuccess) return attr;
  // the G heads of a kv head share the CTA's rows when G divides them
  const int G = H / K;
  const int gp = C::kRows % G == 0 ? G : 1;
  const int qr = C::kRows / gp;
  const int per = (n_tiles + n_split - 1) / n_split;
  const dim3 grid((Sq + qr - 1) / qr, H / gp, B * n_split);
  // TMA maps (contiguous entry) over (hd, K, Skv, B): boxes of 128 bytes
  // of columns by a tile's 64 keys, for the tiles whose keys are all alive
  CUtensorMap tm_k{}, tm_v{};
  const int use_tma = !PAGED && Skv > 0;
  if (use_tma) {
    cudaError_t e = kv_map<T>(&tm_k, k, HD, K, Skv, B, kKeys);
    if (e == cudaSuccess) e = kv_map<T>(&tm_v, v, HD, K, Skv, B, kKeys);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, q_seg, kv_seg, block_tab,
      static_cast<T*>(out), part_ml, part_acc, Sq, Skv, H, K, bs, nbt,
      causal, window, scale * 1.4426950408889634f, scale, gp, n_split, per,
      tm_k, tm_v, use_tma);
  if (n_split == 1) return cudaSuccess;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode_merge(part_ml, part_acc, out, B * Sq * H, HD, n_split,
                             std::is_same<T, float>::value ? kFloat32
                                                           : kBFloat16,
                             stream);
}

// Calls f(std::integral_constant<int, NWG>{}) for the body of element
// type T with `rows` = 64 NWG (query, head) rows a CTA: bf16 64 or 128
// rows, and 192 at head dim 64; fp32 64 rows, and 128 at head dim 64
// (shared memory: WgCfg); cudaErrorNotSupported for any other count.
template <typename T, int HD, class F>
cudaError_t with_rows(int rows, F&& f) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (rows == 64) return f(std::integral_constant<int, 1>{});
  if constexpr (!F32 || HD == 64) {
    if (rows == 128) return f(std::integral_constant<int, 2>{});
  }
  if constexpr (!F32 && HD == 64) {
    if (rows == 192) return f(std::integral_constant<int, 3>{});
  }
  return cudaErrorNotSupported;
}

template <typename T, int HD, bool PAGED>
cudaError_t launch_rows(int rows, const void* q, const void* k,
                        const void* v, const int* q_pos, const int* kv_pos,
                        const int* q_seg, const int* kv_seg,
                        const int* block_tab, void* out, float* part_ml,
                        float* part_acc, int B, int Sq, int Skv, int H,
                        int K, int bs, int nbt, int causal, int window,
                        float scale, int n_split, cudaStream_t stream) {
  return with_rows<T, HD>(rows, [&](auto nwg) {
    return launch_wg<T, HD, PAGED, decltype(nwg)::value>(
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_tab, out, part_ml,
        part_acc, B, Sq, Skv, H, K, bs, nbt, causal, window, scale, n_split,
        stream);
  });
}

// CTAs of the body of element type T with `rows` rows an SM holds on
// the current device (its registers, shared memory and
// __launch_bounds__), as the occupancy calculator reads them from the
// compiled kernel.
template <typename T, int HD, bool PAGED>
cudaError_t ctas_per_sm(int rows, int* ctas) {
  return with_rows<T, HD>(rows, [&](auto nwg) {
    constexpr int NWG = decltype(nwg)::value;
    using C = WgCfg<T, mma_hd(HD), NWG>;
    auto kern = flash_kernel_wg<T, HD, PAGED, NWG>;
    const cudaError_t attr =
        allow_dynamic_smem(reinterpret_cast<const void*>(kern), C::kSmem);
    if (attr != cudaSuccess) return attr;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern,
                                                         C::kThreads,
                                                         C::kSmem);
  });
}

// Calls f(T{}, std::integral_constant<int, HD>{}) for a body this entry
// has: bf16 or fp32 at head dim 64 or 128, and 120 on the contiguous
// entry; cudaErrorInvalidValue for any other.
template <bool PAGED, class F>
cudaError_t with_body(int dtype, int hd, F&& f) {
  auto by_hd = [&](auto t) {
    if (hd == 64) return f(t, std::integral_constant<int, 64>{});
    if (hd == 128) return f(t, std::integral_constant<int, 128>{});
    if constexpr (!PAGED) {
      if (hd == 120) return f(t, std::integral_constant<int, 120>{});
    }
    return cudaErrorInvalidValue;
  };
  if (dtype == kBFloat16) return by_hd(__nv_bfloat16{});
  if (dtype == kFloat32) return by_hd(float{});
  return cudaErrorInvalidValue;
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
  return with_body<PAGED>(dtype, hd, [&](auto t, auto h) {
    return launch_rows<decltype(t), decltype(h)::value, PAGED>(
        rows, q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_tab, out, part_ml,
        part_acc, B, Sq, Skv, H, K, bs, nbt, causal, window, scale, n_split,
        stream);
  });
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

cudaError_t flash_occupancy(int dtype, int hd, int paged, int rows,
                            int* ctas) {
  *ctas = 0;
  auto count = [&](auto pg) {
    constexpr bool PAGED = decltype(pg)::value;
    return repro_torch::with_body<PAGED>(dtype, hd, [&](auto t, auto h) {
      return repro_torch::ctas_per_sm<decltype(t), decltype(h)::value,
                                      PAGED>(rows, ctas);
    });
  };
  const cudaError_t err =
      paged ? count(std::true_type{}) : count(std::false_type{});
  // no body of that many rows, or no such body: 0 CTAs
  return err == cudaErrorNotSupported || err == cudaErrorInvalidValue
             ? cudaSuccess
             : err;
}

int flash_tile_keys() { return repro_torch::kKeys; }
