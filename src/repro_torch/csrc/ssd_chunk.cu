// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): two kernels.
//
// Replaces: repro/kernels/ssd_scan/kernel.py
//   ssd_chunk_pallas (body _ssd_kernel).
// Plain version: repro_torch/kernels/ssd_scan/ops.py ssd_chunk_plain.
//
// Per (batch·chunk bc, head h), with Ā = cumsum(dt·A) over the chunk's Q
// tokens and one B/C group shared by every head (n_groups = 1):
//   y[q, p]     = Σ_{k≤q} (C_q·B_k) · exp(Ā_q − Ā_k) · dt_k · x[k, p]
//   state[p, n] = Σ_k exp(Ā_last − Ā_k) · dt_k · B_k[n] · x[k, p]
// Inputs: x (BC, Q, nh, hp), dt (BC, Q, nh) fp32, A (nh,) fp32, B and C
// (BC·Q tokens at a row stride, ds contiguous: slices of the [B|C]
// projection are read in place); outputs y (BC, Q, nh, hp) and state
// (BC, nh, hp, ds) in fp32, the state in the SSM cache's order (the
// Pallas kernel writes (ds, hp) and its caller transposes).
//
// Exactness is the design's first constraint.  Every output element is
// summed in the plain version's order, one fp32 FMA at a time: C·Bᵀ over
// ds from 0, y over k from 0, the state over k from 0, with
// P = (C·Bᵀ) · exp(Ā_q − Ā_k) · dt_k (exactly 0 where k > q) and
// w∘x = (exp(Ā_last − Ā_k) · dt_k) · x multiplied in its order, and Ā by
// a sequential unfused scan in torch.cumsum's order.  So the kernel
// equals the plain version bit for bit, which the SSM serve's logit
// check needs: its random 48-layer bf16 model moves the first-token
// logits by 0.17 of the largest when the intra-chunk term is perturbed
// by 1e-7 relative, and by 0.21 when its sums are taken exactly (the
// arithmetic of a tensor-core design), against a 5e-2 limit
// (scripts/ssm_chunking_sensitivity.py --perturb).  No tensor core
// reproduces a sequential fp32 FMA chain, so this kernel uses none.
//
// What bounds it on the H100: one full-width chunk (Q = 256, 32 heads of
// 64, ds 128) moves about 4.3 MB, 1.3 µs at 3.35 TB/s; its FMAs — C·Bᵀ
// once per chunk (4.2 M on the causal half), y and the state 67 M each —
// take 4.1 µs at the 67 TFLOP/s fp32 peak.  So FMA issue bounds it, and
// the design spends FMAs only where the result needs them and keeps the
// card full:
//   * kernel 1 (`ssd_chunk_kernel_cb`) forms C·Bᵀ once per chunk for all
//     heads, in 32 × 32 tiles on or below the diagonal, into fp32
//     scratch the wrapper allocates; beside them one small CTA per head
//     runs that head's Ā scan, off every other CTA's path;
//   * kernel 2 (`ssd_chunk_kernel_out`) gives each (bc, h) ceil(n/2) "y"
//     CTAs, n = ceil(Q/32) query tiles, CTA u owning tiles u and n−1−u
//     (so every y CTA walks the same number of keys: the last tile no
//     longer sets the time), and ds/32 "state" CTAs that each own 32
//     columns of the state over all Q keys.  At full width that is
//     4 + 4 CTAs of about 0.52 M FMA per head, 256 in all, two to an SM
//     (about 103 KB of shared memory each);
//   * a y CTA issues every load at once — both tiles' C·Bᵀ rows by
//     cp.async, packed at their own widths, and x's rows into registers,
//     stored as fp32 — then turns the C·Bᵀ rows into P in place;
//   * inner loops read one operand as a warp-wide broadcast float4 (4
//     keys of P, or of w∘x) and the other as consecutive lanes.
// What holds it back now (H100, chip_smoke.py, torch.profiler and a
// clock64 probe of single CTAs, PERF.md): kernel 2, about 19 µs of the
// call's 25.6 (kernel 1: 3.6).  Both inner loops issue 0.375 shared-
// memory wavefronts per FFMA (an SM serves one a cycle against four
// FFMA), and a state CTA spends about 11K cycles in its loop at half
// the issue rate; the state CTAs set kernel 2's time.  More rows per
// thread would cut the wavefronts but leaves half a y CTA's threads
// idle on its short tile.
// ptxas (sm_90a, as `python -m repro_torch.kernels.build` builds it;
// bf16, hp 64, ds 128): kernel 1 44 registers, 33.8 KB static shared
// memory; kernel 2 76 registers, 2 KB static + about 103 KB dynamic
// (two CTAs an SM); no spills.
// A short chunk's padding tokens carry dt = 0 (the caller pads so), so
// they weigh nothing in y or state; rows past Q are masked here.

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kSsdThreads = 256;   // 8 warps
constexpr int kTile = 32;          // query rows / keys per tile
constexpr int kMaxQ = 256;
constexpr int kStateCols = 32;     // state columns per "state" CTA (≤ ds)
constexpr int kPLd = kMaxQ + 4;    // P / (w∘x)ᵀ row stride (float4 rows)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// 16-byte vector c of `row` widened to fp32 in o; zeros for a row past
// Q (not read).  bf16 is the top half of an fp32, so widening is a shift.
__device__ __forceinline__ void load_vec(float* o, const float* row, int c,
                                         bool live) {
  const float4 v = live ? *reinterpret_cast<const float4*>(row + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_vec(float* o, const __nv_bfloat16* row,
                                         int c, bool live) {
  const uint4 v = live ? *reinterpret_cast<const uint4*>(row + 8 * c)
                       : make_uint4(0u, 0u, 0u, 0u);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ---- kernel 1: C·Bᵀ tiles, once per chunk, and the nh Ā scans ----------

template <typename T, int DS>
__global__ void __launch_bounds__(kSsdThreads)
ssd_chunk_kernel_cb(const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    float* __restrict__ cb, float* __restrict__ acum, int Q,
                    int Qp, int nh, long long b_stride, long long c_stride) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int kLd = DS + 4;               // C / B tile row (float4 rows)
  constexpr int kCbFloats = 2 * kTile * kLd;
  static_assert(kCbFloats >= 2 * kMaxQ, "scan buffers fit the tiles'");
  __shared__ __align__(16) float smem[kCbFloats];
  const int bc = blockIdx.z;
  const int tid = threadIdx.x;
  const long long tok0 = static_cast<long long>(bc) * Q;
  const int nt = (Q + kTile - 1) / kTile;

  const int n_tiles = nt * (nt + 1) / 2;
  if (static_cast<int>(blockIdx.x) >= n_tiles) {
    // Ā = cumsum(dt * A) of head h, sequential, mul then add (torch.
    // cumsum's order), one CTA per head beside the C·Bᵀ tiles: dt in and
    // Ā out through shared memory, the serial chain reading dt kRun
    // values at a time into registers
    static_assert(kMaxQ == kSsdThreads, "one key per thread");
    constexpr int kRun = 8;
    const int h = blockIdx.x - n_tiles;
    float* s_in = smem;
    float* s_out = smem + kMaxQ;
    s_in[tid] = tid < Q ? dt[(tok0 + tid) * nh + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      const float a = A[h];
      float acc = 0.f;
      for (int k = 0; k < Q; k += kRun) {
        float d[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) d[i] = s_in[k + i];  // < kMaxQ
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(d[i], a));
          s_out[k + i] = acc;                  // past Q: never read
        }
      }
    }
    __syncthreads();
    if (tid < Q) acum[(tok0 + tid) * nh + h] = s_out[tid];
    return;
  }

  float* cs = smem;                          // [kTile][kLd]
  float* bs = smem + kTile * kLd;            // [kTile][kLd]
  // tile (qi, kj), kj <= qi, from the linear index of the lower triangle
  int qi = 0, idx = blockIdx.x;
  while (idx > qi) idx -= ++qi;
  const int q0 = qi * kTile, k0 = idx * kTile;
#pragma unroll
  for (int e = tid; e < kTile * (DS / VEC); e += kSsdThreads) {
    const int r = e / (DS / VEC), c = e % (DS / VEC);
    const int q = q0 + r, k = k0 + r;
    float o[VEC];
    load_vec(o, Cm + (tok0 + min(q, Q - 1)) * c_stride, c, q < Q);
#pragma unroll
    for (int i = 0; i < VEC; ++i) cs[r * kLd + c * VEC + i] = o[i];
    load_vec(o, Bm + (tok0 + min(k, Q - 1)) * b_stride, c, k < Q);
#pragma unroll
    for (int i = 0; i < VEC; ++i) bs[r * kLd + c * VEC + i] = o[i];
  }
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < DS; d += 4) {      // ds in order: the plain sum's
    float4 c[2], b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * kLd + d);
      b[i] = *reinterpret_cast<const float4*>(bs + (tx + 16 * i) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] += c[i].x * b[j].x;
        acc[i][j] += c[i].y * b[j].y;
        acc[i][j] += c[i].z * b[j].z;
        acc[i][j] += c[i].w * b[j].w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < Q) cb[(tok0 + q) * Qp + k] = acc[i][j];
    }
  }
}

// ---- kernel 2: y (paired query tiles) and the state (32 columns) -------

template <typename T, int HP, int DS>
struct SsdOut {
  static constexpr int SW = DS < kStateCols ? DS : kStateCols;
  static constexpr int kStateCtas = DS / SW;
  // y: x as fp32 [key][HP], P of both tiles, each [32][its keys + 4]
  static constexpr size_t kYBytes =
      (size_t(kMaxQ) * HP + size_t(kTile) * (kMaxQ + kTile + 8)) * 4;
  // state: (w∘x)ᵀ [HP][kPLd] and B's columns [key][SW], fp32
  static constexpr size_t kStateBytes =
      (size_t(HP) * kPLd + size_t(kMaxQ) * SW) * 4;
  static constexpr size_t kBytes =
      kYBytes > kStateBytes ? kYBytes : kStateBytes;
};

template <typename T, int HP, int DS>
__global__ void __launch_bounds__(kSsdThreads)
ssd_chunk_kernel_out(const T* __restrict__ x, const float* __restrict__ dt,
                     const T* __restrict__ Bm, const float* __restrict__ cb,
                     const float* __restrict__ acum, float* __restrict__ y,
                     float* __restrict__ state, int Q, int Qp, int nh,
                     long long b_stride) {
  using L = SsdOut<T, HP, DS>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ float s_dt[kMaxQ];
  __shared__ float s_acum[kMaxQ];
  constexpr int VEC = Vec16<T>::N;
  constexpr int XV = HP / VEC;             // 16-byte vectors of an x row

  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long tok0 = static_cast<long long>(bc) * Q;
  const long long xstride = static_cast<long long>(nh) * HP;  // per key
  const int nt = (Q + kTile - 1) / kTile;
  const int n_y = (nt + 1) / 2;
  const int Q4 = round4(Q);
  const T* xh = x + (tok0 * nh + h) * HP;
  // dt and Ā of head h, stored to shared memory once the other loads
  // are in flight
  static_assert(kMaxQ == kSsdThreads, "one key per thread");
  const float dt_k = tid < Q ? dt[(tok0 + tid) * nh + h] : 0.f;
  const float acum_k = tid < Q ? acum[(tok0 + tid) * nh + h] : 0.f;

  if (static_cast<int>(blockIdx.x) < n_y) {
    // ---- y: query tiles u and nt-1-u ----------------------------------
    constexpr int LPR = HP / 2;            // lanes of a row group (2 cols)
    constexpr int R = HP / 16;             // rows per thread in a tile
    static_assert(kSsdThreads / LPR * R == kTile, "y thread map");
    const int u = blockIdx.x;
    const int n_phase = nt - 1 - u > u ? 2 : 1;
    float* sx = reinterpret_cast<float*>(smem);            // [kx4][HP]
    float* sp = sx + kMaxQ * HP;                           // both P tiles
    const int kx4 = round4(min(Q, (nt - u) * kTile));      // keys read
    // every load in flight at once: both tiles' C·Bᵀ rows by cp.async
    // (tile ph: rows from tile_q0(ph), 4 * tile_kv(ph) keys + 4 floats a
    // row, at tile_p(ph))
    auto tile_q0 = [&](int ph) { return (ph == 0 ? u : nt - 1 - u) * kTile; };
    auto tile_kv = [&](int ph) {
      return round4(min(Q, tile_q0(ph) + kTile)) / 4;
    };
    auto tile_p = [&](int ph) {
      return sp + (ph == 0 ? 0 : kTile * (4 * tile_kv(0) + 4));
    };
    for (int ph = 0; ph < n_phase; ++ph) {
      const int q0 = tile_q0(ph), kv = tile_kv(ph), ld = 4 * kv + 4;
      float* pt = tile_p(ph);
      for (int e = tid; e < kTile * kv; e += kSsdThreads) {
        const int r = e / kv, c = e % kv, q = q0 + r;
        cp_async16(pt + r * ld + 4 * c,
                   cb + (tok0 + min(q, Q - 1)) * Qp + 4 * c, q < Q ? 16 : 0);
      }
    }
    cp_async_commit();
    // x's rows as fp32: every load issued before the first store
    constexpr int NX = kMaxQ * XV / kSsdThreads;  // x vectors per thread
    float xr[NX][VEC];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * kSsdThreads, k = e / XV;
      load_vec(xr[i], xh + min(k, Q - 1) * xstride, e % XV, k < Q);
    }
    s_dt[tid] = dt_k;
    s_acum[tid] = acum_k;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * kSsdThreads, k = e / XV;
      if (k < kx4) {
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(sx + k * HP + (e % XV) * VEC + j) =
              make_float4(xr[i][j], xr[i][j + 1], xr[i][j + 2], xr[i][j + 3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // C·Bᵀ rows -> P in place: (C·Bᵀ) · exp(Ā_q − Ā_k) · dt_k, and
    // exactly 0 where k > q or the row is past Q
    for (int ph = 0; ph < n_phase; ++ph) {
      const int q0 = tile_q0(ph), ld = 4 * tile_kv(ph) + 4;
      float* pt = tile_p(ph);
      for (int r = warp; r < kTile; r += kSsdThreads / 32) {
        const int q = q0 + r;
        const float aq = s_acum[min(q, kMaxQ - 1)];
        // branch-free, so the elements' loads and exps overlap: every
        // element is computed and the mask selects (a masked one may be
        // inf, or read unwritten scratch, and is never used; the plain
        // version masks before exp for the same reason)
#pragma unroll
        for (int i = 0; i < kMaxQ / 32; ++i) {
          const int k = lane + 32 * i;
          const int kr = min(k, ld - 5);             // stay in this row
          const float v = pt[r * ld + kr] * expf(aq - s_acum[k]) * s_dt[k];
          if (k < ld - 4) pt[r * ld + k] = k <= q && q < Q ? v : 0.f;
        }
      }
    }
    __syncthreads();
    const int c = lane % LPR;                        // cols 2c, 2c + 1
    const int r0 = (warp * (32 / LPR) + lane / LPR) * R;  // rows r0 .. +R
    for (int ph = 0; ph < n_phase; ++ph) {
      const int q0 = tile_q0(ph), ld = 4 * tile_kv(ph) + 4;
      const float* pt = tile_p(ph) + r0 * ld;
      float acc[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
      const int kstop = round4(min(Q, q0 + r0 + R));   // my last row + 1
#pragma unroll 4
      for (int k = 0; k < kstop; k += 4) {
        float4 pr[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          pr[r] = *reinterpret_cast<const float4*>(pt + r * ld + k);
        float2 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const float2*>(sx + (k + i) * HP + 2 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {              // keys in order, per row
          acc[r][0] += pr[r].x * xv[0].x;
          acc[r][1] += pr[r].x * xv[0].y;
          acc[r][0] += pr[r].y * xv[1].x;
          acc[r][1] += pr[r].y * xv[1].y;
          acc[r][0] += pr[r].z * xv[2].x;
          acc[r][1] += pr[r].z * xv[2].y;
          acc[r][0] += pr[r].w * xv[3].x;
          acc[r][1] += pr[r].w * xv[3].y;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = q0 + r0 + r;
        if (q < Q)
          *reinterpret_cast<float2*>(y + ((tok0 + q) * nh + h) * HP + 2 * c) =
              make_float2(acc[r][0], acc[r][1]);
      }
    }
    return;
  }

  // ---- the chunk-end state, columns n0 .. n0 + SW ---------------------
  constexpr int SW = L::SW;
  constexpr int BV = SW / VEC;                  // 16-byte vectors of B
  constexpr int RS = HP * SW / kSsdThreads;     // state rows per thread
  static_assert(RS >= 1 && HP % RS == 0, "state thread map");
  constexpr int NX = kMaxQ * XV / kSsdThreads;  // x vectors per thread
  constexpr int NB = (kMaxQ * BV + kSsdThreads - 1) / kSsdThreads;
  const int n0 = (blockIdx.x - n_y) * SW;
  float* sv = reinterpret_cast<float*>(smem);   // (w∘x)ᵀ [HP][kPLd]
  float* sb = sv + HP * kPLd;                   // [Q4][SW]
  // x (keys fastest, so the transposed stores below are conflict-free)
  // and B's columns, all loads in flight at once
  float xr[NX][VEC], br[NB][VEC];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int e = tid + i * kSsdThreads, k = e % kMaxQ, c = e / kMaxQ;
    load_vec(xr[i], xh + min(k, Q - 1) * xstride, c, k < Q);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int e = tid + i * kSsdThreads, k = e / BV;
    load_vec(br[i], Bm + (tok0 + min(k, Q - 1)) * b_stride + n0, e % BV,
             k < Q && e < kMaxQ * BV);
  }
  s_dt[tid] = dt_k;
  s_acum[tid] = acum_k;
  __syncthreads();
  const float a_last = s_acum[Q - 1];
  for (int k = tid; k < Q; k += kSsdThreads)    // w, in s_dt's place
    s_dt[k] = expf(a_last - s_acum[k]) * s_dt[k];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int e = tid + i * kSsdThreads, k = e % kMaxQ, c = e / kMaxQ;
    if (k < Q4) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)             // w∘x, rounded as the plain
        sv[(c * VEC + j) * kPLd + k] = s_dt[k] * xr[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int e = tid + i * kSsdThreads, k = e / BV;
    if (k < Q4 && e < kMaxQ * BV) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        sb[k * SW + (e % BV) * VEC + j] = br[i][j];
    }
  }
  __syncthreads();
  const int n = tid % SW;
  const int p0 = (tid / SW) * RS;
  float acc[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < Q4; k += 4) {
    const float b0 = sb[k * SW + n], b1 = sb[(k + 1) * SW + n];
    const float b2 = sb[(k + 2) * SW + n], b3 = sb[(k + 3) * SW + n];
#pragma unroll
    for (int r = 0; r < RS; ++r) {              // keys in order, per row
      const float4 v =
          *reinterpret_cast<const float4*>(sv + (p0 + r) * kPLd + k);
      acc[r] += v.x * b0;
      acc[r] += v.y * b1;
      acc[r] += v.z * b2;
      acc[r] += v.w * b3;
    }
  }
  float* out = state + (static_cast<long long>(bc) * nh + h) * HP * DS;
#pragma unroll
  for (int r = 0; r < RS; ++r) out[(p0 + r) * DS + n0 + n] = acc[r];
}

template <typename T, int HP, int DS>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, float* y,
                         float* state, float* cb, float* acum, int BC, int Q,
                         int nh, long long b_stride, long long c_stride,
                         cudaStream_t stream) {
  using L = SsdOut<T, HP, DS>;
  const int nt = (Q + kTile - 1) / kTile;
  const int Qp = round4(Q);
  ssd_chunk_kernel_cb<T, DS><<<dim3(nt * (nt + 1) / 2 + nh, 1, BC),
                               kSsdThreads, 0, stream>>>(
      dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), cb, acum,
      Q, Qp, nh, b_stride, c_stride);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = ssd_chunk_kernel_out<T, HP, DS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((nt + 1) / 2 + L::kStateCtas, nh, BC), kSsdThreads, L::kBytes,
         stream>>>(static_cast<const T*>(x), dt, static_cast<const T*>(Bm),
                   cb, acum, y, state, Q, Qp, nh, b_stride);
  return cudaSuccess;
}

template <typename T, int HP>
cudaError_t launch_ds(int ds, const void* x, const float* dt, const float* A,
                      const void* Bm, const void* Cm, float* y, float* state,
                      float* cb, float* acum, int BC, int Q, int nh,
                      long long b_stride, long long c_stride,
                      cudaStream_t stream) {
#define REPRO_SSD_CASE(DS)                                               \
  case DS:                                                               \
    return launch_typed<T, HP, DS>(x, dt, A, Bm, Cm, y, state, cb, acum,  \
                                   BC, Q, nh, b_stride, c_stride, stream)
  switch (ds) {
    REPRO_SSD_CASE(16);
    REPRO_SSD_CASE(32);
    REPRO_SSD_CASE(64);
    REPRO_SSD_CASE(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
}

template <typename T>
cudaError_t launch_hp(int hp, int ds, const void* x, const float* dt,
                      const float* A, const void* Bm, const void* Cm,
                      float* y, float* state, float* cb, float* acum,
                      int BC, int Q, int nh, long long b_stride,
                      long long c_stride, cudaStream_t stream) {
  switch (hp) {
    case 32:
      return launch_ds<T, 32>(ds, x, dt, A, Bm, Cm, y, state, cb, acum, BC,
                              Q, nh, b_stride, c_stride, stream);
    case 64:
      return launch_ds<T, 64>(ds, x, dt, A, Bm, Cm, y, state, cb, acum, BC,
                              Q, nh, b_stride, c_stride, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_ssd_chunk(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, float* y,
                             float* state, float* cb, float* acum, int BC,
                             int Q, int nh, int hp, int ds,
                             long long b_stride, long long c_stride,
                             int dtype, cudaStream_t stream) {
  using namespace repro_torch;
  if (Q <= 0 || Q > kMaxQ || nh <= 0 || nh > 65535 || BC > 65535)
    return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  if (cb == nullptr || acum == nullptr) return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return launch_hp<__nv_bfloat16>(hp, ds, x, dt, A, Bm, Cm, y, state, cb,
                                    acum, BC, Q, nh, b_stride, c_stride,
                                    stream);
  if (dtype == kFloat32)
    return launch_hp<float>(hp, ds, x, dt, A, Bm, Cm, y, state, cb, acum, BC,
                            Q, nh, b_stride, c_stride, stream);
  return cudaErrorInvalidValue;
}
