// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
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
// The Pallas kernel gives a grid cell one (bc, h) and holds the whole
// (Q, Q) fp32 score matrix in VMEM; at full width (Q = 256) that is 256 KB,
// more than an SM's shared memory.  Here a (bc, h) gets Q/64 + 1 CTAs:
//   * a "y" CTA owns 64 query rows and walks the key tiles at or below
//     the diagonal only (tiles above it are all masked).  Per key tile it
//     forms S = C·Bᵀ (64 × 64, in 32-wide slabs of the state dim), weights
//     it into P = S · exp(Ā_q − Ā_k) · dt_k where k ≤ q — the mask is
//     applied BEFORE exp, as the reference's (exp of a masked, positive
//     rel could overflow) — and accumulates y += P · x in registers;
//   * one "state" CTA streams the chunk's keys in steps of 32 and
//     accumulates state = (w ∘ x)ᵀ · B with w_k = exp(Ā_last − Ā_k) · dt_k.
// A short chunk's padding tokens carry dt = 0 (the caller pads so), so
// they weigh nothing in y or state; rows past Q are masked here.
//
// Every CTA first forms Ā in shared memory with one thread's sequential
// fp32 scan, in the order of torch.cumsum over a non-innermost axis (the
// plain version's, and that of the inter-chunk recurrence in
// repro_torch/models/mamba.py), so the decays agree with them bit for bit:
// Ā reaches hundreds within a chunk, where another summation order would
// move exp(Ā_q − Ā_k) by several ulps of Ā.
//
// What bounds it on the H100: at full width one chunk moves about 4.3 MB
// (x in bf16, B, C, y and the state in fp32), 1.3 µs at 3.35 TB/s; its
// 0.6 GFLOP would take 0.6 µs on the bf16 tensor cores.  This first
// version runs fp32 FMAs from shared memory (register tiles of 4 × 4 per
// thread) and forms C·Bᵀ once per head although it is the same for all
// heads; tensor cores and a C·Bᵀ tile shared across heads come later.

#include "common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kSsdThreads = 256;   // 16 × 16 thread grid
constexpr int kTile = 64;          // query rows / keys per tile (y CTAs)
constexpr int kStateKeys = 32;     // keys per step (state CTA)
constexpr int kMaxQ = 256;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int HP, int DS>
struct SsdSmem {
  static constexpr int KD = DS < 32 ? DS : 32;          // slab width
  static constexpr int kSlab = 2 * kTile * (KD + 1);    // C and B slabs
  static constexpr int kP = kTile * (kTile + 1);        // P, over the slabs
  static constexpr int kY = cmax(kSlab, kP) + kTile * HP;
  static constexpr int kState = kStateKeys * (HP + DS);
  static constexpr int kFloats = cmax(kY, kState);
};

template <typename T, int HP, int DS>
__global__ void __launch_bounds__(kSsdThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ state, int Q, int nh, long long b_stride,
                 long long c_stride) {
  using Sm = SsdSmem<HP, DS>;
  constexpr int KD = Sm::KD;
  constexpr int YJ = HP / 16;      // y columns per thread
  static_assert(HP % 16 == 0 && DS % 16 == 0 && DS % KD == 0,
                "head / state dim must be multiples of 16");

  __shared__ float s_dt[kMaxQ];
  __shared__ float s_acum[kMaxQ];
  __shared__ float smem[Sm::kFloats];

  const int n_tiles = (Q + kTile - 1) / kTile;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long tok0 = static_cast<long long>(bc) * Q;   // first token

  // Ā = cumsum(dt * A): one thread, sequential, unfused mul then add
  const float a = A[h];
  for (int k = tid; k < Q; k += kSsdThreads)
    s_dt[k] = dt[(tok0 + k) * nh + h];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int k = 0; k < Q; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(s_dt[k], a));
      s_acum[k] = acc;
    }
  }
  __syncthreads();

  if (blockIdx.x == n_tiles) {
    // ---- the chunk-end state: state[p, n] = Σ_k w_k x[k, p] B_k[n] ----
    constexpr int SI = HP / 16, SJ = DS / 16;
    float* xs = smem;                        // [kStateKeys][HP], w ∘ x
    float* bs = smem + kStateKeys * HP;      // [kStateKeys][DS]
    float acc[SI][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) acc[i][j] = 0.f;
    const float a_last = s_acum[Q - 1];
    for (int k0 = 0; k0 < Q; k0 += kStateKeys) {
      __syncthreads();                       // previous step consumed
      for (int e = tid; e < kStateKeys * HP; e += kSsdThreads) {
        const int r = e / HP, p = e % HP, k = k0 + r;
        float v = 0.f;
        if (k < Q) {
          const float w = expf(a_last - s_acum[k]) * s_dt[k];
          v = w * to_float(x[((tok0 + k) * nh + h) * HP + p]);
        }
        xs[r * HP + p] = v;
      }
      for (int e = tid; e < kStateKeys * DS; e += kSsdThreads) {
        const int r = e / DS, n = e % DS, k = k0 + r;
        bs[r * DS + n] = k < Q ? to_float(Bm[(tok0 + k) * b_stride + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kStateKeys; ++r) {
        float av[SI], bv[SJ];
#pragma unroll
        for (int i = 0; i < SI; ++i) av[i] = xs[r * HP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < SJ; ++j) bv[j] = bs[r * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
          for (int j = 0; j < SJ; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    float* out = state + (static_cast<long long>(bc) * nh + h) * HP * DS;
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        out[(ty + 16 * i) * DS + tx + 16 * j] = acc[i][j];
    return;
  }

  // ---- 64 query rows of y: the heaviest tiles get the lowest ids -------
  const int tile = n_tiles - 1 - blockIdx.x;
  const int q0 = tile * kTile;
  float* cs = smem;                                  // [kTile][KD + 1]
  float* bs = smem + kTile * (KD + 1);               // [kTile][KD + 1]
  float* ps = smem;                                  // [kTile][kTile + 1]
  float* xs = smem + cmax(Sm::kSlab, Sm::kP);        // [kTile][HP]
  float yacc[4][YJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < YJ; ++j) yacc[i][j] = 0.f;

  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kTile;
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    // S = C[q0:q0+64] · B[k0:k0+64]ᵀ, one KD-wide slab of ds at a time
    for (int d0 = 0; d0 < DS; d0 += KD) {
      __syncthreads();                     // slabs / P / x free again
      for (int e = tid; e < kTile * KD; e += kSsdThreads) {
        const int r = e / KD, d = e % KD;
        const int q = q0 + r, k = k0 + r;
        cs[r * (KD + 1) + d] =
            q < Q ? to_float(Cm[(tok0 + q) * c_stride + d0 + d]) : 0.f;
        bs[r * (KD + 1) + d] =
            k < Q ? to_float(Bm[(tok0 + k) * b_stride + d0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < KD; ++d) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * (KD + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * (KD + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += cv[i] * bv[j];
      }
    }
    __syncthreads();                       // slabs consumed: P over them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, q = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, k = k0 + c;
        float pv = 0.f;
        if (k <= q && q < Q)                 // causal mask before exp
          pv = sacc[i][j] * expf(s_acum[q] - s_acum[k]) * s_dt[k];
        ps[r * (kTile + 1) + c] = pv;
      }
    }
    for (int e = tid; e < kTile * HP; e += kSsdThreads) {
      const int r = e / HP, p = e % HP, k = k0 + r;
      xs[r * HP + p] = k < Q ? to_float(x[((tok0 + k) * nh + h) * HP + p])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float pv[4], xv[YJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < YJ; ++j) xv[j] = xs[c * HP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < YJ; ++j) yacc[i][j] += pv[i] * xv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
    float* row = y + ((tok0 + q) * nh + h) * HP;
#pragma unroll
    for (int j = 0; j < YJ; ++j) row[tx + 16 * j] = yacc[i][j];
  }
}

template <typename T, int HP, int DS>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, float* y,
                         float* state, int BC, int Q, int nh,
                         long long b_stride, long long c_stride,
                         cudaStream_t stream) {
  const dim3 grid((Q + kTile - 1) / kTile + 1, nh, BC);
  ssd_chunk_kernel<T, HP, DS><<<grid, kSsdThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, state, Q, nh, b_stride, c_stride);
  return cudaSuccess;
}

template <typename T, int HP>
cudaError_t launch_ds(int ds, const void* x, const float* dt, const float* A,
                      const void* Bm, const void* Cm, float* y, float* state,
                      int BC, int Q, int nh, long long b_stride,
                      long long c_stride, cudaStream_t stream) {
  switch (ds) {
    case 16:
      return launch_typed<T, HP, 16>(x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                                     b_stride, c_stride, stream);
    case 32:
      return launch_typed<T, HP, 32>(x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                                     b_stride, c_stride, stream);
    case 64:
      return launch_typed<T, HP, 64>(x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                                     b_stride, c_stride, stream);
    case 128:
      return launch_typed<T, HP, 128>(x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                                      b_stride, c_stride, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hp(int hp, int ds, const void* x, const float* dt,
                      const float* A, const void* Bm, const void* Cm,
                      float* y, float* state, int BC, int Q, int nh,
                      long long b_stride, long long c_stride,
                      cudaStream_t stream) {
  switch (hp) {
    case 32:
      return launch_ds<T, 32>(ds, x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                              b_stride, c_stride, stream);
    case 64:
      return launch_ds<T, 64>(ds, x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                              b_stride, c_stride, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

cudaError_t launch_ssd_chunk(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, float* y,
                             float* state, int BC, int Q, int nh, int hp,
                             int ds, long long b_stride, long long c_stride,
                             int dtype, cudaStream_t stream) {
  using namespace repro_torch;
  if (Q <= 0 || Q > kMaxQ || nh <= 0 || nh > 65535 || BC > 65535)
    return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  if (dtype == kBFloat16)
    return launch_hp<__nv_bfloat16>(hp, ds, x, dt, A, Bm, Cm, y, state, BC,
                                    Q, nh, b_stride, c_stride, stream);
  if (dtype == kFloat32)
    return launch_hp<float>(hp, ds, x, dt, A, Bm, Cm, y, state, BC, Q, nh,
                            b_stride, c_stride, stream);
  return cudaErrorInvalidValue;
}
