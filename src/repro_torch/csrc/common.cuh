// Small device helpers shared by the port's kernels.  Conversions go
// through the bf16 intrinsics only: the extension is compiled with
// -D__CUDA_NO_BFLOAT16_CONVERSIONS__.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace repro_torch {

constexpr float kNegInf = -1e30f;   // the reference's masked-score value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One 16-byte load of consecutive elements, widened to fp32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// 16 raw bytes of K or V (one uint4 load), widened to fp32 on use.
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* o);

template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float* o) {
  o[0] = __uint_as_float(raw.x);
  o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z);
  o[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw,
                                                     float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// ---- cp.async: global -> shared copies that bypass registers ----------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills without a read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory past 48 KB is an attribute of the kernel on the
// device current when it is set, so a kernel launched on several cards
// (a tensor-parallel rank on each) needs it set on each: a launch on a
// card without it fails with cudaErrorInvalidValue.  Sets it once a
// (kernel, device), at the first launch there, and returns that call's
// result.  Host code; the bindings' CUDAGuard makes the inputs' device
// current.
inline cudaError_t allow_dynamic_smem(const void* kern, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, cudaError_t> done;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kern, dev);
  const auto it = done.find(key);
  if (it != done.end()) return it->second;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  done.emplace(key, err);
  return err;
}

}  // namespace repro_torch
