// PyTorch binding of the port's CUDA kernels: the only source that
// includes torch/extension.h.  Each function checks its tensors, launches
// on PyTorch's current stream, and checks the launch right after it.
// The Python wrappers (repro_torch/kernels/*/ops.py) validate shapes and
// count launches; these checks are the last line before a raw pointer.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

int dtype_code(const at::Tensor& t) {
  if (t.scalar_type() == at::kFloat) return kFloat32;
  if (t.scalar_type() == at::kBFloat16) return kBFloat16;
  TORCH_CHECK(false, "unsupported dtype ", t.scalar_type());
  return -1;
}

void check(const at::Tensor& t, const char* name, at::ScalarType st) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.scalar_type() == st, name, " has dtype ", t.scalar_type(),
              ", expected ", st);
}

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, ": ", cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

at::Tensor paged_decode_attention(const at::Tensor& q,
                                  const at::Tensor& k_pool,
                                  const at::Tensor& v_pool,
                                  const at::Tensor& kv_pos_pool,
                                  const at::Tensor& block_tab,
                                  const at::Tensor& pos, int64_t window,
                                  double scale, int64_t n_split) {
  const auto st = q.scalar_type();
  check(q, "q", st);
  check(k_pool, "k_pool", st);
  check(v_pool, "v_pool", st);
  check(kv_pos_pool, "kv_pos_pool", at::kInt);
  check(block_tab, "block_tab", at::kInt);
  check(pos, "pos", at::kInt);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  // the splits' fp32 partials (m, l) and acc; unused with one split
  const auto f32 = q.options().dtype(at::kFloat);
  const int64_t parts = n_split > 1 ? q.size(0) * q.size(1) * n_split : 0;
  at::Tensor part_ml = at::empty({parts, 2}, f32);
  at::Tensor part_acc = at::empty({parts, q.size(2)}, f32);
  check_launch(
      launch_paged_decode_attention(
          q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
          kv_pos_pool.data_ptr<int>(), block_tab.data_ptr<int>(),
          pos.data_ptr<int>(), out.data_ptr(),
          parts ? part_ml.data_ptr<float>() : nullptr,
          parts ? part_acc.data_ptr<float>() : nullptr, q.size(0),
          q.size(1), k_pool.size(2), q.size(2), k_pool.size(1),
          block_tab.size(1), static_cast<int>(n_split), window,
          static_cast<float>(scale), dtype_code(q),
          at::cuda::getCurrentCUDAStream()),
      "paged_decode_attention");
  return out;
}

at::Tensor decode_attention(const at::Tensor& q, const at::Tensor& k_cache,
                            const at::Tensor& v_cache,
                            const at::Tensor& kv_pos, const at::Tensor& pos,
                            int64_t window, double scale, int64_t n_split) {
  const auto st = q.scalar_type();
  check(q, "q", st);
  check(k_cache, "k_cache", st);
  check(v_cache, "v_cache", st);
  check(kv_pos, "kv_pos", at::kInt);
  check(pos, "pos", at::kInt);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  // the splits' fp32 partials (m, l) and acc; unused with one split
  const auto f32 = q.options().dtype(at::kFloat);
  const int64_t parts = n_split > 1 ? q.size(0) * q.size(1) * n_split : 0;
  at::Tensor part_ml = at::empty({parts, 2}, f32);
  at::Tensor part_acc = at::empty({parts, q.size(2)}, f32);
  check_launch(
      launch_decode_attention(
          q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
          kv_pos.data_ptr<int>(), pos.data_ptr<int>(), out.data_ptr(),
          parts ? part_ml.data_ptr<float>() : nullptr,
          parts ? part_acc.data_ptr<float>() : nullptr, q.size(0),
          q.size(1), k_cache.size(1), k_cache.size(2), q.size(2),
          static_cast<int>(n_split), window, static_cast<float>(scale),
          dtype_code(q), at::cuda::getCurrentCUDAStream()),
      "decode_attention");
  return out;
}

at::Tensor flash_prefill(const at::Tensor& q, const at::Tensor& k,
                         const at::Tensor& v, const at::Tensor& q_pos,
                         const at::Tensor& kv_pos, const at::Tensor& q_seg,
                         const at::Tensor& kv_seg, bool causal,
                         int64_t window, double scale) {
  const auto st = q.scalar_type();
  check(q, "q", st);
  check(k, "k", st);
  check(v, "v", st);
  check(q_pos, "q_pos", at::kInt);
  check(kv_pos, "kv_pos", at::kInt);
  check(q_seg, "q_seg", at::kInt);
  check(kv_seg, "kv_seg", at::kInt);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  check_launch(
      launch_flash_prefill(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr<int>(),
          kv_pos.data_ptr<int>(), q_seg.data_ptr<int>(),
          kv_seg.data_ptr<int>(), out.data_ptr(), q.size(0), q.size(1),
          k.size(1), q.size(2), k.size(2), q.size(3), causal ? 1 : 0, window,
          static_cast<float>(scale), dtype_code(q),
          at::cuda::getCurrentCUDAStream()),
      "flash_prefill");
  return out;
}

at::Tensor paged_prefill_attention(const at::Tensor& q,
                                   const at::Tensor& k_pool,
                                   const at::Tensor& v_pool,
                                   const at::Tensor& kv_pos_pool,
                                   const at::Tensor& block_tab,
                                   const at::Tensor& q_pos, int64_t window,
                                   double scale) {
  const auto st = q.scalar_type();
  check(q, "q", st);
  check(k_pool, "k_pool", st);
  check(v_pool, "v_pool", st);
  check(kv_pos_pool, "kv_pos_pool", at::kInt);
  check(block_tab, "block_tab", at::kInt);
  check(q_pos, "q_pos", at::kInt);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  check_launch(
      launch_paged_prefill_attention(
          q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
          kv_pos_pool.data_ptr<int>(), block_tab.data_ptr<int>(),
          q_pos.data_ptr<int>(), out.data_ptr(), q.size(0), q.size(1),
          q.size(2), k_pool.size(2), q.size(3), k_pool.size(1),
          block_tab.size(1), window,
          static_cast<float>(scale), dtype_code(q),
          at::cuda::getCurrentCUDAStream()),
      "paged_prefill_attention");
  return out;
}

std::tuple<at::Tensor, at::Tensor> ssd_chunk(
    const at::Tensor& x, const at::Tensor& dt, const at::Tensor& A,
    const at::Tensor& Bm, const at::Tensor& Cm, int64_t b_stride,
    int64_t c_stride) {
  const auto st = x.scalar_type();
  check(x, "x", st);
  check(dt, "dt", at::kFloat);
  check(A, "A", at::kFloat);
  // B and C may be strided views (tokens at one stride, ds contiguous)
  for (const at::Tensor* t : {&Bm, &Cm}) {
    TORCH_CHECK(t->is_cuda() && t->scalar_type() == st && t->dim() == 4 &&
                    t->stride(3) == 1,
                "Bm / Cm must be CUDA (B, nc, Q, ds) of x's dtype with a "
                "contiguous last axis");
  }
  TORCH_CHECK(x.dim() == 5, "x must be (B, nc, Q, nh, hp)");
  const int64_t B = x.size(0), nc = x.size(1), Q = x.size(2);
  const int64_t nh = x.size(3), hp = x.size(4), ds = Bm.size(3);
  const c10::cuda::CUDAGuard guard(x.device());
  const auto f32 = x.options().dtype(at::kFloat);
  at::Tensor y = at::empty({B, nc, Q, nh, hp}, f32);
  at::Tensor state = at::empty({B, nc, nh, hp, ds}, f32);
  // the first kernel's C·Bᵀ (rows padded to 4 floats) and Ā, read by the
  // second
  at::Tensor cb = at::empty({B * nc, Q, (Q + 3) / 4 * 4}, f32);
  at::Tensor acum = at::empty({B * nc, Q, nh}, f32);
  check_launch(
      launch_ssd_chunk(x.data_ptr(), dt.data_ptr<float>(),
                       A.data_ptr<float>(), Bm.data_ptr(), Cm.data_ptr(),
                       y.data_ptr<float>(), state.data_ptr<float>(),
                       cb.data_ptr<float>(), acum.data_ptr<float>(),
                       static_cast<int>(B * nc),
                       static_cast<int>(Q),
                       static_cast<int>(nh), static_cast<int>(hp),
                       static_cast<int>(ds), b_stride, c_stride,
                       dtype_code(x), at::cuda::getCurrentCUDAStream()),
      "ssd_chunk");
  return {y, state};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("paged_decode_attention", &paged_decode_attention);
  m.def("decode_attention", &decode_attention);
  m.def("flash_prefill", &flash_prefill);
  m.def("paged_prefill_attention", &paged_prefill_attention);
  m.def("ssd_chunk", &ssd_chunk);
}
