// Plain C++ interface of the port's CUDA kernels (no PyTorch headers, so
// the .cu files compile in seconds).  bindings.cpp is the only file that
// includes torch/extension.h; it checks the tensors, calls these
// launchers on PyTorch's current stream and checks the launch.
//
// Every launcher returns cudaErrorInvalidValue, without launching, for a
// configuration its kernel does not take (the Python wrapper checks the
// same conditions first and raises with a clear message).
#pragma once

#include <cuda_runtime.h>

enum KernelDtype { kFloat32 = 0, kBFloat16 = 1 };

// Paged decode attention: q (B,H,hd); pools (N,bs,K,hd); kv_pos_pool
// (N,bs) int32; block_tab (B,nbt) int32 (-1 = unset); pos (B,) int32;
// out (B,H,hd).  Replaces paged_decode_attention_pallas.
cudaError_t launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* pos, void* out,
    int B, int H, int K, int hd, int bs, int nbt, int window, float scale,
    int dtype, cudaStream_t stream);

// Packed-varlen flash attention over contiguous K/V: q (B,Sq,H,hd);
// k/v (B,Skv,K,hd); q_pos/q_seg (B,Sq), kv_pos/kv_seg (B,Skv) int32
// (segment -1 = pad, kv_pos < 0 = empty); out (B,Sq,H,hd).
// Replaces flash_prefill_pallas.
cudaError_t launch_flash_prefill(
    const void* q, const void* k, const void* v,
    const int* q_pos, const int* kv_pos, const int* q_seg, const int* kv_seg,
    void* out, int B, int Sq, int Skv, int H, int K, int hd,
    int causal, int window, float scale, int dtype, cudaStream_t stream);

// The same kernel reading K/V through a block table: q (B,Sq,H,hd) at
// q_pos (B,Sq); pools (N,bs,K,hd); kv_pos_pool (N,bs); block_tab
// (B,nbt).  Causal on positions.  Replaces the gather + attend of
// attn_extend_paged (repro/models/blocks.py:464-475).
cudaError_t launch_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* q_pos,
    void* out, int B, int Sq, int H, int K, int hd, int bs, int nbt,
    int window, float scale, int dtype, cudaStream_t stream);
