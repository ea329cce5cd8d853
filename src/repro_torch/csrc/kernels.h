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
// out (B,H,hd).  Each row's table is cut into n_split ranges of
// ceil(nbt / n_split) entries (each non-empty); with n_split > 1 the
// splits' fp32 partials go to part_ml (B,H,n_split,2) and part_acc
// (B,H,n_split,hd), and a second kernel merges them into out.
// Replaces paged_decode_attention_pallas.
cudaError_t launch_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* kv_pos_pool, const int* block_tab, const int* pos, void* out,
    float* part_ml, float* part_acc, int B, int H, int K, int hd, int bs,
    int nbt, int n_split, int window, float scale, int dtype,
    cudaStream_t stream);

// The log-sum-exp merge of both decode kernels' splits: part_ml
// (BH,n_split,2) holds each split's (max, sum) and part_acc
// (BH,n_split,hd) its unnormalised output; out (BH,hd).  A split with
// sum 0 adds nothing; a row whose splits all have sum 0 gives 0.
cudaError_t launch_decode_merge(const float* part_ml, const float* part_acc,
                                void* out, int BH, int hd, int n_split,
                                int dtype, cudaStream_t stream);

// Dense decode attention: q (B,H,hd); k/v caches (B,S,K,hd); kv_pos
// (B,S) int32 (-1 = empty); pos (B,) int32; out (B,H,hd).  Walks cache
// indices 0 .. min(S, pos + 1) - 1 (see the source note), cut into
// n_split ranges of ceil(ceil(S / 16) / n_split) 16-index units (each
// non-empty); with n_split > 1 the splits' fp32 partials go to part_ml
// (B,H,n_split,2) and part_acc (B,H,n_split,hd) and launch_decode_merge
// writes out.  Replaces decode_attention_pallas.
cudaError_t launch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const int* kv_pos, const int* pos, void* out, float* part_ml,
    float* part_acc, int B, int H, int S, int K, int hd, int n_split,
    int window, float scale, int dtype, cudaStream_t stream);

// Packed-varlen flash attention over contiguous K/V: q (B,Sq,H,hd);
// k/v (B,Skv,K,hd); q_pos/q_seg (B,Sq), kv_pos/kv_seg (B,Skv) int32
// (segment -1 = pad, kv_pos < 0 = empty); out (B,Sq,H,hd).  bf16 runs
// on the tensor cores, fp32 by FMA.  The bf16 body keeps one byte per
// 32 keys in shared memory beside ~158 KB of tiles, so it takes up to
// about 2.2M keys (nbt * bs on the paged entry).
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

// Mamba2 SSD intra-chunk term (n_groups = 1): x (BC,Q,nh,hp); dt
// (BC,Q,nh) fp32; A (nh,) fp32; B and C: BC*Q tokens of ds values at a
// row stride of b_stride / c_stride elements; y (BC,Q,nh,hp) fp32; state
// (BC,nh,hp,ds) fp32.  Q <= 256; x, B and C 16-byte aligned, B/C rows a
// multiple of 16 bytes apart.  Two kernels: the first writes C·Bᵀ to the
// fp32 scratch cb (BC,Q,round4(Q)) and Ā to acum (BC,Q,nh), the second
// reads them.  Replaces ssd_chunk_pallas.
cudaError_t launch_ssd_chunk(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, float* y,
                             float* state, float* cb, float* acum, int BC,
                             int Q, int nh, int hp, int ds,
                             long long b_stride, long long c_stride,
                             int dtype, cudaStream_t stream);
