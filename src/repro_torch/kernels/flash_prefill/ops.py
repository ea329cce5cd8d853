"""Flash prefill attention: one CUDA kernel with two entries, their
wrappers and their plain PyTorch versions.

Replaces `repro/kernels/flash_prefill/kernel.py` `flash_prefill_pallas`
(entry `flash_prefill`: contiguous packed-varlen K/V with segment ids)
and the gather + attend of `attn_extend_paged`
(`repro/models/blocks.py:464-475`; entry `paged_prefill_attention`: a
prefill chunk whose K/V are read through the block table, which is the
entry the serving path runs).  The kernel
(`repro_torch/csrc/flash_prefill.cu`) tiles K/V through shared memory
with an fp32 online softmax, skips from the data every K/V tile no
query of a tile can attend to, and never writes a (Sq, Skv) matrix to
device memory.  bf16 inputs run both products on the tensor cores
(mma.sync, K/V tiles streamed in by cp.async); fp32 inputs run an FMA
body, so the fp32 path keeps its 1e-4 agreement — see the source note.

Each wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; `<wrapper>.launches` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_kernels
from repro_torch.models.attention import (
    build_mask, gather_paged, gather_paged_pos, gqa_reference,
)

HEAD_DIMS = (64, 128)       # head dims the kernel is instantiated for
DTYPES = (torch.float32, torch.bfloat16)
# keys the bf16 body walks at most (Skv, or nbt * bs on the paged entry):
# it keeps one byte per 32 keys in shared memory beside its tiles
MAX_BF16_KEYS = 1 << 21


def flash_prefill_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                        causal: bool = True, window: int = 0):
    """Masked softmax attention with packed-segment semantics: attend iff
    same segment (-1 = pad), kv position valid, causal on positions,
    optional window.  q (B,Sq,H,hd), k/v (B,Skv,K,hd) -> (B,Sq,H,hd)."""
    mask = build_mask(q_pos, kv_pos, q_seg, kv_seg, causal, window)
    return gqa_reference(q, k, v, mask)


def paged_prefill_attention_plain(q, k_pool, v_pool, kv_pos_pool,
                                  block_tab, positions, window: int = 0):
    """A chunk's queries at `positions` (B, Sc) over the block-table
    gather of its pages (exactly `attn_extend_paged`'s gather + attend,
    always by the dense reference).  q (B,Sc,H,hd); pools (N,bs,K,hd);
    kv_pos_pool (N,bs); block_tab (B,nbt) -> (B,Sc,H,hd)."""
    kg = gather_paged(k_pool, block_tab)
    vg = gather_paged(v_pool, block_tab)
    kv_pos_g = gather_paged_pos(kv_pos_pool, block_tab)
    mask = build_mask(positions, kv_pos_g, causal=True, window=window)
    mask = mask & (kv_pos_g >= 0)[:, None, :]
    return gqa_reference(q, kg, vg, mask)


def _check_common(q, kv, ints) -> None:
    if q.dim() != 4 or kv[0].dim() != 4:
        raise ValueError("q must be (B, Sq, H, hd) and K/V 4-d")
    H, hd = q.shape[2], q.shape[3]
    K = kv[0].shape[2]
    if tuple(kv[1].shape) != tuple(kv[0].shape) or kv[0].shape[3] != hd:
        raise ValueError(f"K/V shapes {tuple(kv[0].shape)}, "
                         f"{tuple(kv[1].shape)} do not match q")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in kv):
        raise ValueError(f"q, K and V must share one dtype of {DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for t in (q, *kv, *ints.values()):
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
        if t.device != q.device:
            raise ValueError(f"input on {t.device}, q on {q.device}")
    for t in (q, *kv):
        if t.data_ptr() % 16:
            raise ValueError("q, K and V must be 16-byte aligned (rows are "
                             "copied 16 bytes at a time)")


def check_flash_args(q, k, v, q_pos, kv_pos, q_seg, kv_seg) -> None:
    """Raise ValueError for any input the contiguous entry does not take."""
    _check_common(q, (k, v), {"q_pos": q_pos, "kv_pos": kv_pos,
                              "q_seg": q_seg, "kv_seg": kv_seg})
    B, Sq = q.shape[:2]
    if k.shape[0] != B:
        raise ValueError("q and K/V batch differ")
    Skv = k.shape[1]
    for name, t, shape in (("q_pos", q_pos, (B, Sq)), ("q_seg", q_seg, (B, Sq)),
                           ("kv_pos", kv_pos, (B, Skv)),
                           ("kv_seg", kv_seg, (B, Skv))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}")
    _check_keys(q, Skv)


def check_paged_args(q, k_pool, v_pool, kv_pos_pool, block_tab,
                     positions) -> None:
    """Raise ValueError for any input the paged entry does not take."""
    _check_common(q, (k_pool, v_pool),
                  {"kv_pos_pool": kv_pos_pool, "block_tab": block_tab,
                   "positions": positions})
    B, Sq = q.shape[:2]
    N, bs = k_pool.shape[:2]
    if tuple(kv_pos_pool.shape) != (N, bs):
        raise ValueError(f"kv_pos_pool must be {(N, bs)}")
    if block_tab.dim() != 2 or block_tab.shape[0] != B:
        raise ValueError(f"block_tab must be ({B}, nbt)")
    if tuple(positions.shape) != (B, Sq):
        raise ValueError(f"positions must be {(B, Sq)}")
    _check_keys(q, block_tab.shape[1] * bs)


def _check_keys(q, n_keys: int) -> None:
    if q.dtype == torch.bfloat16 and n_keys > MAX_BF16_KEYS:
        raise ValueError(f"{n_keys} keys: the bf16 kernel walks at most "
                         f"{MAX_BF16_KEYS}")


def flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal: bool = True,
                  window: int = 0):
    """Contiguous packed-varlen entry (shapes as the plain version)."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                   causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_flash_args(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    out = load_kernels().flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                       bool(causal), int(window),
                                       q.shape[-1] ** -0.5)
    flash_prefill.launches += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, kv_pos_pool, block_tab,
                            positions, window: int = 0):
    """Paged-KV chunk entry (shapes as the plain version).  The kernel
    walks logical blocks 0 .. max(positions) // bs only."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, kv_pos_pool,
                                             block_tab, positions, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_paged_args(q, k_pool, v_pool, kv_pos_pool, block_tab, positions)
    out = load_kernels().paged_prefill_attention(
        q, k_pool, v_pool, kv_pos_pool, block_tab, positions, int(window),
        q.shape[-1] ** -0.5)
    paged_prefill_attention.launches += 1
    return out


flash_prefill.launches = 0
paged_prefill_attention.launches = 0
