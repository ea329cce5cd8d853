"""Paged decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces `repro/kernels/decode_attention/kernel.py`
`paged_decode_attention_pallas`.  The kernel
(`repro_torch/csrc/paged_decode_attention.cu`) is bound by the bytes of
each row's live K/V pages; one CTA per (row, kv head) walks only the
row's live blocks with an fp32 online softmax — see the source note.

`paged_decode_attention` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; `paged_decode_attention.launches`
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_kernels
from repro_torch.models.attention import decode_attention_paged

HEAD_DIMS = (64, 128)       # head dims the kernel is instantiated for
MAX_GROUP = 8               # query heads per kv head one CTA handles
DTYPES = (torch.float32, torch.bfloat16)


def paged_decode_attention_plain(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                 pos, window: int = 0):
    """Dense block-gather version.  q (B, H, hd); pools (N, bs, K, hd);
    kv_pos_pool (N, bs) int32; block_tab (B, nbt) int32 (-1 = unset);
    pos (B,) int32  ->  (B, H, hd)."""
    return decode_attention_paged(q[:, None], k_pool, v_pool, kv_pos_pool,
                                  block_tab, pos, window)[:, 0]


def check_args(q, k_pool, v_pool, kv_pos_pool, block_tab, pos) -> None:
    """Raise ValueError for any input the kernel does not take."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("q must be (B, H, hd) and pools (N, bs, K, hd)")
    B, H, hd = q.shape
    N, bs, K, hd_k = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if tuple(kv_pos_pool.shape) != (N, bs):
        raise ValueError(f"kv_pos_pool must be {(N, bs)}")
    if block_tab.dim() != 2 or block_tab.shape[0] != B:
        raise ValueError(f"block_tab must be ({B}, nbt)")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},)")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share one dtype of {DTYPES}")
    for name, t in (("kv_pos_pool", kv_pos_pool), ("block_tab", block_tab),
                    ("pos", pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"H={H}, K={K}: need H % K == 0 and "
                         f"H // K <= {MAX_GROUP}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("kv_pos_pool", kv_pos_pool), ("block_tab", block_tab),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def paged_decode_attention(q, k_pool, v_pool, kv_pos_pool, block_tab, pos,
                           window: int = 0):
    """One query token per row over its K/V pages (shapes as the plain
    version).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, kv_pos_pool,
                                            block_tab, pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_args(q, k_pool, v_pool, kv_pos_pool, block_tab, pos)
    out = load_kernels().paged_decode_attention(
        q, k_pool, v_pool, kv_pos_pool, block_tab, pos, int(window),
        q.shape[-1] ** -0.5)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
