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
version only for CPU (and `meta`) tensors; `<wrapper>.launches` counts
launches, and `flash_prefill.launches_noncausal` those of them made
with causal=False (the encoder's self-attention and cross-attention).

`flash_prefill_train` is the contiguous entry under autograd (the
training forward): its forward is `flash_prefill` (the kernel on the
card), its backward plain torch ops, as the reference's training
attention (`flash_attention_xla`) has an XLA backward and no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_kernels
from repro_torch.models.attention import (
    NEG_INF, build_mask, gather_paged, gather_paged_pos, gqa_reference,
)

HEAD_DIMS = (64, 120, 128)  # head dims of the contiguous entry
PAGED_HEAD_DIMS = (64, 128)  # ... and of the paged entry
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


def _check_common(q, kv, ints, head_dims) -> None:
    if q.dim() != 4 or kv[0].dim() != 4:
        raise ValueError("q must be (B, Sq, H, hd) and K/V 4-d")
    H, hd = q.shape[2], q.shape[3]
    K = kv[0].shape[2]
    if tuple(kv[1].shape) != tuple(kv[0].shape) or kv[0].shape[3] != hd:
        raise ValueError(f"K/V shapes {tuple(kv[0].shape)}, "
                         f"{tuple(kv[1].shape)} do not match q")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in kv):
        raise ValueError(f"q, K and V must share one dtype of {DTYPES}")
    if hd not in head_dims:
        raise ValueError(f"head dim {hd} not in {head_dims}")
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
                              "q_seg": q_seg, "kv_seg": kv_seg}, HEAD_DIMS)
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
                   "positions": positions}, PAGED_HEAD_DIMS)
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
    """Contiguous packed-varlen entry (shapes as the plain version).
    Head dims 64, 120 and 128 (`HEAD_DIMS`; 120 runs the 128-wide bf16
    body with the padding zeroed)."""
    if q.device.type in PLAIN_DEVICES:
        return flash_prefill_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                   causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_flash_args(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    out = load_kernels().flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                       bool(causal), int(window),
                                       q.shape[-1] ** -0.5)
    flash_prefill.launches += 1
    if not causal:
        flash_prefill.launches_noncausal += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, kv_pos_pool, block_tab,
                            positions, window: int = 0):
    """Paged-KV chunk entry (shapes as the plain version).  Head dims 64
    and 128 (`PAGED_HEAD_DIMS`); the kernel walks logical blocks
    0 .. max(positions) // bs only."""
    if q.device.type in PLAIN_DEVICES:
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


TRAIN_BLOCK = 512  # query rows one backward step holds scores for


def flash_prefill_backward(q, k, v, o, do, q_pos, kv_pos, q_seg, kv_seg,
                           causal: bool = True, window: int = 0):
    """The gradient of `flash_prefill` with respect to q, k and v, in
    fp32 torch ops over TRAIN_BLOCK query rows at a time (so no (B, H,
    Sq, Skv) matrix is held): P recomputed from q, k and the mask, then
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale, dK and dV summed over the G query heads of each KV
    head.  A fully masked query row has P = 0, so it gives no gradient,
    as it gives a zero output.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    k32, v32 = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for lo in range(0, Sq, TRAIN_BLOCK):
        hi = min(lo + TRAIN_BLOCK, Sq)
        t = hi - lo
        qg = q[:, lo:hi].float().reshape(B, t, K, G, hd)
        dog = do[:, lo:hi].float().reshape(B, t, K, G, hd)
        og = o[:, lo:hi].float().reshape(B, t, K, G, hd)
        mask = build_mask(q_pos[:, lo:hi], kv_pos, q_seg[:, lo:hi], kv_seg,
                          causal, window)[:, None, None]   # (B,1,1,t,Skv)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k32) * scale
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
        dv += torch.einsum("bkgqs,bqkgh->bskh", p, dog)
        dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v32)
        rows = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
        ds = p * (dp - rows)
        dqs.append(torch.einsum("bkgqs,bskh->bqkgh", ds, k32) * scale)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashPrefillFn(torch.autograd.Function):
    """`flash_prefill` with its backward in torch ops
    (`flash_prefill_backward`); the int maps get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal, window):
        o = flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal,
                          window)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, q_seg, kv_seg, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, o = ctx.saved_tensors
        dq, dk, dv = flash_prefill_backward(q, k, v, o, do, q_pos, kv_pos,
                                            q_seg, kv_seg, ctx.causal,
                                            ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def flash_prefill_train(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                        causal: bool = True, window: int = 0):
    """The contiguous entry under autograd: forward by `flash_prefill`
    (the kernel for CUDA tensors, counted in `flash_prefill.launches`,
    the plain version for CPU tensors; it raises where `flash_prefill`
    raises), backward by `flash_prefill_backward`."""
    return _FlashPrefillFn.apply(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                 bool(causal), int(window))


flash_prefill.launches = 0
flash_prefill.launches_noncausal = 0
paged_prefill_attention.launches = 0
