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
device memory.  Both dtypes run both products on wgmma (CTAs of 64, 128
or, bf16 at head dim 64, 192 (query, head) rows, a K/V ring filled by
TMA or cp.async, and, for grids that would leave SMs idle, a split over
the keys whose partials the decode kernels' merge combines).  fp32 runs
each product as three TF32 products (3xTF32: every operand split into a
TF32 big part and a small remainder), which holds the fp32 path's 1e-4
agreement whatever `torch.backends.cuda.matmul.allow_tf32` says — see
the source note.  `flash_splits` picks either body's rows and splits
from the shapes and what the binding reads of the card (`flash_config`:
the tile's keys, the CTAs an SM holds, the SM count), so a captured step
replays the same plan; only calls that are not causal split.

Each wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU (and `meta`) tensors; `<wrapper>.launches` counts
wrapper calls that launched (one, also when a split adds the merge
kernel), `<wrapper>.last_plan` is the (rows, splits) the last call
passed to the kernel (None after a plain call), and `flash_prefill.launches_noncausal` counts those made with
causal=False (the encoder's self-attention and cross-attention).

`flash_prefill_train` is the contiguous entry under autograd (the
training forward): its forward is `flash_prefill` (the kernel on the
card), its backward plain torch ops, as the reference's training
attention (`flash_attention_xla`) has an XLA backward and no kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_kernels
from repro_torch.kernels.decode_attention.ops import _sm_count
from repro_torch.models.attention import (
    NEG_INF, build_mask, gather_paged, gather_paged_pos, gqa_reference,
)

HEAD_DIMS = (64, 120, 128)  # head dims of the contiguous entry
PAGED_HEAD_DIMS = (64, 128)  # ... and of the paged entry
DTYPES = (torch.float32, torch.bfloat16)
# keys the bf16 body walks at most (Skv, or nbt * bs on the paged entry).
# Shared memory no longer bounds it (the pre-pass summarises 32 tiles at
# a time); the limit stays where the callers and tests have it.
MAX_BF16_KEYS = 1 << 21
# (query, head) rows a CTA to ask the binding about, most first; it says
# which the compiled bodies have (192 at head dim 64 only) and how many
# CTAs of each an SM holds
FLASH_ROW_SIZES = (192, 128, 64)
FLASH_MIN_SPLIT_TILES = 4   # key tiles a split takes at least


class FlashConfig(NamedTuple):
    """What the planner needs of a card for one body (dtype, head dim,
    entry), as the binding reads it from the compiled kernels
    (`flash_config`)."""
    keys: int                   # keys a K/V tile
    ctas_per_sm: dict           # {rows a CTA: CTAs an SM holds}
    sm_count: int


@functools.lru_cache(maxsize=None)
def flash_config(device: torch.device, hd: int, paged: bool,
                 dtype: torch.dtype) -> FlashConfig:
    """The bodies of one dtype and entry at head dim `hd` on a CUDA
    `device`: their tile's keys and the CTAs an SM holds at each row count
    (the occupancy calculator on the compiled kernel), and the SM
    count."""
    ext = load_kernels()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    fp32 = dtype == torch.float32
    occ = {r: ext.flash_ctas_per_sm(index, hd, paged, r, fp32)
           for r in FLASH_ROW_SIZES}
    return FlashConfig(ext.flash_tile_keys(),
                       {r: n for r, n in occ.items() if n > 0},
                       _sm_count(device))


def _cta_rows(Sq: int, H: int, K: int, rows: int) -> int:
    """CTAs of one batch row with `rows` (query, head) rows each: the G =
    H / K heads of a kv head share a CTA when G divides `rows`, else one
    head a CTA."""
    G = H // K
    gp = G if rows % G == 0 else 1
    return -(-Sq * gp // rows) * (H // gp)


def flash_splits(B: int, Sq: int, H: int, K: int, n_keys: int,
                 causal: bool, config: FlashConfig) -> tuple[int, int]:
    """(rows a CTA, splits) of a body, from the shapes alone (never
    from positions or segments: a step graph replays the same plan, and
    reading them would sync the host), by the rule that
    `scripts/flash_prefill_plans.py` checked at the port's shapes
    (PERF.md section 6).  Rows: the body whose busiest SM walks
    the fewest (query, head) rows in series, ceil(CTAs / SMs) x rows,
    ties to the most rows (each K/V tile read by more queries).  Splits,
    only for calls that are not causal (every key of every row live, as
    whisper's encoder and cross-attention): when the CTAs leave more than
    a quarter of the SMs idle, each row's `n_keys` are cut into splits of
    ceil(n_tiles / splits) tiles, as many as fill the SMs' CTA slots
    without a second wave, none under `FLASH_MIN_SPLIT_TILES` tiles, so
    every split owns at least one tile.  A causal call's live keys are a
    prefix of `n_keys` that only the kernel sees (a chunk early in its
    cache has few), so splits cut over `n_keys` would run empty there."""
    if Sq <= 0 or H <= 0 or K <= 0 or H % K:
        raise ValueError(f"bad shape Sq={Sq} H={H} K={K}")
    sms = config.sm_count

    def busiest(rows):
        return -(-B * _cta_rows(Sq, H, K, rows) // sms) * rows
    rows = min(sorted(config.ctas_per_sm, reverse=True), key=busiest)
    ctas = B * _cta_rows(Sq, H, K, rows)
    if causal or 4 * ctas > 3 * sms:
        return rows, 1
    n_tiles = max(1, -(-n_keys // config.keys))
    want = max(1, config.ctas_per_sm[rows] * sms // ctas)
    per = max(FLASH_MIN_SPLIT_TILES, -(-n_tiles // want))
    return rows, -(-n_tiles // per)


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


def flash_plan(q, n_keys: int, K: int, causal: bool, paged: bool,
               config: FlashConfig | None = None) -> tuple[int, int]:
    """The (rows, splits) a wrapper call passes for q over `n_keys` keys
    of K kv heads: `flash_splits` with the `flash_config` of q's card and
    dtype (or `config`)."""
    B, Sq, H, hd = q.shape
    if config is None:
        config = flash_config(q.device, hd, paged, q.dtype)
    return flash_splits(B, Sq, H, K, n_keys, causal, config)


def flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal: bool = True,
                  window: int = 0):
    """Contiguous packed-varlen entry (shapes as the plain version).
    Head dims 64, 120 and 128 (`HEAD_DIMS`; 120 runs the 128-wide body
    with the padding zeroed)."""
    if q.device.type in PLAIN_DEVICES:
        flash_prefill.last_plan = None
        return flash_prefill_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                   causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_flash_args(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    rows, n_split = flash_plan(q, k.shape[1], k.shape[2], bool(causal),
                               paged=False)
    out = load_kernels().flash_prefill(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                       bool(causal), int(window),
                                       q.shape[-1] ** -0.5, rows, n_split)
    flash_prefill.launches += 1
    flash_prefill.last_plan = (rows, n_split)
    if not causal:
        flash_prefill.launches_noncausal += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, kv_pos_pool, block_tab,
                            positions, window: int = 0):
    """Paged-KV chunk entry (shapes as the plain version).  Head dims 64
    and 128 (`PAGED_HEAD_DIMS`); the kernel walks logical blocks
    0 .. max(positions) // bs only."""
    if q.device.type in PLAIN_DEVICES:
        paged_prefill_attention.last_plan = None
        return paged_prefill_attention_plain(q, k_pool, v_pool, kv_pos_pool,
                                             block_tab, positions, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_paged_args(q, k_pool, v_pool, kv_pos_pool, block_tab, positions)
    rows, n_split = flash_plan(q, block_tab.shape[1] * k_pool.shape[1],
                               k_pool.shape[2], True, paged=True)
    out = load_kernels().paged_prefill_attention(
        q, k_pool, v_pool, kv_pos_pool, block_tab, positions, int(window),
        q.shape[-1] ** -0.5, rows, n_split)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.last_plan = (rows, n_split)
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
flash_prefill.last_plan = None
paged_prefill_attention.launches = 0
paged_prefill_attention.last_plan = None
