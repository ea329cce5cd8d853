"""Attention math, plain PyTorch: the GQA einsum reference, decode
attention over a dense cache and over a paged (block-table) pool, and
the absorbed-form MLA decode scores.

Counterpart of `repro/models/attention.py:21-331`.  The GQA functions
are the CPU path of the port and the oracles its CUDA kernels are held
against (`repro_torch.kernels`); the MLA scores run on every device, as
MLA has no kernel.  Conventions kept from the reference:

  * a negative kv position marks an empty cache slot;
  * a -1 block-table entry reads physical block 0 (the null block) and
    is masked on gather, whatever inactive rows scribbled there;
  * a fully masked query row outputs 0, not NaN.

Shapes: q (B, Sq, H, hd); k, v (B, Skv, K, hd) with K = num_kv_heads,
G = H // K query heads per kv head.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def build_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
               q_seg: Optional[torch.Tensor] = None,
               kv_seg: Optional[torch.Tensor] = None,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask; True = attend."""
    m = kv_pos[:, None, :] >= 0
    m = m.expand(q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1])
    if causal:
        m = m & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window > 0:
        m = m & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    if q_seg is not None and kv_seg is not None:
        m = m & (q_seg[:, :, None] == kv_seg[:, None, :])
        m = m & (kv_seg[:, None, :] >= 0)
    return m


def gqa_reference(q, k, v, mask):
    """Naive einsum GQA attention (oracle for the flash kernel)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    p = torch.where(any_valid, p, 0.0).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(B, Sq, H, v.shape[-1])


def decode_attention(q, k_cache, v_cache, kv_pos, pos, window: int = 0):
    """Single-token decode attention.  q (B, 1, H, hd); caches
    (B, S, K, hd); kv_pos (B, S) (-1 = empty); pos (B,)."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = hd ** -0.5
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        valid = valid & ((pos[:, None] - kv_pos) < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1)[:, None, None, None], p, 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def gather_paged(pool, block_tab):
    """Materialise a request-contiguous view of a paged pool: pool
    (N, bs, ...), block_tab (B, nbt) with -1 = unset (read from the null
    block 0) -> (B, nbt*bs, ...)."""
    B, nbt = block_tab.shape
    bs = pool.shape[1]
    g = pool[block_tab.clamp_min(0)]                        # (B, nbt, bs, ...)
    return g.reshape((B, nbt * bs) + tuple(pool.shape[2:]))


def gather_paged_pos(kv_pos_pool, block_tab):
    """Positions of a block-gathered view; unset table entries read -1
    whatever the null block holds."""
    B, nbt = block_tab.shape
    g = kv_pos_pool[block_tab.clamp_min(0)]                 # (B, nbt, bs)
    g = torch.where(block_tab[..., None] < 0, -1, g)
    return g.reshape(B, nbt * kv_pos_pool.shape[1])


def decode_attention_paged(q, k_pool, v_pool, kv_pos_pool, block_tab, pos,
                           window: int = 0):
    """Single-token decode attention over a paged KV pool, by dense
    gather.  q (B, 1, H, hd); pools (N, bs, K, hd); kv_pos_pool (N, bs);
    block_tab (B, nbt); pos (B,)."""
    k = gather_paged(k_pool, block_tab)
    v = gather_paged(v_pool, block_tab)
    kv_pos = gather_paged_pos(kv_pos_pool, block_tab)
    return decode_attention(q, k, v, kv_pos, pos, window)


def mla_scores_decode(q_latent, q_rope, c_cache, kr_cache, kv_pos, pos):
    """Absorbed-form MLA decode weights: q_latent (B, H, r) scores against
    the latent cache c_cache (B, S, r) directly (no per-head K), q_rope
    (B, H, dr) against the shared rope keys kr_cache (B, S, dr).  Returns
    the softmax weights (B, H, S) in fp32 (all-invalid rows are 0) and
    the validity mask (B, S)."""
    s = torch.einsum("bhr,bsr->bhs", q_latent, c_cache).float()
    s = s + torch.einsum("bhd,bsd->bhs", q_rope, kr_cache).float()
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1)[:, None, None], p, 0.0)
    return p, valid
