"""Transformer blocks of the serving path: dense GQA and Mamba2 (SSM).

Counterpart of `repro/models/blocks.py` (`init_attn_params`,
`init_dense_mlp_params`, `init_block_params`; the dense-cache
`attn_decode`, `attn_extend`, `block_decode`, `block_extend` with their
SSM arms; the paged `_paged_write_site(s)`, `attn_decode_paged`,
`attn_extend_paged`, `block_decode_paged`, `block_extend_paged`, which
are attention-only).  Attention runs through the port's kernels
(`repro_torch.kernels`), the SSM prefill through the SSD kernel
(`repro_torch.models.mamba`); each takes its plain version on the CPU.

Unlike the JAX functions, which return new caches, the attention arms
write the new tokens' K/V and positions into the caches (dense rows or
paged pools) IN PLACE.  The SSM arms return new state tensors and leave
their inputs alone: an SSM step is not idempotent, so a step whose
result is dropped (a drained one) must leave the state it read intact.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig
from repro_torch.kernels.decode_attention import (
    decode_attention, paged_decode_attention,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill, paged_prefill_attention,
)
from repro_torch.models.layers import apply_rope, init_linear, rms_norm, swiglu
from repro_torch.models.mamba import (
    init_mamba_params, mamba_decode_step, mamba_forward,
)


# ---------------------------------------------------------------------------
# Parameter init (same shapes and scales as the JAX init)
# ---------------------------------------------------------------------------

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP Queue 1 item 10)")
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    return {
        "w_q": init_linear(gen, D, H * hd, dtype).reshape(D, H, hd),
        "w_k": init_linear(gen, D, K * hd, dtype).reshape(D, K, hd),
        "w_v": init_linear(gen, D, K * hd, dtype).reshape(D, K, hd),
        "w_o": init_linear(gen, H * hd, D, dtype).reshape(H, hd, D),
    }


def init_dense_mlp_params(gen: torch.Generator, cfg: ModelConfig,
                          dtype) -> Dict:
    return {
        "w_gate": init_linear(gen, cfg.d_model, cfg.d_ff, dtype),
        "w_up": init_linear(gen, cfg.d_model, cfg.d_ff, dtype),
        "w_down": init_linear(gen, cfg.d_ff, cfg.d_model, dtype),
    }


def init_block_params(gen: torch.Generator, cfg: ModelConfig,
                      kind: LayerKind, dtype) -> Dict:
    """A dense attention block, or an SSM block (Mamba2 mixer, plus the
    dense MLP when d_ff > 0)."""
    if kind not in (LayerKind.DENSE, LayerKind.SSM):
        raise NotImplementedError(
            f"{kind} blocks are not ported yet (ROADMAP Queue 1 item 9)")
    D = cfg.d_model
    p: Dict = {"ln1": torch.ones(D, dtype=dtype, device=gen.device)}
    if kind == LayerKind.DENSE:
        p["attn"] = init_attn_params(gen, cfg, dtype)
    else:
        p["mamba"] = init_mamba_params(gen, D, cfg.ssm, dtype)
    if cfg.d_ff > 0:
        p["ln2"] = torch.ones(D, dtype=dtype, device=gen.device)
        p["mlp"] = init_dense_mlp_params(gen, cfg, dtype)
    return p


# ---------------------------------------------------------------------------
# Attention sub-layers
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attention == AttentionKind.SWA else 0


def _qkv(p, x, cfg: ModelConfig, positions):
    """Projections + RoPE.  x (B, S, D); positions (B, S)."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["w_q"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (x @ p["w_k"].reshape(D, K * hd)).reshape(B, S, K, hd)
    v = (x @ p["w_v"].reshape(D, K * hd)).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, o):
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["w_o"].reshape(H * hd, -1)


def attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, kv_pos, pos):
    """Single-token decode against a dense cache: write the new K/V (in
    place) at index pos % S (a ring for SWA caches; S == max_len
    otherwise, so the index is pos), then attend.  x (B, 1, D); caches
    (B, S, K, hd); kv_pos (B, S); pos (B,).  Returns (B, 1, D)."""
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    idx = (pos % k_cache.shape[1]).long()
    k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
    kv_pos[rows, idx] = pos.to(kv_pos.dtype)
    o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, kv_pos, pos,
                         _window(cfg))
    return _out_proj(p, o[:, None].to(q.dtype))


def attn_extend(p, x, cfg: ModelConfig, k_cache, v_cache, kv_pos,
                positions):
    """Chunk extend against a dense cache: write the chunk's K/V (in
    place) at positions % S, THEN attend the chunk's queries over the
    whole cache with position masking (history and intra-chunk causality
    in one pass).  As in the reference, a ring cache takes the whole chunk
    before any of its queries attend, so once a prompt is past the window
    a chunk's first queries no longer see the keys the chunk's later
    tokens overwrote.  x (B, Sc, D); positions (B, Sc).  Returns
    (B, Sc, D)."""
    q, k, v = _qkv(p, x, cfg, positions)
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)[:, None]
    idx = (positions % k_cache.shape[1]).long()
    k_cache[rows, idx] = k.to(k_cache.dtype)
    v_cache[rows, idx] = v.to(v_cache.dtype)
    kv_pos[rows, idx] = positions.to(kv_pos.dtype)
    q_seg = torch.zeros_like(positions, dtype=torch.int32)
    kv_seg = torch.zeros_like(kv_pos, dtype=torch.int32)
    o = flash_prefill(q.contiguous(), k_cache, v_cache,
                      positions.to(torch.int32).contiguous(), kv_pos, q_seg,
                      kv_seg, causal=True, window=_window(cfg))
    return _out_proj(p, o.to(q.dtype))


def _paged_write_site(block_tab, pos, block_size):
    """Physical (block, offset) of each row's current token.  Rows whose
    logical block is unset write into the null block 0."""
    nbt = block_tab.shape[1]
    lb = torch.clamp(pos // block_size, 0, nbt - 1)
    phys = torch.gather(block_tab, 1, lb[:, None].long())[:, 0]
    return phys.clamp_min(0).long(), (pos % block_size).long()


def _paged_write_sites(block_tab, positions, block_size):
    """Per-token physical (block, offset) write sites for a chunk:
    block_tab (B, nbt); positions (B, Sc)."""
    nbt = block_tab.shape[1]
    lb = torch.clamp(positions // block_size, 0, nbt - 1)
    phys = torch.gather(block_tab, 1, lb.long())
    return phys.clamp_min(0).long(), (positions % block_size).long()


def attn_decode_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                      block_tab, pos):
    """Single-token decode against a paged pool: write the new K/V (in
    place) into the row's current physical block, then attend through the
    block table.  x (B, 1, D); pools (N, bs, K, hd); kv_pos_pool (N, bs);
    block_tab (B, nbt); pos (B,).  Returns (B, 1, D)."""
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    phys, off = _paged_write_site(block_tab, pos, k_pool.shape[1])
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    kv_pos_pool[phys, off] = pos.to(kv_pos_pool.dtype)
    o = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                               kv_pos_pool, block_tab, pos, _window(cfg))
    return _out_proj(p, o[:, None].to(q.dtype))


def attn_extend_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                      block_tab, positions):
    """Chunk extend against a paged pool: write the chunk's K/V (in
    place) into the row's physical blocks, then attend q over the pages
    through the block table (earlier chunks and shared-prefix pages
    included) with causal position masking.  x (B, Sc, D); positions
    (B, Sc).  Returns (B, Sc, D)."""
    q, k, v = _qkv(p, x, cfg, positions)
    phys, off = _paged_write_sites(block_tab, positions, k_pool.shape[1])
    k_pool[phys, off] = k.to(k_pool.dtype)
    v_pool[phys, off] = v.to(v_pool.dtype)
    kv_pos_pool[phys, off] = positions.to(kv_pos_pool.dtype)
    o = paged_prefill_attention(q.contiguous(), k_pool, v_pool, kv_pos_pool,
                                block_tab, positions, _window(cfg))
    return _out_proj(p, o.to(q.dtype))


def _mlp(p, x, cfg: ModelConfig):
    if "mlp" not in p:                  # an SSM block with d_ff == 0
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def block_decode(p, x, kind: LayerKind, cfg: ModelConfig, entry, kv_pos,
                 pos):
    """Single-token decode block over a dense cache entry: (k, v) rows of
    an attention layer (written in place), or (ssm_state, (conv_x,
    conv_bc)) of an SSM layer.  Returns (hidden (B, 1, D), the layer's
    new entry)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == LayerKind.DENSE:
        x = x + attn_decode(p["attn"], h, cfg, entry[0], entry[1], kv_pos,
                            pos)
    else:
        y, entry = mamba_decode_step(h, p["mamba"], cfg.ssm, entry[0],
                                     entry[1])
        x = x + y
    return _mlp(p, x, cfg), entry


def block_extend(p, x, kind: LayerKind, cfg: ModelConfig, entry, kv_pos,
                 positions):
    """Chunked-prefill block step over a dense cache entry (as
    `block_decode`).  The SSM arm scans the chunk with the SSD kernel,
    from the entry's state and conv tail.  Returns (hidden (B, Sc, D),
    the layer's new entry)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == LayerKind.DENSE:
        x = x + attn_extend(p["attn"], h, cfg, entry[0], entry[1], kv_pos,
                            positions)
    else:
        y, entry = mamba_forward(h, p["mamba"], cfg.ssm, entry[0], entry[1])
        x = x + y
    return _mlp(p, x, cfg), entry


def block_decode_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                       block_tab, pos):
    """Single-token decode block over a paged cache (pools written in
    place).  Returns the new hidden states (B, 1, D)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_decode_paged(p["attn"], h, cfg, k_pool, v_pool, kv_pos_pool,
                              block_tab, pos)
    return _mlp(p, x, cfg)


def block_extend_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                       block_tab, positions):
    """Chunked-prefill block step writing into paged pools (in place).
    Returns the new hidden states (B, Sc, D)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_extend_paged(p["attn"], h, cfg, k_pool, v_pool,
                              kv_pos_pool, block_tab, positions)
    return _mlp(p, x, cfg)
