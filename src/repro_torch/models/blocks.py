"""Transformer blocks of the paged serving path, dense GQA branch.

Counterpart of `repro/models/blocks.py` (`init_attn_params`,
`init_dense_mlp_params`, `_paged_write_site(s)`, `attn_decode_paged`,
`attn_extend_paged`, `block_decode_paged`, `block_extend_paged`).  The
attention itself runs through the port's kernels
(`repro_torch.kernels`), which take their plain versions on the CPU.

Unlike the JAX functions, which return new pools, these write the new
tokens' K/V and positions into the pools IN PLACE and return only the
hidden states.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_prefill import paged_prefill_attention
from repro_torch.models.layers import apply_rope, init_linear, rms_norm, swiglu


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
    if kind != LayerKind.DENSE or cfg.d_ff <= 0:
        raise NotImplementedError(
            f"{kind} blocks are not ported yet (ROADMAP Queue 1 items 9-12)")
    D = cfg.d_model
    return {
        "ln1": torch.ones(D, dtype=dtype, device=gen.device),
        "attn": init_attn_params(gen, cfg, dtype),
        "ln2": torch.ones(D, dtype=dtype, device=gen.device),
        "mlp": init_dense_mlp_params(gen, cfg, dtype),
    }


# ---------------------------------------------------------------------------
# Paged attention sub-layer
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
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


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
