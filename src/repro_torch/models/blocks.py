"""Transformer blocks of the serving path: GQA or MLA attention, or a
Mamba2 (SSM) mixer, then (in a decoder layer of an encoder-decoder
model) cross-attention to the encoder's output, then a dense SwiGLU or
an MoE FFN.

    kind DENSE   = attention + dense SwiGLU
    kind MOE     = attention + MoE
    kind SSM     = Mamba2 mixer + dense SwiGLU (or nothing when d_ff == 0)
    kind SSM_MOE = Mamba2 mixer + MoE           (jamba)

Counterpart of `repro/models/blocks.py` (`init_attn_params` with its
`cross` form, `init_dense_mlp_params`, `init_block_params`; the
full-sequence `_qkv_full`, `attn_full`, `cross_attn_full`, `mla_full`,
`block_full`; the dense-cache `attn_decode`, `attn_extend`,
`mla_decode`, `mla_extend`, `block_decode`, `block_extend` with their
SSM and cross-attention arms; the paged `_paged_write_site(s)`,
`attn_decode_paged`, `attn_extend_paged`, `mla_decode_paged`,
`mla_extend_paged`, `block_extend_paged`, which are attention-only, and
`block_decode_paged`, whose SSM arm keeps the state per slot beside the
pages).  GQA attention runs through the port's kernels
(`repro_torch.kernels`): the full-sequence forward and cross-attention
(prefill, chunk and decode alike) through kernel #2's contiguous entry,
causal or not, at every length; the SSM prefill through the SSD kernel
(`repro_torch.models.mamba`); each takes its plain version on the CPU.
Under autograd (the training forward) both go through their autograd
`Function`s, whose backward is torch ops.
MLA is the absorbed form over the latent cache (the compressed KV `ckv`
and the shared rope key `kr`, no head axis) in decode and extend, and
the non-absorbed form in `mla_full`, as torch matmuls: the reference
has no Pallas kernel for it.

Unlike the JAX functions, which return new caches, the attention arms
write the new tokens' K/V (MLA: latent and rope key) and positions into
the caches (dense rows or paged pools) IN PLACE.  The SSM arms return
new state tensors and leave their inputs alone: an SSM step is not
idempotent, so a step whose result is dropped (a drained one) must leave
the state it read intact.  The cross-attention arms read the encoder's
K/V from the cache and never write them.

Under tensor parallelism a layer's weights are one rank's share
(`repro_torch.distributed.sharding`): the attention sub-layers take
their head counts from the weights, so a rank's heads give its partial
output projection (`attn_split`), or, in the row-parallel form
(`row_split`), its d_model rows give partial projections, joined before
the attention runs whole; `attn_shards`, `cross_shards` and
`ssm_shards` run a mixer on the ranks of each DP and join it;
`mlp_shards` and `moe_lead_shards` join a split dense FFN's or shared
experts' partial sums (`ffn_split`, `shared_split`) and an MoE's rows
over each DP's ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig
from repro_torch.distributed.transfer import all_gather, all_reduce, broadcast
from repro_torch.kernels.decode_attention import (
    decode_attention, paged_decode_attention,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill, flash_prefill_train, paged_prefill_attention,
)
from repro_torch.models.attention import (
    NEG_INF, build_mask, gather_paged, gather_paged_pos, gqa_reference,
    mla_scores_decode,
)
from repro_torch.models.layers import apply_rope, init_linear, rms_norm, swiglu
from repro_torch.models.mamba import (
    init_mamba_params, mamba_decode_gated, mamba_decode_step, mamba_forward,
    ssm_dims,
)
from repro_torch.models.moe import _shared, init_moe_params, moe_block

ATTN_KINDS = (LayerKind.DENSE, LayerKind.MOE)


# ---------------------------------------------------------------------------
# Parameter init (same shapes and scales as the JAX init)
# ---------------------------------------------------------------------------

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                     cross: bool = False) -> Dict:
    """An attention sub-layer's weights: MLA's for an MLA config, GQA's
    otherwise and for cross-attention (`cross`)."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dev = gen.device
    if cfg.attention == AttentionKind.MLA and not cross:
        m = cfg.mla
        p: Dict = {}
        q_in = D
        if m.q_lora_rank:
            p["w_dq"] = init_linear(gen, D, m.q_lora_rank, dtype)
            p["q_norm"] = torch.ones(m.q_lora_rank, dtype=dtype, device=dev)
            q_in = m.q_lora_rank
        dq = m.qk_nope_head_dim + m.qk_rope_head_dim
        p["w_uq"] = init_linear(gen, q_in, H * dq, dtype).reshape(q_in, H, dq)
        p["w_dkv"] = init_linear(gen, D, m.kv_lora_rank, dtype)
        p["kv_norm"] = torch.ones(m.kv_lora_rank, dtype=dtype, device=dev)
        p["w_kr"] = init_linear(gen, D, m.qk_rope_head_dim, dtype)

        def latent(e):
            w = torch.randn((m.kv_lora_rank, H, e), generator=gen,
                            dtype=torch.float32, device=dev)
            return (w / math.sqrt(m.kv_lora_rank)).to(dtype)
        p["w_uk"] = latent(m.qk_nope_head_dim)
        p["w_uv"] = latent(m.v_head_dim)
        p["w_o"] = init_linear(gen, H * m.v_head_dim, D, dtype).reshape(
            H, m.v_head_dim, D)
        return p
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
                      kind: LayerKind, dtype, cross: bool = False) -> Dict:
    """An attention block (DENSE, MOE) or an SSM block (SSM, SSM_MOE),
    then cross-attention ("ln_x", "xattn") in a decoder layer of an
    encoder-decoder model (`cross`), then the MoE FFN (MOE and SSM_MOE
    kinds of a config with experts) or the dense MLP (when d_ff > 0)."""
    D = cfg.d_model
    p: Dict = {"ln1": torch.ones(D, dtype=dtype, device=gen.device)}
    if kind in ATTN_KINDS:
        p["attn"] = init_attn_params(gen, cfg, dtype)
    else:
        p["mamba"] = init_mamba_params(gen, D, cfg.ssm, dtype)
    if cross:
        p["ln_x"] = torch.ones(D, dtype=dtype, device=gen.device)
        p["xattn"] = init_attn_params(gen, cfg, dtype, cross=True)
    if kind in (LayerKind.MOE, LayerKind.SSM_MOE) and cfg.moe.num_experts:
        p["ln2"] = torch.ones(D, dtype=dtype, device=gen.device)
        p["moe"] = init_moe_params(gen, D, cfg.moe, dtype)
    elif cfg.d_ff > 0:
        p["ln2"] = torch.ones(D, dtype=dtype, device=gen.device)
        p["mlp"] = init_dense_mlp_params(gen, cfg, dtype)
    return p


# ---------------------------------------------------------------------------
# Attention sub-layers
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attention == AttentionKind.SWA else 0


def _qkv_full(p, x, cfg: ModelConfig, positions, use_rope: bool = True):
    """Projections, then RoPE unless `use_rope` is False (the whisper
    encoder).  x (B, S, D); positions (B, S).  The head counts are the
    weights' own: a tensor-parallel rank's share of them."""
    B, S, D = x.shape
    _D, H, hd = p["w_q"].shape
    K = p["w_k"].shape[1]
    q = (x @ p["w_q"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (x @ p["w_k"].reshape(D, K * hd)).reshape(B, S, K, hd)
    v = (x @ p["w_v"].reshape(D, K * hd)).reshape(B, S, K, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, o):
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["w_o"].reshape(H * hd, -1)


def _flash_full(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal, window=0):
    """Kernel #2's contiguous entry over whole sequences: the int32
    position and segment maps made contiguous, K/V in q's dtype.  Under
    autograd (grad mode on and q, k or v requiring grad: the training
    forward) it goes through `flash_prefill_train`, whose backward is
    torch ops; otherwise through the plain wrapper, so the serving
    paths and their step graphs call exactly what they called before."""
    i32 = [t.to(torch.int32).contiguous()
           for t in (q_pos, kv_pos, q_seg, kv_seg)]
    attend = flash_prefill
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        attend = flash_prefill_train
    o = attend(q.contiguous(), k.to(q.dtype).contiguous(),
               v.to(q.dtype).contiguous(), *i32, causal=causal,
               window=window)
    return o.to(q.dtype)


def attn_full(p, x, cfg: ModelConfig, positions, seg=None, causal=True,
              use_rope=True):
    """Full-sequence self-attention: every token attends to the tokens of
    its segment (`seg` (B, S), -1 = pad; None = one segment) at
    positions up to its own (`causal`) and within the window (SWA).
    Kernel #2's contiguous entry at every length: the reference's switch
    at FLASH_THRESHOLD chooses between two forms of the same function.
    x (B, S, D); positions (B, S).  Returns (out (B, S, D), (k, v) of
    shape (B, S, K, hd) for the cache)."""
    q, k, v = _qkv_full(p, x, cfg, positions, use_rope)
    seg = torch.zeros_like(positions) if seg is None else seg
    o = _flash_full(q, k, v, positions, positions, seg, seg, causal,
                    _window(cfg))
    return _out_proj(p, o), (k, v)


def cross_attn_full(p, x, enc_out, cfg: ModelConfig, enc_kv=None, q=None):
    """Cross-attention of a decoder layer (whisper): no RoPE, every query
    sees every encoder position.  Keys and values are projected from
    `enc_out` (B, Se, D), or read from the cache (`enc_kv`, each (B, Se,
    K, hd)).  Kernel #2's contiguous entry, not causal, with all
    positions and segments 0 (the reference's mask), for prefill, chunk
    and decode (Sq = 1) alike.  x (B, S, D); `q` (B, S, H, hd) the
    queries where they come joined from the ranks (`cross_shards`).
    Returns (out (B, S, D), (k, v))."""
    B, S, D = x.shape
    _D, H, hd = p["w_q"].shape
    K = p["w_k"].shape[1]
    if q is None:
        q = (x @ p["w_q"].reshape(D, H * hd)).reshape(B, S, H, hd)
    if enc_kv is None:
        Se = enc_out.shape[1]
        k = (enc_out @ p["w_k"].reshape(D, K * hd)).reshape(B, Se, K, hd)
        v = (enc_out @ p["w_v"].reshape(D, K * hd)).reshape(B, Se, K, hd)
    else:
        k, v = enc_kv
    zq = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    zk = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=x.device)
    o = _flash_full(q, k, v, zq, zk, zq, zk, causal=False)
    return _out_proj(p, o), (k, v)


def attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, kv_pos, pos):
    """Single-token decode against a dense cache: write the new K/V (in
    place) at index pos % S (a ring for SWA caches; S == max_len
    otherwise, so the index is pos), then attend.  x (B, 1, D); caches
    (B, S, K, hd); kv_pos (B, S); pos (B,).  Returns (B, 1, D)."""
    q, k, v = _qkv_full(p, x, cfg, pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    idx = (pos % k_cache.shape[1]).long()
    k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
    kv_pos[rows, idx] = pos.to(kv_pos.dtype)
    o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, kv_pos, pos,
                         _window(cfg))
    return _out_proj(p, o[:, None].to(q.dtype))


def attn_extend(p, x, cfg: ModelConfig, k_cache, v_cache, kv_pos,
                positions, qkv=None):
    """Chunk extend against a dense cache: write the chunk's K/V (in
    place) at positions % S, THEN attend the chunk's queries over the
    whole cache with position masking (history and intra-chunk causality
    in one pass).  As in the reference, a ring cache takes the whole chunk
    before any of its queries attend, so once a prompt is past the window
    a chunk's first queries no longer see the keys the chunk's later
    tokens overwrote.  x (B, Sc, D); positions (B, Sc).  Returns
    (B, Sc, D).  `qkv`: the projections where they come joined from the
    ranks (the row-parallel form, `attn_shards`)."""
    q, k, v = qkv or _qkv_full(p, x, cfg, positions)
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
                      block_tab, pos, qkv=None):
    """Single-token decode against a paged pool: write the new K/V (in
    place) into the row's current physical block, then attend through the
    block table.  x (B, 1, D); pools (N, bs, K, hd); kv_pos_pool (N, bs);
    block_tab (B, nbt); pos (B,); `qkv` as `attn_extend`'s.  Returns
    (B, 1, D)."""
    q, k, v = qkv or _qkv_full(p, x, cfg, pos[:, None])
    phys, off = _paged_write_site(block_tab, pos, k_pool.shape[1])
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    kv_pos_pool[phys, off] = pos.to(kv_pos_pool.dtype)
    o = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                               kv_pos_pool, block_tab, pos, _window(cfg))
    return _out_proj(p, o[:, None].to(q.dtype))


def attn_extend_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                      block_tab, positions, qkv=None):
    """Chunk extend against a paged pool: write the chunk's K/V (in
    place) into the row's physical blocks, then attend q over the pages
    through the block table (earlier chunks and shared-prefix pages
    included) with causal position masking.  x (B, Sc, D); positions
    (B, Sc); `qkv` as `attn_extend`'s.  Returns (B, Sc, D)."""
    q, k, v = qkv or _qkv_full(p, x, cfg, positions)
    phys, off = _paged_write_sites(block_tab, positions, k_pool.shape[1])
    k_pool[phys, off] = k.to(k_pool.dtype)
    v_pool[phys, off] = v.to(v_pool.dtype)
    kv_pos_pool[phys, off] = positions.to(kv_pos_pool.dtype)
    o = paged_prefill_attention(q.contiguous(), k_pool, v_pool, kv_pos_pool,
                                block_tab, positions, _window(cfg))
    return _out_proj(p, o.to(q.dtype))


# ---------------------------------------------------------------------------
# MLA sub-layers (absorbed form over the latent cache)
# ---------------------------------------------------------------------------

def _mla_q(p, x, cfg: ModelConfig, positions):
    """Per-head query halves: (q_nope (B, S, H, dn), q_rope (B, S, H, dr)
    with RoPE applied).  x (B, S, D); positions (B, S)."""
    m = cfg.mla
    B, S, D = x.shape
    h = x
    if m.q_lora_rank:
        h = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    w = p["w_uq"]
    q = (h @ w.reshape(w.shape[0], -1)).reshape(B, S, w.shape[1],
                                                  w.shape[2])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """The tokens' cache entries: the normalised latent (B, S, r) and the
    shared rope key (B, S, dr)."""
    ckv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_decode_attend(p, cfg, q_nope, q_rope, ckv, kr, kv_pos, pos):
    """One query token per row over the (gathered) latent cache: ckv
    (B, S, r), kr (B, S, dr), kv_pos (B, S).  q_nope/q_rope (B, H, ·).
    Returns (B, 1, D)."""
    scale = _mla_scale(cfg)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope, p["w_uk"])
    pattn, _ = mla_scores_decode((q_lat * scale).to(ckv.dtype),
                                 (q_rope * scale).to(kr.dtype),
                                 ckv, kr, kv_pos, pos)
    ctx = torch.einsum("bhs,bsr->bhr", pattn.to(ckv.dtype), ckv)
    o = torch.einsum("bhr,rhe->bhe", ctx, p["w_uv"])
    H, E, D = p["w_o"].shape
    return (o.reshape(-1, H * E) @ p["w_o"].reshape(H * E, D))[:, None]


def _mla_extend_attend(p, cfg, q_nope, q_rope, ckv, kr, kv_pos, positions):
    """A chunk's queries (B, Sc, H, ·) over the (gathered) latent cache
    with causal position masking, scored in fp32.  Returns (B, Sc, D)."""
    scale = _mla_scale(cfg)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["w_uk"]) * scale
    s = torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
    s = s + torch.einsum("bshd,btd->bhst", (q_rope * scale).float(),
                         kr.float())
    valid = (kv_pos >= 0)[:, None, None, :] & \
        (kv_pos[:, None, None, :] <= positions[:, None, :, None])
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(valid.any(dim=-1)[..., None], w, 0.0)
    ctx = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
    o = torch.einsum("bshr,rhe->bshe", ctx, p["w_uv"])
    B, Sc, H, E = o.shape
    return o.reshape(B, Sc, H * E) @ p["w_o"].reshape(H * E, -1)


FLASH_THRESHOLD = 2048   # past this length mla_full attends block by block
FLASH_BLOCK = 512


def _masked_attention(q, k, v, positions, seg):
    """Causal masked attention within segments (`gqa_reference`).  Past
    FLASH_THRESHOLD keys it runs FLASH_BLOCK queries at a time, so that
    it holds B·H·FLASH_BLOCK·S scores rather than B·H·S²: the same
    softmax row by row, as the reference's `flash_attention_xla` keeps
    its memory bounded there."""
    S = k.shape[1]
    if S <= FLASH_THRESHOLD:
        return gqa_reference(q, k, v, build_mask(positions, positions, seg,
                                                 seg, True, 0))

    def rows(lo, hi):
        qs = None if seg is None else seg[:, lo:hi]
        return gqa_reference(q[:, lo:hi], k, v, build_mask(
            positions[:, lo:hi], positions, qs, seg, True, 0))
    return torch.cat([rows(lo, lo + FLASH_BLOCK)
                      for lo in range(0, q.shape[1], FLASH_BLOCK)], dim=1)


def mla_full(p, x, cfg: ModelConfig, positions, seg=None):
    """Full-sequence MLA in the non-absorbed form, as the reference's:
    per-head k_nope and v expanded from the latent, the shared rope key
    broadcast over the heads, causal masked attention within segments.
    Torch matmuls and the plain masked attention (`_masked_attention`,
    blockwise past FLASH_THRESHOLD): the q/k head dim (nope + rope, e.g.
    96 or 192) and the v head dim lie outside kernel #2's contract
    (`HEAD_DIMS`), and the reference has no Pallas kernel for MLA.
    x (B, S, D); positions (B, S).  Returns (out (B, S, D), (latent
    (B, S, r), rope key (B, S, dr)) for the cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhe->bshe", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", ckv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = _masked_attention(q, k, v, positions, seg)
    return o.reshape(B, S, H * m.v_head_dim) @ p["w_o"].reshape(
        H * m.v_head_dim, -1), (ckv, k_rope)


def mla_decode(p, x, cfg: ModelConfig, ckv_cache, kr_cache, kv_pos, pos):
    """Absorbed-form MLA decode against a dense latent cache: write the
    token's latent and rope key (in place) at pos % S, then attend.
    x (B, 1, D); ckv_cache (B, S, r); kr_cache (B, S, dr); kv_pos (B, S);
    pos (B,).  Returns (B, 1, D)."""
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    ckv, kr = _mla_latent(p, x, cfg, pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    idx = (pos % ckv_cache.shape[1]).long()
    ckv_cache[rows, idx] = ckv[:, 0].to(ckv_cache.dtype)
    kr_cache[rows, idx] = kr[:, 0].to(kr_cache.dtype)
    kv_pos[rows, idx] = pos.to(kv_pos.dtype)
    return _mla_decode_attend(p, cfg, q_nope[:, 0], q_rope[:, 0], ckv_cache,
                              kr_cache, kv_pos, pos)


def mla_extend(p, x, cfg: ModelConfig, ckv_cache, kr_cache, kv_pos,
               positions):
    """Chunk extend for MLA over a dense latent cache: write the chunk's
    latents and rope keys (in place) at positions % S, then attend the
    chunk's queries over the whole cache.  x (B, Sc, D); positions
    (B, Sc).  Returns (B, Sc, D)."""
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    idx = (positions % ckv_cache.shape[1]).long()
    ckv_cache[rows, idx] = ckv.to(ckv_cache.dtype)
    kr_cache[rows, idx] = kr.to(kr_cache.dtype)
    kv_pos[rows, idx] = positions.to(kv_pos.dtype)
    return _mla_extend_attend(p, cfg, q_nope, q_rope, ckv_cache, kr_cache,
                              kv_pos, positions)


def mla_decode_paged(p, x, cfg: ModelConfig, ckv_pool, kr_pool, kv_pos_pool,
                     block_tab, pos):
    """Absorbed-form MLA decode over paged latent pools (ckv_pool
    (N, bs, r); kr_pool (N, bs, dr)): write the token's entries (in place)
    into the row's current physical block, then attend through the block
    table.  Returns (B, 1, D)."""
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    ckv, kr = _mla_latent(p, x, cfg, pos[:, None])
    phys, off = _paged_write_site(block_tab, pos, ckv_pool.shape[1])
    ckv_pool[phys, off] = ckv[:, 0].to(ckv_pool.dtype)
    kr_pool[phys, off] = kr[:, 0].to(kr_pool.dtype)
    kv_pos_pool[phys, off] = pos.to(kv_pos_pool.dtype)
    return _mla_decode_attend(
        p, cfg, q_nope[:, 0], q_rope[:, 0], gather_paged(ckv_pool, block_tab),
        gather_paged(kr_pool, block_tab),
        gather_paged_pos(kv_pos_pool, block_tab), pos)


def mla_extend_paged(p, x, cfg: ModelConfig, ckv_pool, kr_pool, kv_pos_pool,
                     block_tab, positions):
    """Chunk extend for MLA over paged latent pools: write the chunk's
    entries (in place) into the row's physical blocks, then attend over
    the pages through the block table (earlier chunks and shared-prefix
    pages included).  Returns (B, Sc, D)."""
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    phys, off = _paged_write_sites(block_tab, positions, ckv_pool.shape[1])
    ckv_pool[phys, off] = ckv.to(ckv_pool.dtype)
    kr_pool[phys, off] = kr.to(kr_pool.dtype)
    kv_pos_pool[phys, off] = positions.to(kv_pos_pool.dtype)
    return _mla_extend_attend(
        p, cfg, q_nope, q_rope, gather_paged(ckv_pool, block_tab),
        gather_paged(kr_pool, block_tab),
        gather_paged_pos(kv_pos_pool, block_tab), positions)


def _mlp(p, x, cfg: ModelConfig):
    """The block's FFN with its residual: MoE, dense SwiGLU, or none (an
    SSM block with d_ff == 0)."""
    if "moe" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_block(h, p["moe"], cfg.moe)[0]
    if "mlp" not in p:
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def cross_block(p, x, cfg: ModelConfig, enc_kv):
    """A decoder layer's cross-attention over the cached encoder K/V,
    with its residual; x itself in a layer without one."""
    if "xattn" not in p:
        return x
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    return x + cross_attn_full(p["xattn"], h, None, cfg, enc_kv=enc_kv)[0]


def _split_enc(p, entry):
    """(the layer's own entry, its encoder K/V or None): a decoder layer
    of an encoder-decoder model gets (entry, (enc_k, enc_v))."""
    return entry if "xattn" in p else (entry, None)


def block_full(p, x, kind: LayerKind, cfg: ModelConfig, positions, seg=None,
               causal=True, use_rope=True, enc_out=None, ssm_init=None,
               conv_init=None):
    """Full-sequence block (prefill, the encoder): the mixer over the
    whole sequence (attention through `attn_full`/`mla_full`, an SSM
    layer through `mamba_forward` from `ssm_init`/`conv_init`, the SSD
    kernel on the card), cross-attention to `enc_out` in a decoder layer
    of an encoder-decoder model, then the FFN.  Returns (hidden (B, S,
    D), the layer's cache entry: (k, v), MLA's (latent, rope key) or an
    SSM layer's (state, (conv_x, conv_bc)), paired with the encoder's
    (k, v) in a cross-attention layer; the MoE aux loss, fp32 0 without
    one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        if cfg.attention == AttentionKind.MLA:
            y, entry = mla_full(p["attn"], h, cfg, positions, seg)
        else:
            y, entry = attn_full(p["attn"], h, cfg, positions, seg, causal,
                                 use_rope)
    else:
        y, entry = mamba_forward(h, p["mamba"], cfg.ssm, ssm_init,
                                 conv_init)
    x = x + y
    if "xattn" in p:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        y, enc_kv = cross_attn_full(p["xattn"], h, enc_out, cfg)
        x = x + y
        entry = (entry, enc_kv)
    if "moe" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, laux = moe_block(h, p["moe"], cfg.moe)
        return x + y, entry, aux + laux
    return _mlp(p, x, cfg), entry, aux


def block_decode(p, x, kind: LayerKind, cfg: ModelConfig, entry, kv_pos,
                 pos):
    """Single-token decode block over a dense cache entry: (k, v) rows of
    an attention layer, (latent, rope key) rows of an MLA layer (written
    in place), or (ssm_state, (conv_x, conv_bc)) of an SSM layer; in a
    decoder layer of an encoder-decoder model, (that entry, (enc_k,
    enc_v)), the encoder K/V only read.  Returns (hidden (B, 1, D), the
    layer's new entry, without the encoder K/V)."""
    entry, enc_kv = _split_enc(p, entry)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        attend = (mla_decode if cfg.attention == AttentionKind.MLA
                  else attn_decode)
        x = x + attend(p["attn"], h, cfg, entry[0], entry[1], kv_pos, pos)
    else:
        y, entry = mamba_decode_step(h, p["mamba"], cfg.ssm, entry[0],
                                     entry[1])
        x = x + y
    return _mlp(p, cross_block(p, x, cfg, enc_kv), cfg), entry


def block_extend(p, x, kind: LayerKind, cfg: ModelConfig, entry, kv_pos,
                 positions):
    """Chunked-prefill block step over a dense cache entry (as
    `block_decode`).  The SSM arm scans the chunk with the SSD kernel,
    from the entry's state and conv tail.  Returns (hidden (B, Sc, D),
    the layer's new entry)."""
    entry, enc_kv = _split_enc(p, entry)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        attend = (mla_extend if cfg.attention == AttentionKind.MLA
                  else attn_extend)
        x = x + attend(p["attn"], h, cfg, entry[0], entry[1], kv_pos,
                       positions)
    else:
        y, entry = mamba_forward(h, p["mamba"], cfg.ssm, entry[0], entry[1])
        x = x + y
    return _mlp(p, cross_block(p, x, cfg, enc_kv), cfg), entry


def mixer_decode_paged(p, x, kind: LayerKind, cfg: ModelConfig, entry,
                       kv_pos_pool, block_tab, pos):
    """The mixer of `block_decode_paged`, without its residual: an
    attention layer's attention of its rows over their pages (`entry` =
    (k_pool, v_pool), written in place and handed back; on a
    tensor-parallel rank with split heads, its heads' share of the
    output projection), or an SSM layer's decode of its rows from their
    per-slot state (`entry` = (ssm_state, (conv_x, conv_bc)), one row a
    slot as in `block_decode`; the new state is returned, the one read
    left intact).  Returns (the mixer's output, the layer's entry)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        attend = (mla_decode_paged if cfg.attention == AttentionKind.MLA
                  else attn_decode_paged)
        return attend(p["attn"], h, cfg, entry[0], entry[1], kv_pos_pool,
                      block_tab, pos), entry
    return mamba_decode_step(h, p["mamba"], cfg.ssm, entry[0], entry[1])


def block_decode_paged(p, x, kind: LayerKind, cfg: ModelConfig, entry,
                       kv_pos_pool, block_tab, pos):
    """Single-token decode block over a paged cache: attention through
    the block table (an MLA layer's pools are its latent and rope-key
    pools), or an SSM layer's per-slot state, which the reference keeps
    beside the pages unpaged (see `mixer_decode_paged`); in a decoder
    layer of an encoder-decoder model `entry` is (that entry, (enc_k,
    enc_v)), the slot's encoder K/V beside the pages, only read by the
    cross-attention.  Returns (the new hidden states (B, 1, D), the
    layer's entry, without the encoder K/V)."""
    entry, enc_kv = _split_enc(p, entry)
    y, entry = mixer_decode_paged(p, x, kind, cfg, entry, kv_pos_pool,
                                  block_tab, pos)
    return _mlp(p, cross_block(p, x + y, cfg, enc_kv), cfg), entry


def attn_split(p, cfg: ModelConfig) -> bool:
    """Whether layer `p` holds a tensor-parallel rank's share of the
    attention heads, GQA (`w_q`) or MLA (`w_uq`): its output is a
    partial sum."""
    a = p.get("attn")
    if a is None:
        return False
    return (a["w_q"] if "w_q" in a else a["w_uq"]).shape[1] < cfg.num_heads


def row_split(p, cfg: ModelConfig, key: str = "attn") -> bool:
    """Whether layer `p`'s GQA attention (`key`: "attn", or "xattn" for
    cross-attention) holds a tensor-parallel rank's rows: the
    row-parallel form, its w_q/w_k/w_v over a slice of d_model and its
    w_o into one."""
    a = p.get(key)
    return a is not None and "w_q" in a and a["w_q"].shape[0] < cfg.d_model


def _rank_in(groups, n: int) -> List[int]:
    """Each of the `n` shards' model rank: its place in its group."""
    out = [0] * n
    for g in groups:
        for m, i in enumerate(g):
            out[i] = m
    return out


def row_proj(ps, hs, groups, names, key: str = "attn"):
    """The row-parallel projections `names` of a GQA attention (`key`) on
    the model ranks of each DP: each rank multiplies its slice of d_model
    of its normed input `hs` by its rows of each weight, the partials
    (joined along the last axis) are all-reduced once, and every rank
    splits the sum back.  Returns, for every shard, one tensor a name,
    (..., heads, hd)."""
    ranks = _rank_in(groups, len(ps))
    parts = []
    for p, h, m in zip(ps, hs, ranks):
        a = p[key]
        n = a["w_q"].shape[0]
        hm = h[..., m * n:(m + 1) * n]
        parts.append(torch.cat([hm @ a[w].reshape(n, -1) for w in names],
                               -1))
    out = []
    for p, t in zip(ps, all_reduce(parts, groups)):
        a, at, mine = p[key], 0, []
        for w in names:
            _n, heads, hd = a[w].shape
            mine.append(t[..., at:at + heads * hd].reshape(
                t.shape[:-1] + (heads, hd)))
            at += heads * hd
        out.append(mine)
    return out


def attn_shards(ps, xs, cfg: ModelConfig, attend, args, rope_pos, groups):
    """One attention sub-layer, without its residual, on every shard:
    `attend(p["attn"], h, cfg, *args[i])` (a decode or extend arm, paged
    or dense) with h the shard's normed hidden states.  Over M > 1 model
    ranks a DP (`groups`): a rank's heads give a partial output, which
    is all-reduced; in the row-parallel form (`row_split`) the ranks'
    partial q|k|v are all-reduced (`row_proj`), RoPE'd at `rope_pos`
    (each shard's positions, (B, S)), the attention runs whole on every
    rank over its whole pools (each writes the same K/V), and each
    rank's d_model slice of the output is all-gathered.  Returns each
    shard's output."""
    hs = [rms_norm(x, p["ln1"], cfg.norm_eps) for p, x in zip(ps, xs)]
    if len(groups[0]) > 1 and row_split(ps[0], cfg):
        qkvs = row_proj(ps, hs, groups, ("w_q", "w_k", "w_v"))
        ys = [attend(p["attn"], h, cfg, *a, qkv=(
                  apply_rope(q, pos, cfg.rope_theta),
                  apply_rope(k, pos, cfg.rope_theta), v))
              for p, h, a, (q, k, v), pos in zip(ps, hs, args, qkvs,
                                                 rope_pos)]
        return all_gather(ys, groups, dim=-1)
    ys = [attend(p["attn"], h, cfg, *a) for p, h, a in zip(ps, hs, args)]
    if len(groups[0]) > 1 and attn_split(ps[0], cfg):
        ys = all_reduce(ys, groups)
    return ys


def cross_shards(ps, xs, cfg: ModelConfig, enc_kvs, groups):
    """`cross_block` on every shard, its encoder K/V `enc_kvs[i]` (the
    slot's, its rank's heads where they split): over M > 1 model ranks
    a DP (`groups`) each rank attends with its heads over its heads of
    the encoder K/V (#2's contiguous entry, not causal) and the partial
    outputs are all-reduced; in the row-parallel form the queries are
    joined from the ranks' d_model slices (`row_proj`), the attention
    runs whole and the output's d_model slices are all-gathered."""
    M = len(groups[0])
    if "xattn" not in ps[0]:
        return xs
    if M == 1:
        return [cross_block(p, x, cfg, kv) for p, x, kv in zip(ps, xs,
                                                                enc_kvs)]
    hs = [rms_norm(x, p["ln_x"], cfg.norm_eps) for p, x in zip(ps, xs)]
    if row_split(ps[0], cfg, "xattn"):
        qs = row_proj(ps, hs, groups, ("w_q",), "xattn")
        ys = all_gather([cross_attn_full(p["xattn"], h, None, cfg,
                                         enc_kv=kv, q=q[0])[0]
                         for p, h, kv, q in zip(ps, hs, enc_kvs, qs)],
                        groups, dim=-1)
    else:
        ys = all_reduce([cross_attn_full(p["xattn"], h, None, cfg,
                                         enc_kv=kv)[0]
                         for p, h, kv in zip(ps, hs, enc_kvs)], groups)
    return [x + y for x, y in zip(xs, ys)]


def ssm_split(p, cfg: ModelConfig) -> bool:
    """Whether layer `p` holds a tensor-parallel rank's share of an SSM
    mixer's heads (`w_dt`'s columns)."""
    return "mamba" in p and p["mamba"]["w_dt"].shape[1] < ssm_dims(
        cfg.d_model, cfg.ssm)[1]


def ssm_shards(ps, xs, cfg: ModelConfig, entries, groups,
               gated=mamba_decode_gated):
    """An SSM layer's mixer, without its residual, on the model ranks of
    each DP unit (`ps`, `xs`, `entries`: each shard's params of the
    layer, hidden states and (ssm_state, (conv_x, conv_bc)) of its
    heads; `groups`: the shards of each DP).  Each rank runs its heads
    up to the gated norm (`gated`: `mamba_decode_gated` for a decode
    step, `mamba.mamba_forward_gated` for a chunk, #4 at the rank's
    heads); the norm reduces over the whole d_inner, so the ranks' fp32
    sums of squares are all-reduced (summed in rank order: every rank
    the same bits) before each normalises its share; then its rows of
    out_proj give a partial sum, all-reduced.  Returns (the mixer's
    output on every shard, each shard's new state)."""
    di = ssm_dims(cfg.d_model, cfg.ssm)[0]
    pre = [gated(rms_norm(x, p["ln1"], cfg.norm_eps), p["mamba"], cfg.ssm,
                 e[0], e[1])
           for p, x, e in zip(ps, xs, entries)]
    sums = all_reduce([y.float().square().sum(-1, keepdim=True)
                       for y, _s in pre], groups)
    ys = [rms_norm(y, p["mamba"]["norm"], var=ss / di) @
          p["mamba"]["out_proj"]
          for (y, _s), p, ss in zip(pre, ps, sums)]
    return all_reduce(ys, groups), [st for _y, st in pre]


def ffn_split(p, cfg: ModelConfig) -> bool:
    """Whether layer `p` holds a tensor-parallel rank's share of a dense
    FFN (its columns of w_gate/w_up, its rows of w_down)."""
    return "mlp" in p and p["mlp"]["w_gate"].shape[1] < cfg.d_ff


def shared_split(p, cfg: ModelConfig) -> bool:
    """Whether layer `p` holds a tensor-parallel rank's share of the MoE's
    shared experts (its columns of shared_gate/shared_up, its rows of
    shared_down): their output is a partial sum, outside `moe_block`."""
    m = p.get("moe")
    return (m is not None and "shared_gate" in m and m["shared_gate"].shape[1]
            < cfg.moe.num_shared * cfg.moe.d_shared)


def _routed(cfg: ModelConfig, split: bool):
    """The MoE config `moe_block` runs with: without its shared experts
    where the ranks hold them split (their partials join apart)."""
    return dataclasses.replace(cfg.moe, num_shared=0) if split else cfg.moe


def _shared_partials(ps, hs, groups):
    """Each rank's shared-experts SwiGLU over its columns, all-reduced."""
    return all_reduce([_shared(h, p["moe"]) for p, h in zip(ps, hs)],
                      groups)


def moe_lead_shards(ps, xs, cfg: ModelConfig, group):
    """An MoE FFN with its residual on the M model ranks of one DP (one
    `group`, each rank the same rows, as a prefill chunk): the routed
    experts once, over rank 0's rows, sent to the other ranks; split
    shared experts as each rank's partial, all-reduced, added to the
    routed output (the order `moe_block` adds them in)."""
    hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    split = shared_split(ps[0], cfg)
    o, _ = moe_block(hs[0], ps[0]["moe"], _routed(cfg, split))
    outs = broadcast(o, [x.device for x in xs])
    if split:
        outs = [a + b for a, b in zip(outs, _shared_partials(ps, hs,
                                                             group))]
    return [x + o for x, o in zip(xs, outs)]


def mlp_shards(ps, xs, cfg: ModelConfig, groups=None):
    """The FFN half of one layer over the rows of every shard of the
    sharded plane (`ps`, `xs`: each shard's params of the layer and its
    hidden states, on its device; `groups`: the shards of each DP unit,
    its tensor-parallel ranks, default one a DP).  An MoE FFN takes
    every shard's tokens in one `moe_block` call (the EP all-to-all
    under a mesh context); under TP each rank of a DP routes its share
    of the DP's rows, as the reference's EP body splits the replicated
    block, and the ranks gather the DP's outputs (where the rows do not
    split over the ranks, rank 0's rows take the single-program path and
    its outputs are sent to the others); split shared experts add each
    rank's partial over all the DP's rows, all-reduced.  A dense FFN
    runs on each shard alone, or under TP as each rank's partial sum,
    all-reduced."""
    M = 1 if groups is None else len(groups[0])
    if "moe" not in ps[0]:
        if M == 1 or not ffn_split(ps[0], cfg):
            return [_mlp(p, x, cfg) for p, x in zip(ps, xs)]
        parts = []
        for p, x in zip(ps, xs):
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            m = p["mlp"]
            parts.append(swiglu(h, m["w_gate"], m["w_up"], m["w_down"]))
        return [x + y for x, y in zip(xs, all_reduce(parts, groups))]
    hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    if M == 1:
        outs, _ = moe_block(hs, ps[0]["moe"], cfg.moe)
        return [x + o for x, o in zip(xs, outs)]
    split = shared_split(ps[0], cfg)
    mc = _routed(cfg, split)
    S = hs[0].shape[0]
    if S % M == 0:
        n = S // M
        outs, _ = moe_block([h[(i % M) * n:(i % M + 1) * n]
                             for i, h in enumerate(hs)], ps[0]["moe"], mc)
        outs = all_gather(outs, groups, dim=0)
    else:
        lead, _ = moe_block([hs[g[0]] for g in groups], ps[0]["moe"], mc)
        outs = list(hs)
        for o, g in zip(lead, groups):
            for i, t in zip(g, broadcast(o, [xs[i].device for i in g])):
                outs[i] = t
    if split:
        outs = [a + b for a, b in zip(outs, _shared_partials(ps, hs,
                                                             groups))]
    return [x + o for x, o in zip(xs, outs)]


def block_extend_paged(p, x, cfg: ModelConfig, k_pool, v_pool, kv_pos_pool,
                       block_tab, positions):
    """Chunked-prefill block step writing into paged pools (in place).
    Returns the new hidden states (B, Sc, D)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attend = (mla_extend_paged if cfg.attention == AttentionKind.MLA
              else attn_extend_paged)
    x = x + attend(p["attn"], h, cfg, k_pool, v_pool, kv_pos_pool,
                   block_tab, positions)
    return _mlp(p, x, cfg)
