"""Model assembly for the serving path (dense GQA decoders, Mamba2 SSM
stacks and hybrids of the two).

Counterpart of `repro/models/model.py`: `layer_layout`, `init_params`,
`logits_from_hidden`; the dense (padded) family `kv_buffer_len`,
`init_cache`, `cache_join`, `cache_take`, `prefill_chunk`,
`decode_step`; and the paged family `paged_layout`, `init_paged_cache`,
`paged_cache_join/take/clear_slot`, `paged_decode_step`,
`paged_prefill_step`, `mixed_step`, `paged_copy_block`,
`paged_gather_blocks`, `paged_adopt_blocks`, `paged_clear_rows`
(attention-only).  The JAX package scans over a stacked layer axis; here
the layers are a Python list and the step functions loop over them.

Layouts (torch):
    params  {"embed" (V, D), "ln_f" (D,), "lm_head" (D, V) unless tied,
             "layers": [{"ln1", "attn": {w_q, w_k, w_v, w_o} or "mamba":
                         {...}, "ln2", "mlp": {w_gate, w_up, w_down}
                         (an SSM layer has them only if d_ff > 0)}, ...]}
    paged   {"cur" (slots,) int32, "kv_pos" (N, bs) int32,
    cache    "block_tab" (slots, nbt) int32, "k"/"v" (L, N, bs, K, hd)}
    dense   {"cur" (B,) int32, "kv_pos" (B, S) int32,
    cache    "k"/"v" (L_attn, B, S, K, hd)       if any attention layer,
             "ssm" (L_ssm, B, nh, hp, ds) fp32,
             "conv_x" (L_ssm, B, d_conv-1, d_inner),
             "conv_bc" (L_ssm, B, d_conv-1, 2·ds)  if any SSM layer}
            S = kv_buffer_len(cfg, max_len) (a ring of min(window,
            max_len) entries for SWA models; 1 when no layer attends).
            Each stack holds its own kind's layers in model order;
            `stack_index` maps a layer to its stack.  A prefill request's
            cache and what `paged_cache_take` / `cache_take` return are
            its batch-1 form.

Physical block 0 is the null block: -1 table entries route writes there
and the attention masks it.  The K/V pools, the dense K/V rows and the
kv_pos maps are written IN PLACE by every function that writes KV (the
JAX functions return new arrays; at full width a cache copy per step
would double the KV memory), and by the joins.  `cur` and `block_tab`
are replaced, never mutated, so a cache dict handed out earlier keeps
its cursors; the steps replace the SSM and conv states too, never
writing the ones they read: a step drained while in flight must leave
its pre-step snapshot intact, and an SSM update, unlike a K/V write,
cannot be replayed harmlessly.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig
from repro_torch.models.blocks import (
    block_decode, block_decode_paged, block_extend, block_extend_paged,
    init_block_params,
)
from repro_torch.models.layers import rms_norm
from repro_torch.models.mamba import ssm_dims


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def layer_layout(cfg: ModelConfig) -> Tuple[int, Tuple[LayerKind, ...], int]:
    """(prefix_count, pattern, reps). Validates divisibility."""
    P = cfg.dense_prefix
    pattern = cfg.layer_pattern
    rest = cfg.num_layers - P
    if rest % len(pattern) != 0:
        raise ValueError(
            f"{cfg.name}: {rest} non-prefix layers not divisible by "
            f"pattern of length {len(pattern)}")
    return P, pattern, rest // len(pattern)


def require_supported(cfg: ModelConfig) -> None:
    """The port covers decoder-only models of dense GQA and SSM layers
    so far."""
    layer_layout(cfg)
    if cfg.is_encoder_decoder or cfg.num_patch_tokens:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision prefill are not "
            f"ported yet (ROADMAP Queue 1 item 13)")
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported yet (ROADMAP Queue 1 item 10)")
    if any(k not in (LayerKind.DENSE, LayerKind.SSM)
           for k in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1 "
            f"item 9)")


def _has_attn_cache(cfg: ModelConfig) -> bool:
    return any(k == LayerKind.DENSE for k in cfg.layer_kinds())


def stack_index(cfg: ModelConfig) -> List[Tuple[LayerKind, int]]:
    """(kind, index within its kind's cache stack) of every layer, in
    model order: attention layers index "k"/"v", SSM layers "ssm" and the
    conv tails."""
    seen = {LayerKind.DENSE: 0, LayerKind.SSM: 0}
    out = []
    for kind in cfg.layer_kinds():
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict:
    """Random weights with the JAX init's shapes and scales, drawn from a
    `torch.Generator` seeded with `seed` on `device` (the values differ
    from JAX's PRNG; tests bridge the JAX weights instead)."""
    require_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    params: Dict = {
        "embed": normal((V, D), 0.02),
        "ln_f": torch.ones(D, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D))
    params["layers"] = [init_block_params(gen, cfg, kind, dtype)
                        for kind in cfg.layer_kinds()]
    return params


def logits_from_hidden(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# Dense (padded) cache
# ---------------------------------------------------------------------------

def kv_buffer_len(cfg: ModelConfig, max_len: int) -> int:
    """Entries of a dense KV row: a ring of the window for SWA models."""
    if cfg.attention == AttentionKind.SWA and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Dict:
    """Dense decode cache of `batch` rows (a prefill request's cache is
    its batch-1 form): K/V rows for the attention layers, fp32 SSM states
    and conv tails (in `dtype`) for the SSM layers."""
    require_supported(cfg)
    S = kv_buffer_len(cfg, max_len) if _has_attn_cache(cfg) else 1
    kinds = cfg.layer_kinds()
    n_attn = sum(k == LayerKind.DENSE for k in kinds)
    n_ssm = len(kinds) - n_attn
    cache = {
        "cur": torch.zeros(batch, dtype=torch.int32, device=device),
        "kv_pos": torch.full((batch, S), -1, dtype=torch.int32,
                             device=device),
    }
    if n_attn:
        shape = (n_attn, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if n_ssm:
        sc = cfg.ssm
        di, nh, _ = ssm_dims(cfg.d_model, sc)
        tail = (n_ssm, batch, sc.d_conv - 1)
        cache["ssm"] = torch.zeros((n_ssm, batch, nh, sc.head_dim,
                                    sc.d_state), dtype=torch.float32,
                                   device=device)
        cache["conv_x"] = torch.zeros(tail + (di,), dtype=dtype,
                                      device=device)
        cache["conv_bc"] = torch.zeros(
            tail + (2 * sc.n_groups * sc.d_state,), dtype=dtype,
            device=device)
    return cache


_ROW_STACKS = ("k", "v", "ssm", "conv_x", "conv_bc")   # (L, B, ...) entries


def cache_join(dst: Dict, src: Dict, slot: int) -> Dict:
    """Install the batch-1 cache `src` (a finished prefill, or a parked
    row) into row `slot` of the dense batch cache `dst`: the row of every
    layer's K/V or SSM and conv state, and of kv_pos, is copied in place
    (between steps: no step is in flight), and the row's cursor set."""
    if dst["kv_pos"].shape[1] != src["kv_pos"].shape[1]:
        raise ValueError(
            f"cache_join: max_len mismatch (dst S_buf="
            f"{dst['kv_pos'].shape[1]}, src S_buf={src['kv_pos'].shape[1]})")
    for name in _ROW_STACKS:
        if name in dst:
            dst[name][:, slot] = src[name][:, 0].to(dst[name].dtype)
    dst["kv_pos"][slot] = src["kv_pos"][0]
    out = dict(dst)
    out["cur"] = _with(dst, "cur", slot, src["cur"][0])
    return out


def cache_take(src: Dict, slot: int) -> Dict:
    """Row `slot` of a dense batch cache as a new batch-1 cache (the
    inverse of cache_join: preemption and drain park it)."""
    out: Dict = {"cur": src["cur"][slot:slot + 1].clone(),
                 "kv_pos": src["kv_pos"][slot:slot + 1].clone()}
    for name in _ROW_STACKS:
        if name in src:
            out[name] = src[name][:, slot:slot + 1].clone()
    return out


# ---------------------------------------------------------------------------
# Paged (block-table) cache
# ---------------------------------------------------------------------------

def paged_layout(cfg: ModelConfig, max_len: int, block_size: int
                 ) -> Tuple[int, int]:
    """(nbt, block_size) table geometry for a paged cache equivalent to a
    dense max_len cache.  Validates the config supports paging."""
    require_supported(cfg)
    if not _has_attn_cache(cfg):
        raise ValueError(f"{cfg.name}: no attention cache to page")
    if LayerKind.SSM in cfg.layer_kinds():
        raise NotImplementedError(
            f"{cfg.name}: per-slot SSM state beside paged K/V is not "
            f"ported yet (ROADMAP Queue 1 item 12)")
    if cfg.attention == AttentionKind.SWA and cfg.sliding_window:
        raise ValueError(
            f"{cfg.name}: SWA ring caches are already bounded — use the "
            f"padded cache")
    if block_size < 1 or max_len % block_size != 0:
        raise ValueError(
            f"max_len={max_len} must be a positive multiple of "
            f"block_size={block_size}")
    return max_len // block_size, block_size


def init_paged_cache(cfg: ModelConfig, slots: int, num_blocks: int,
                     max_len: int, block_size: int, dtype=torch.float32,
                     device="cuda") -> Dict:
    """Paged decode cache for one DP unit: `slots` batch rows sharing
    `num_blocks` physical blocks (block 0 reserved as the null block)."""
    nbt, _ = paged_layout(cfg, max_len, block_size)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "cur": torch.zeros(slots, **i32),
        "kv_pos": torch.full((num_blocks, block_size), -1, **i32),
        "block_tab": torch.full((slots, nbt), -1, **i32),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _with(cache: Dict, key: str, idx, value) -> torch.Tensor:
    """A copy of cache[key] with cache[key][idx] = value."""
    t = cache[key].clone()
    t[idx] = value
    return t


def paged_cache_join(cfg: ModelConfig, dst: Dict, src: Dict, slot,
                     tab_row) -> Dict:
    """Install the dense batch-1 cache `src` into slot `slot` of `dst`:
    its KV tokens are written (in place) into the physical blocks named
    by `tab_row` ((nbt,) int32, -1 padding routes to the null block), and
    the slot's table row and token count are set."""
    nbt = dst["block_tab"].shape[1]
    bs = dst["kv_pos"].shape[1]
    if src["kv_pos"].shape[1] != nbt * bs:
        raise ValueError(
            f"paged_cache_join: src max_len {src['kv_pos'].shape[1]} != "
            f"table capacity {nbt * bs}")
    ids = tab_row.clamp_min(0).long()
    for name in ("k", "v"):
        pool = dst[name]
        new = src[name][:, 0].reshape((pool.shape[0], nbt, bs)
                                      + tuple(pool.shape[3:]))
        pool[:, ids] = new.to(pool.dtype)
    dst["kv_pos"][ids] = src["kv_pos"][0].reshape(nbt, bs)
    out = dict(dst)
    out["cur"] = _with(dst, "cur", slot, src["cur"][0])
    out["block_tab"] = _with(dst, "block_tab", slot, tab_row)
    return out


def paged_cache_take(cfg: ModelConfig, src: Dict, slot: int) -> Dict:
    """Extract slot `slot` of a paged cache as a dense batch-1 cache (the
    inverse of paged_cache_join: preemption and drain park it)."""
    tab_row = src["block_tab"][slot]
    nbt = tab_row.shape[0]
    bs = src["kv_pos"].shape[1]
    ids = tab_row.clamp_min(0).long()
    out: Dict = {"cur": src["cur"][slot:slot + 1].clone()}
    kv_pos = torch.where(tab_row[:, None] < 0, -1, src["kv_pos"][ids])
    out["kv_pos"] = kv_pos.reshape(1, nbt * bs)
    for name in ("k", "v"):
        pool = src[name]
        g = pool[:, ids]                                   # (L, nbt, bs, ...)
        out[name] = g.reshape((pool.shape[0], 1, nbt * bs)
                              + tuple(pool.shape[3:]))
    return out


def paged_cache_clear_slot(cache: Dict, slot) -> Dict:
    """Leave-on-finish: drop slot `slot`'s table row so its future
    (garbage) writes route to the null block."""
    out = dict(cache)
    out["block_tab"] = _with(cache, "block_tab", slot, -1)
    return out


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _dense_layers(cfg: ModelConfig, params, x, cache, block, where):
    """Run every layer of a dense-cache step: `block` is block_extend or
    block_decode, `where` the positions (B, Sc) or cursors (B,).  K/V are
    written in place; the new SSM and conv states are stacked into new
    tensors.  Returns (hidden, the cache's new entries)."""
    ssm: List = []
    conv_x: List = []
    conv_bc: List = []
    for p, (kind, i) in zip(params["layers"], stack_index(cfg)):
        if kind == LayerKind.DENSE:
            entry = (cache["k"][i], cache["v"][i])
        else:
            entry = (cache["ssm"][i],
                     (cache["conv_x"][i], cache["conv_bc"][i]))
        x, entry = block(p, x, kind, cfg, entry, cache["kv_pos"], where)
        if kind == LayerKind.SSM:
            ssm.append(entry[0])
            conv_x.append(entry[1][0])
            conv_bc.append(entry[1][1])
    new: Dict = {}
    if ssm:
        new = {"ssm": torch.stack(ssm), "conv_x": torch.stack(conv_x),
               "conv_bc": torch.stack(conv_bc)}
    return x, new


def prefill_chunk(cfg: ModelConfig, params, tokens, cache):
    """Extend a dense cache by one chunk of prompt tokens (B, Sc): true
    chunked prefill with KV and SSM state continuation.  Returns
    (last-position logits (B, V), cache with `cur` + Sc and the new SSM
    states); the K/V rows are written in place."""
    Sc = tokens.shape[1]
    pos0 = cache["cur"]
    positions = pos0[:, None] + torch.arange(Sc, dtype=torch.int32,
                                             device=pos0.device)[None]
    x = params["embed"][tokens.long()]                    # (B, Sc, D)
    x, new = _dense_layers(cfg, params, x, cache, block_extend, positions)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, -1])
    out = dict(cache, **new)
    out["cur"] = pos0 + Sc
    return logits, out


def decode_step(cfg: ModelConfig, params, token, cache):
    """One decode step over a dense cache.  token (B, 1) int; returns
    (logits (B, V), cache with `cur` + 1 and the new SSM states).  Every
    row steps, idle rows on garbage (rows never interact); the K/V rows
    are written in place."""
    pos = cache["cur"]
    x = params["embed"][token.long()]                    # (B, 1, D)
    x, new = _dense_layers(cfg, params, x, cache, block_decode, pos)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, 0])
    out = dict(cache, **new)
    out["cur"] = pos + 1
    return logits, out


def paged_decode_step(cfg: ModelConfig, params, token, cache):
    """One decode step over a paged cache.  token (slots, 1) int; returns
    (logits (slots, V), cache with `cur` + 1).  The pools are written in
    place."""
    pos = cache["cur"]
    tab = cache["block_tab"]
    x = params["embed"][token.long()]                    # (slots, 1, D)
    for l, p in enumerate(params["layers"]):
        x = block_decode_paged(p, x, cfg, cache["k"][l], cache["v"][l],
                               cache["kv_pos"], tab, pos)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, 0])
    out = dict(cache)
    out["cur"] = pos + 1
    return logits, out


def paged_prefill_step(cfg: ModelConfig, params, tokens, cache, slot):
    """One chunked-prefill step writing straight into pool pages: extend
    slot `slot` by the chunk `tokens` ((1, Sc) int).  Earlier chunks and
    shared-prefix pages are read through the block table.  Returns
    (last-position logits (1, V), cache); the pools are written in
    place."""
    Sc = tokens.shape[1]
    pos0 = cache["cur"][slot]
    positions = (pos0 + torch.arange(Sc, dtype=torch.int32,
                                     device=pos0.device))[None]
    tab_row = cache["block_tab"][slot][None]              # (1, nbt)
    x = params["embed"][tokens.long()]                    # (1, Sc, D)
    for l, p in enumerate(params["layers"]):
        x = block_extend_paged(p, x, cfg, cache["k"][l], cache["v"][l],
                               cache["kv_pos"], tab_row, positions)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, -1])
    out = dict(cache)
    out["cur"] = _with(cache, "cur", slot, pos0 + Sc)
    return logits, out


def mixed_step(cfg: ModelConfig, params, token, cache,
               chunks: Sequence, decode_mask=None):
    """One unified mixed-batch step: the paged decode rows, then each
    `(tokens (1, Sc), slot)` prefill chunk in order, over one pool.

    `decode_mask` (slots,) bool marks the actively decoding slots;
    masked rows (prefilling residents, whose table rows are live) decode
    against a -1 table (the null block) and keep `cur`.  Returns (decode
    logits (slots, V), tuple of per-chunk last-position logits (1, V),
    cache)."""
    tab = cache["block_tab"]
    cur = cache["cur"]
    if decode_mask is not None:
        dcache = dict(cache)
        dcache["block_tab"] = torch.where(decode_mask[:, None], tab, -1)
        logits, cache = paged_decode_step(cfg, params, token, dcache)
        cache["block_tab"] = tab
        cache["cur"] = torch.where(decode_mask, cur + 1, cur)
    else:
        logits, cache = paged_decode_step(cfg, params, token, cache)
    chunk_logits = []
    for ctoks, slot in chunks:
        lg, cache = paged_prefill_step(cfg, params, ctoks, cache, slot)
        chunk_logits.append(lg)
    return logits, tuple(chunk_logits), cache


# ---------------------------------------------------------------------------
# Page surgery
# ---------------------------------------------------------------------------

def paged_copy_block(cfg: ModelConfig, cache: Dict, src, dst) -> Dict:
    """Copy physical block `src` -> `dst` across every pool and the
    position map, in place (the copy half of copy-on-write)."""
    cache["kv_pos"][dst] = cache["kv_pos"][src]
    for name in ("k", "v"):
        cache[name][:, dst] = cache[name][:, src]
    return dict(cache)


def paged_gather_blocks(cfg: ModelConfig, cache: Dict, ids) -> Dict:
    """Block-granular handoff payload: the physical rows named by `ids`
    ((nbt,) int32, -1 padding) of every pool, plus their kv_pos rows
    (-1 on padding).  New tensors."""
    g = ids.clamp_min(0).long()
    out: Dict = {"kv_pos": torch.where(ids[:, None] < 0, -1,
                                       cache["kv_pos"][g])}
    for name in ("k", "v"):
        out[name] = cache[name][:, g]                    # (L, nbt, bs, ...)
    return out


def paged_adopt_blocks(cfg: ModelConfig, dst: Dict, payload: Dict, slot,
                       tab_row, copy_mask, clear_mask, cur) -> Dict:
    """Install a `paged_gather_blocks` payload into `dst`, in place:
    payload block i goes to physical block `tab_row[i]` where
    `copy_mask[i]`; rows under `clear_mask` (fresh growth blocks) get
    their kv_pos reset; rows under neither (shared prefix pages already
    resident) are not touched.  Masked-out traffic routes to the null
    block."""
    phys = tab_row.clamp_min(0)
    ids_clear = torch.where(clear_mask, phys, 0).long()
    ids_copy = torch.where(copy_mask, phys, 0).long()
    dst["kv_pos"][ids_clear] = -1
    dst["kv_pos"][ids_copy] = payload["kv_pos"]
    for name in ("k", "v"):
        dst[name][:, ids_copy] = payload[name].to(dst[name].dtype)
    out = dict(dst)
    out["cur"] = _with(dst, "cur", slot, cur)
    out["block_tab"] = _with(dst, "block_tab", slot, tab_row)
    return out


def paged_clear_rows(cache: Dict, ids) -> Dict:
    """Reset kv_pos (in place) for the pool rows named by `ids` ((m,)
    int32; -1 padding routes to the null block).  Freshly allocated
    blocks must be cleared before a slot attends through them: stale
    positions from a previous tenant would alias as valid history."""
    cache["kv_pos"][ids.clamp_min(0).long()] = -1
    return dict(cache)
