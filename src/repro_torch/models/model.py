"""Model assembly for the serving path: decoders of GQA or MLA attention
with dense or MoE FFNs (a `dense_prefix` of dense layers first, as in
DeepSeek-V3), Mamba2 SSM stacks and hybrids of the two, a decoder with
patch embeddings prepended (the VLM, internvl2-1b) and an
encoder-decoder (whisper-large-v3: a bidirectional encoder over frame
embeddings, cross-attention in every decoder layer).

Counterpart of `repro/models/model.py`: `layer_layout`, `init_params`
(with DeepSeek-V3's multi-token-prediction head, "mtp"),
`abstract_params` and `abstract_cache` (on the `meta` device),
`logits_from_hidden`; the training `forward_train` (under `remat`,
`_ckpt`), `_ce_loss` and `loss_fn`; the full-sequence `_run_encoder`,
`forward_full` and `prefill` (the whole prompt in one forward, then
the dense decode cache built from it: a SWA ring placed as the
reference's, SSM states and conv tails, the encoder K/V of every
decoder layer); the dense
(padded) family `kv_buffer_len`, `init_cache`, `cache_join`,
`cache_take`, `prefill_chunk`, `decode_step` (with the port's
`cache_row` and `cache_clear_row`, for the rows of a prefill engine's
dense pool), which continue from `prefill`'s cache; and the paged
family `paged_layout`, `init_paged_cache`,
`paged_cache_join/take/clear_slot`, `paged_decode_step` (a hybrid's SSM
layers keep their state per slot beside the pages, and an
encoder-decoder's decoder layers their slot's encoder K/V, as the
reference's `_paged_entry_struct`), `paged_prefill_step` (with
`_require_pageable_prefill`), `mixed_step` (its decode half is
`paged_decode_masked`), `paged_copy_block`, `paged_gather_blocks`,
`paged_adopt_blocks`, `paged_clear_rows` (attention-only, as the
reference's).  The JAX package scans over a
stacked layer axis; here the layers are a Python list and the step
functions loop over them.

The sharded plane's forms of the paged family (the reference gets them
from GSPMD over a data-sharded cache) take the MERGED cache of
`repro_torch.distributed.sharding` ({"shards": one paged cache per
(data, model) rank, "slots": S, "blocks": B, "model": M}, global slot
and block ids; a DP unit's view adds "home": its data rank) and
dispatch at their top: the decode step runs each layer's mixer on each
shard's device over its rows (attention over its pages, a hybrid's SSM
layer from its slots' states), then the layer's FFN over every shard's
tokens at once (an MoE's EP all-to-all under the spec's mesh context),
so one step advances every DP's rows; a prefill chunk and the page
surgery run on the shards of the DP that owns the slot.  Under tensor
parallelism (M > 1 model ranks a DP, `distributed.sharding`) each rank
runs its share of a layer: its heads of the attention over its heads of
the pools (MLA: over the whole latent pools; the row-parallel form: its
d_model rows of the projections, the attention whole over whole pools),
its heads of a decoder layer's cross-attention over its heads of the
slot's encoder K/V, its heads of an SSM mixer over its heads of the
slots' states, and its columns of a dense FFN and of the shared
experts, each a partial sum that `distributed.transfer.all_reduce`
joins over the DP's ranks (an SSM layer's gated norm all-reduces its
sums of squares first); its share of an MoE's rows through the EP
layer, gathered after; the embedding and logits over its slice of the
vocabulary or of d_model.  Every rank of a DP then holds the same
hidden states, bit for bit.  A dense `prefill_chunk` takes the same
form on a DP's ranks (`_tp_prefill_chunk`) over a dense cache split
over them (`split_dense_cache`: {"shards": one dense cache a rank, its
share of the KV heads and SSM heads, "model": M}); its MoE runs once
from rank 0's rows and reaches the split expert weights
(`repro_torch.models.moe`).

Layouts (torch):
    params  {"embed" (V, D), "ln_f" (D,), "lm_head" (D, V) unless tied,
             "layers": [{"ln1", "attn": {w_q, w_k, w_v, w_o} (GQA) or
                         {[w_dq, q_norm,] w_uq, w_dkv, kv_norm, w_kr, w_uk,
                         w_uv, w_o} (MLA), or "mamba": {...},
                         ["ln_x", "xattn": {w_q, w_k, w_v, w_o}] (a
                         decoder layer of an encoder-decoder model),
                         "ln2", "mlp": {w_gate, w_up, w_down} (an SSM
                         layer has them only if d_ff > 0) or "moe":
                         {router [, router_bias], w_gate, w_up, w_down
                         (expert axis first) [, shared_gate, shared_up,
                         shared_down]}}, ...],
             "encoder": [dense layer dicts], "enc_ln_f" (D,)
                                                 if encoder-decoder,
             "mtp": {"ln_h", "ln_e" (D,), "proj" (2D, D), "block": a
                     layer dict of the pattern's first kind}
                                                 if cfg.mtp_depth > 0}
    paged   {"cur" (slots,) int32, "kv_pos" (N, bs) int32,
    cache    "block_tab" (slots, nbt) int32,
             "k"/"v" (L_attn, N, bs, K, hd),
             "ssm"/"conv_x"/"conv_bc" (L_ssm, slots, ...) as in the dense
             cache, one row a slot               if any SSM layer,
             "enc_k"/"enc_v" (L, slots, Se, K, hd) as in the dense
             cache, one row a slot               if encoder-decoder}
    dense   {"cur" (B,) int32, "kv_pos" (B, S) int32,
    cache    "k"/"v" (L_attn, B, S, K, hd)       if any attention layer,
             "ssm" (L_ssm, B, nh, hp, ds) fp32,
             "conv_x" (L_ssm, B, d_conv-1, d_inner),
             "conv_bc" (L_ssm, B, d_conv-1, 2·ds)  if any SSM layer,
             "enc_k"/"enc_v" (L, B, Se, K, hd)   if encoder-decoder:
             every decoder layer's cross-attention K/V over the
             encoder's Se = encoder_seq_len outputs, written by
             `prefill` and only read after}
            S = kv_buffer_len(cfg, max_len) (a ring of min(window,
            max_len) entries for SWA models; 1 when no layer attends).
            Each stack holds its own kind's layers in model order
            (attention: DENSE and MOE layers; SSM: SSM and SSM_MOE);
            `stack_index` maps a layer to its stack.
            A prefill request's cache and what `paged_cache_take` /
            `cache_take` return are its batch-1 form.
    MLA     "k" holds the normalised KV latent and "v" the shared rope
            key, with no head axis: (…, kv_lora_rank) and
            (…, qk_rope_head_dim) in place of (…, K, hd), as the
            reference's kv[0]/kv[1].  The page surgery and the joins
            index only the leading axes, so they serve both.

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
from repro_torch.distributed.sharding import (
    ENC_STACKS, SLOT_STACKS, SSM_STACKS, cache_model, cache_tp_axis,
    dp_groups, is_merged, params_on, rank_params, rank_share,
)
from repro_torch.distributed.transfer import (
    all_gather, all_reduce, gather_to, move, reduce_to,
)
from repro_torch.models.blocks import (
    ATTN_KINDS, attn_decode_paged, attn_extend, attn_extend_paged,
    attn_shards, block_decode, block_decode_paged, block_extend,
    block_extend_paged, block_full, cross_shards, init_block_params,
    mixer_decode_paged, mla_decode_paged, mla_extend,
    mla_extend_paged, mlp_shards, moe_lead_shards, ssm_shards, ssm_split,
)
from repro_torch.models.layers import rms_norm, sinusoid_pos_embedding
from repro_torch.models.mamba import mamba_forward_gated, ssm_dims


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
    """The model-level functions take every registered architecture:
    decoders of GQA or MLA attention, dense or MoE FFNs and SSM layers,
    the VLM and the encoder-decoder.  Validates the layer layout."""
    layer_layout(cfg)


def require_servable(cfg: ModelConfig) -> None:
    """The serving engines take decoder-only models without patch
    embeddings, as the reference's serve them: their requests carry
    token ids only, and nothing hands frame or patch embeddings to the
    prefill, so an encoder-decoder model would run cross-attention over
    zero encoder K/V and a VLM would serve text without its image.
    Those models run through `prefill`, `prefill_chunk` and
    `decode_step`."""
    require_supported(cfg)
    if cfg.is_encoder_decoder or cfg.num_patch_tokens:
        kind = ("an encoder-decoder model" if cfg.is_encoder_decoder
                else "a model with patch embeddings")
        raise NotImplementedError(
            f"{cfg.name}: the serving engines do not serve {kind}: their "
            f"requests carry no frame or patch embeddings to the prefill "
            f"(nor do the reference's), so cross-attention would run over "
            f"zero encoder K/V and patch tokens would be missing; use "
            f"prefill / prefill_chunk / decode_step")


def _has_attn_cache(cfg: ModelConfig) -> bool:
    return any(k in ATTN_KINDS for k in cfg.layer_kinds())


def stack_index(cfg: ModelConfig) -> List[Tuple[LayerKind, int]]:
    """(kind, index within its kind's cache stack) of every layer, in
    model order: attention layers (DENSE, MOE) index "k"/"v", SSM layers
    (SSM, SSM_MOE) "ssm" and the conv tails."""
    seen = {True: 0, False: 0}
    out = []
    for kind in cfg.layer_kinds():
        attn = kind in ATTN_KINDS
        out.append((kind, seen[attn]))
        seen[attn] += 1
    return out


def _kv_shapes(cfg: ModelConfig, lead: Tuple[int, ...]):
    """Shapes of one attention layer stack's "k" and "v" entries after
    the leading axes `lead`: per-head K/V, or MLA's latent and rope
    key."""
    if cfg.attention == AttentionKind.MLA:
        m = cfg.mla
        return lead + (m.kv_lora_rank,), lead + (m.qk_rope_head_dim,)
    kv = lead + (cfg.num_kv_heads, cfg.resolved_head_dim)
    return kv, kv


def _tp_zeros(cfg: ModelConfig, name: str, shape, tp: int, **kw):
    """Zeros for cache entry `name` of `shape`, cut to one of `tp`
    tensor-parallel ranks' share where the ranks split it
    (`cache_tp_axis`)."""
    ax = cache_tp_axis(cfg, name, tp)
    if ax is not None:
        shape = list(shape)
        shape[ax] //= tp
    return torch.zeros(tuple(shape), **kw)


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
    cross = cfg.is_encoder_decoder
    # one dict a layer, in model order: the reference's `init_stacked`
    # (one stack a group of `layer_layout`, drawn by vmap) has no
    # counterpart here, as the port keeps a list of layers, not stacks
    params["layers"] = [init_block_params(gen, cfg, kind, dtype, cross=cross)
                        for kind in cfg.layer_kinds()]
    if cross:
        params["encoder"] = [
            init_block_params(gen, cfg, LayerKind.DENSE, dtype)
            for _ in range(cfg.num_encoder_layers)]
        params["enc_ln_f"] = torch.ones(D, dtype=dtype, device=device)
    if cfg.mtp_depth > 0:
        # DeepSeek-V3's multi-token-prediction head (read by the loss)
        params["mtp"] = {
            "ln_h": torch.ones(D, dtype=dtype, device=device),
            "ln_e": torch.ones(D, dtype=dtype, device=device),
            "proj": normal((2 * D, D), 1.0 / math.sqrt(2 * D)),
            "block": init_block_params(gen, cfg, cfg.layer_pattern[0],
                                       dtype),
        }
    return params


def _on_meta(tree):
    """`tree` with every tensor replaced by an empty one of its shape and
    dtype on the `meta` device."""
    if isinstance(tree, dict):
        return {k: _on_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_meta(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    """`init_params`' tree on the `meta` device (shapes and dtypes, no
    storage), for a config of any size: drawn under a fake-tensor mode,
    which allocates nothing, as the reference's `jax.eval_shape`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(cfg, dtype=dtype, device="cpu")
    return _on_meta(fake)


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
               dtype=torch.float32, device="cuda", tp: int = 1) -> Dict:
    """Dense decode cache of `batch` rows (a prefill request's cache is
    its batch-1 form): K/V rows for the attention layers, fp32 SSM states
    and conv tails (in `dtype`) for the SSM layers, and an
    encoder-decoder's encoder K/V for every decoder layer (zero until
    `prefill` writes them).  With `tp` > 1 it is one tensor-parallel
    rank's share (`split_dense_cache`)."""
    require_supported(cfg)
    S = kv_buffer_len(cfg, max_len) if _has_attn_cache(cfg) else 1
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_ssm = len(kinds) - n_attn
    cache = {
        "cur": torch.zeros(batch, dtype=torch.int32, device=device),
        "kv_pos": torch.full((batch, S), -1, dtype=torch.int32,
                             device=device),
    }
    if n_attn:
        k_shape, v_shape = _kv_shapes(cfg, (n_attn, batch, S))
        cache["k"] = _tp_zeros(cfg, "k", k_shape, tp, dtype=dtype,
                               device=device)
        cache["v"] = _tp_zeros(cfg, "v", v_shape, tp, dtype=dtype,
                               device=device)
    if n_ssm:
        cache.update(_ssm_stacks(cfg, n_ssm, batch, dtype, device, tp))
    cache.update(_enc_stacks(cfg, batch, dtype, device, tp))
    return cache


def _enc_stacks(cfg: ModelConfig, rows: int, dtype, device, tp: int = 1
                ) -> Dict:
    """Zero encoder K/V of every decoder layer for `rows` rows (an
    encoder-decoder's; {} otherwise); a tensor-parallel rank's heads of
    them with `tp` > 1."""
    if not cfg.is_encoder_decoder:
        return {}
    shape = (len(cfg.layer_kinds()), rows, cfg.encoder_seq_len,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {name: _tp_zeros(cfg, name, shape, tp, dtype=dtype,
                            device=device) for name in ENC_STACKS}


def split_dense_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      devices: Sequence) -> Dict:
    """A dense cache of `batch` rows split over the M = len(devices)
    model ranks of one DP: {"shards": rank m's share on devices[m]
    (`init_cache(tp=M)`: its KV heads, SSM heads and encoder heads where
    the ranks split them, the rest whole), "model": M}.  `prefill_chunk`
    runs on it over the ranks (`_tp_prefill_chunk`), and the joins into a
    merged paged cache take rank m's share to rank m."""
    M = len(devices)
    return {"shards": [init_cache(cfg, batch, max_len, dtype, device=d,
                                  tp=M) for d in devices],
            "model": M}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Dict:
    """`init_cache`'s tree on the `meta` device (no storage)."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def _ssm_stacks(cfg: ModelConfig, n_ssm: int, rows: int, dtype,
                device, tp: int = 1) -> Dict:
    """Zero SSM states (fp32) and conv tails (`dtype`) of `n_ssm` layers
    for `rows` rows (dense rows, or a paged cache's slots); a
    tensor-parallel rank's heads of them with `tp` > 1."""
    sc = cfg.ssm
    di, nh, _ = ssm_dims(cfg.d_model, sc)
    tail = (n_ssm, rows, sc.d_conv - 1)
    return {
        "ssm": _tp_zeros(cfg, "ssm", (n_ssm, rows, nh, sc.head_dim,
                                      sc.d_state), tp,
                         dtype=torch.float32, device=device),
        "conv_x": _tp_zeros(cfg, "conv_x", tail + (di,), tp, dtype=dtype,
                            device=device),
        "conv_bc": torch.zeros(tail + (2 * sc.n_groups * sc.d_state,),
                               dtype=dtype, device=device),
    }


_ROW_STACKS = ("k", "v") + SLOT_STACKS   # (L, B, ...) entries


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
    inverse of cache_join: preemption and drain park it); of a split
    cache (`split_dense_cache`), each rank's share of it on its device."""
    if is_merged(src):
        return dict(src, shards=[cache_take(c, slot) for c in src["shards"]])
    return {name: t.clone() for name, t in cache_row(src, slot).items()}


def cache_row(src: Dict, row: int) -> Dict:
    """Row `row` of a dense batch cache as a batch-1 cache of views: a
    step writes its K/V and kv_pos into the batch cache in place (a
    split cache: each rank's row)."""
    if is_merged(src):
        return dict(src, shards=[cache_row(c, row) for c in src["shards"]])
    out: Dict = {"cur": src["cur"][row:row + 1],
                 "kv_pos": src["kv_pos"][row:row + 1]}
    for name in _ROW_STACKS:
        if name in src:
            out[name] = src[name][:, row:row + 1]
    return out


def cache_clear_row(cache: Dict, row: int) -> Dict:
    """Reset row `row` of a dense batch cache in place to what
    `init_cache` makes for every step that reads it: kv_pos -1, cursor 0,
    SSM states, conv tails and encoder K/V 0 (its K/V entries are read
    only where kv_pos says they were written, so they are left).  The
    dense counterpart of `paged_cache_clear_slot`, for a reused row of a
    prefill engine's pool.  A split cache's ranks each reset theirs."""
    if is_merged(cache):
        for c in cache["shards"]:
            cache_clear_row(c, row)
        return cache
    cache["kv_pos"][row] = -1
    cache["cur"][row] = 0
    for name in SSM_STACKS + ENC_STACKS:
        if name in cache:
            cache[name][:, row] = 0
    return cache


# ---------------------------------------------------------------------------
# Paged (block-table) cache
# ---------------------------------------------------------------------------

def paged_layout(cfg: ModelConfig, max_len: int, block_size: int
                 ) -> Tuple[int, int]:
    """(nbt, block_size) table geometry for a paged cache equivalent to a
    dense max_len cache.  Validates the config supports paging: it needs
    an attention layer (a hybrid's SSM layers keep per-slot state beside
    the pages, an encoder-decoder's decoder layers their slot's encoder
    K/V) and no SWA ring."""
    require_supported(cfg)
    if not _has_attn_cache(cfg):
        raise ValueError(f"{cfg.name}: no attention cache to page")
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
                     device="cuda", tp: int = 1) -> Dict:
    """Paged decode cache for one DP unit: `slots` batch rows sharing
    `num_blocks` physical blocks (block 0 reserved as the null block):
    K/V pools over the attention layers, for a hybrid's SSM layers
    per-slot SSM states and conv tails, and for an encoder-decoder
    per-slot encoder K/V of every decoder layer (zero until a join
    writes them), laid out as `init_cache`'s.  With `tp` > 1 it is one
    tensor-parallel rank's shard: its share of what the ranks split
    (`distributed.sharding.cache_tp_axis`: KV heads, SSM heads)."""
    nbt, _ = paged_layout(cfg, max_len, block_size)
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    k_shape, v_shape = _kv_shapes(cfg, (n_attn, num_blocks, block_size))
    i32 = dict(dtype=torch.int32, device=device)
    cache = {
        "cur": torch.zeros(slots, **i32),
        "kv_pos": torch.full((num_blocks, block_size), -1, **i32),
        "block_tab": torch.full((slots, nbt), -1, **i32),
        "k": _tp_zeros(cfg, "k", k_shape, tp, dtype=dtype, device=device),
        "v": _tp_zeros(cfg, "v", v_shape, tp, dtype=dtype, device=device),
    }
    if len(kinds) > n_attn:
        cache.update(_ssm_stacks(cfg, len(kinds) - n_attn, slots, dtype,
                                 device, tp))
    cache.update(_enc_stacks(cfg, slots, dtype, device, tp))
    return cache


def _with(cache: Dict, key: str, idx, value) -> torch.Tensor:
    """A copy of cache[key] with cache[key][idx] = value."""
    t = cache[key].clone()
    t[idx] = value
    return t


def paged_cache_join(cfg: ModelConfig, dst: Dict, src: Dict, slot,
                     tab_row) -> Dict:
    """Install the dense batch-1 cache `src` into slot `slot` of `dst`:
    its KV tokens are written (in place) into the physical blocks named
    by `tab_row` ((nbt,) int32, -1 padding routes to the null block), its
    per-slot entries (a hybrid's SSM states and conv tails, an
    encoder-decoder's encoder K/V) into the slot's rows (in place, as
    `cache_join`: between steps), and the slot's table row and token
    count are set.  On a merged cache every model rank of the slot's DP
    takes its share of what the ranks split (KV heads, SSM heads)."""
    if is_merged(dst):
        d, s = _dp_slot(dst, slot)

        def one(m, c):
            dev = c["cur"].device
            return paged_cache_join(cfg, c, _rank_share(cfg, dst, src, m, dev),
                                    s, _local_blocks(dst, d, tab_row, dev))
        return _on_dp(dst, d, one)
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
    for name in SLOT_STACKS:
        if name in dst:
            dst[name][:, slot] = src[name][:, 0].to(dst[name].dtype)
    out = dict(dst)
    out["cur"] = _with(dst, "cur", slot, src["cur"][0])
    out["block_tab"] = _with(dst, "block_tab", slot, tab_row)
    return out


def paged_cache_take(cfg: ModelConfig, src: Dict, slot: int) -> Dict:
    """Extract slot `slot` of a paged cache as a dense batch-1 cache (the
    inverse of paged_cache_join: preemption and drain park it).  New
    tensors: the pages' K/V gathered, the per-slot entries cloned.  On a
    merged cache what the DP's model ranks split (KV heads, SSM heads) is
    joined on its rank 0's device."""
    if is_merged(src):
        d, s = _dp_slot(src, slot)
        M = cache_model(src)
        out = paged_cache_take(cfg, src["shards"][d * M], s)
        dev = out["cur"].device
        for name in list(out):
            ax = cache_tp_axis(cfg, name, M)
            if ax is None:
                continue
            rest = [paged_cache_take(cfg, src["shards"][d * M + m], s)[name]
                    for m in range(1, M)]
            out[name] = torch.cat([out[name]] + move(rest, [dev] * (M - 1)),
                                  ax)
        return out
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
    for name in SLOT_STACKS:
        if name in src:
            out[name] = src[name][:, slot:slot + 1].clone()
    return out


def paged_cache_clear_slot(cache: Dict, slot) -> Dict:
    """Leave-on-finish: drop slot `slot`'s table row so its future
    (garbage) writes route to the null block.  The per-slot entries (a
    hybrid's SSM state, an encoder-decoder's encoder K/V) are left as
    they are, as in the reference: the row steps on garbage until the
    next join overwrites them."""
    if is_merged(cache):
        d, s = _dp_slot(cache, slot)
        return _on_dp(cache, d, lambda m, c: paged_cache_clear_slot(c, s))
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
    tensors; a decoder layer's cross-attention reads its encoder K/V.
    Returns (hidden, the cache's new entries)."""
    states: List = []
    for l, (p, (kind, i)) in enumerate(zip(params["layers"],
                                           stack_index(cfg))):
        entry = _layer_entry(cache, kind, i)
        if "xattn" in p:
            entry = (entry, (cache["enc_k"][l], cache["enc_v"][l]))
        x, entry = block(p, x, kind, cfg, entry, cache["kv_pos"], where)
        if kind not in ATTN_KINDS:
            states.append(entry)
    return x, _stacked(states)


def _layer_entry(cache: Dict, kind: LayerKind, i: int):
    """Layer entry of stack index i: (k, v) of an attention layer (rows
    or pools), (ssm_state, (conv_x, conv_bc)) of an SSM layer."""
    if kind in ATTN_KINDS:
        return cache["k"][i], cache["v"][i]
    return cache["ssm"][i], (cache["conv_x"][i], cache["conv_bc"][i])


def _stacked(states: List) -> Dict:
    """The SSM layers' new (ssm_state, (conv_x, conv_bc)) entries, in
    model order, as new cache stacks ({} without SSM layers)."""
    if not states:
        return {}
    return {"ssm": torch.stack([s for s, _c in states]),
            "conv_x": torch.stack([c[0] for _s, c in states]),
            "conv_bc": torch.stack([c[1] for _s, c in states])}


def _keep_masked(new: Dict, old: Dict, mask) -> Dict:
    """`new`'s SSM stacks with the rows outside `mask` ((rows,) bool)
    taken from `old`: a row masked out of a step keeps its state, as it
    keeps `cur`.  (Attention needs no such care: its masked rows write
    into the null block.)"""
    out = dict(new)
    for name in SSM_STACKS:
        if name in new:
            m = mask.reshape((1, -1) + (1,) * (new[name].dim() - 2))
            out[name] = torch.where(m, new[name], old[name])
    return out


# ---------------------------------------------------------------------------
# Full-sequence forward and prefill
# ---------------------------------------------------------------------------

def _save_dots():
    """A selective-checkpoint context that keeps the outputs of the matrix
    products (`aten.mm`, `aten.bmm`) and recomputes the rest."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(
        [torch.ops.aten.mm.default, torch.ops.aten.bmm.default])


def _ckpt(fn, remat):
    """remat: False/"none" (no remat), True/"block" (recompute the whole
    block in the backward), "dots" (keep the matrix products' outputs and
    recompute only the elementwise chains), as the reference's `_ckpt`.
    Activation checkpointing by `torch.utils.checkpoint` (not
    reentrant)."""
    if not remat or remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint
    if remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_save_dots)
    if remat not in (True, "block"):
        raise ValueError(f"remat {remat!r}: False, 'none', True, 'block' "
                         f"or 'dots'")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _run_encoder(cfg: ModelConfig, params, frames, remat=False):
    """The whisper encoder: frame embeddings (B, F, D) plus the sinusoidal
    position embedding, then the dense encoder blocks, bidirectional and
    without RoPE (kernel #2, not causal), each under `remat`, then
    `enc_ln_f`."""
    B, F, D = frames.shape
    x = frames + sinusoid_pos_embedding(F, D, frames.device)[None].to(
        frames.dtype)
    pos = torch.arange(F, dtype=torch.int32, device=frames.device).expand(
        B, F)

    def layer(p, x):
        return block_full(p, x, LayerKind.DENSE, cfg, pos, causal=False,
                          use_rope=False)[0]
    for p in params["encoder"]:
        x = _ckpt(layer, remat)(p, x)
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def forward_full(cfg: ModelConfig, params, tokens, positions=None, seg=None,
                 embeds=None, want_cache: bool = False, remat=False):
    """The whole sequence through every layer: tokens (B, S) int, with a
    VLM's patch embeddings (B, P, D) prepended or an encoder-decoder's
    frame embeddings (B, F, D) encoded first (`embeds`).  `positions`
    (B, St) default to 0 .. St - 1 over the St tokens run (patches
    included); `seg` (B, S) packs several sequences in a row (-1 = pad),
    extended over a patch prefix with the first text token's segment.
    `remat` checkpoints each block and encoder layer (`_ckpt`; the
    training forward's option, not with `want_cache`).
    Returns (hidden (B, St, D) after `ln_f`, the layers' cache entries in
    the dense cache's stacks over St tokens when `want_cache` (else
    None), the MoE aux loss (fp32), the encoder's output (or None)).
    The reference's `_constrain` (sequence sharding under a mesh) is a
    no-op without a mesh and is left out."""
    B, S = tokens.shape
    if remat and want_cache:
        raise ValueError("remat recomputes the blocks' outputs in the "
                         "backward; it does not build a cache")
    x = params["embed"][tokens.long()]
    enc_out = None
    if cfg.is_encoder_decoder:
        if embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"frame embeddings")
        enc_out = _run_encoder(cfg, params, embeds.to(x.dtype), remat)
    elif cfg.num_patch_tokens and embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    St = x.shape[1]
    if positions is None:
        positions = torch.arange(St, dtype=torch.int32,
                                 device=x.device).expand(B, St)
    if seg is not None and St != S:
        # the patch prefix belongs to the segment of the first text token
        seg = torch.cat([seg[:, :1].expand(B, St - S), seg], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    entries = []
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        if remat:
            def layer(p, x, enc_out, kind=kind):
                y, _entry, a = block_full(p, x, kind, cfg, positions, seg,
                                          enc_out=enc_out)
                return y, a
            x, a = _ckpt(layer, remat)(p, x, enc_out)
        else:
            x, entry, a = block_full(p, x, kind, cfg, positions, seg,
                                     enc_out=enc_out)
            if want_cache:
                entries.append(entry)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, (_entry_stacks(cfg, entries) if want_cache else None), aux, \
        enc_out


def _entry_stacks(cfg: ModelConfig, entries: List) -> Dict:
    """`block_full`'s per-layer entries, in model order, as the dense
    cache's stacks: "k"/"v" over the attention layers (B, St, ...), the
    SSM layers' states and conv tails, and the encoder K/V of every
    decoder layer."""
    attn, ssm, enc = [], [], []
    for (kind, _i), e in zip(stack_index(cfg), entries):
        if cfg.is_encoder_decoder:
            e, kv = e
            enc.append(kv)
        (attn if kind in ATTN_KINDS else ssm).append(e)
    out = _stacked(ssm)
    for j, name in enumerate(("k", "v")):
        if attn:
            out[name] = torch.stack([e[j] for e in attn])
        if enc:
            out[ENC_STACKS[j]] = torch.stack([kv[j] for kv in enc])
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, params, batch, remat=False):
    """batch: dict of tensors: tokens (B, S), targets (B, S; -100 =
    ignore), [embeds (B, P, D) patches or (B, F, D) frames], [seg],
    [positions].  The full forward (`forward_full`, under `remat`), the
    logits of the text positions (a VLM's patch prefix cut off), the
    fp32 cross-entropy, the MoE aux loss weighted by
    `router_aux_weight`, and DeepSeek-V3's multi-token-prediction loss
    (weight 0.3) where `cfg.mtp_depth > 0`.  Returns (loss, metrics {ce,
    aux, tokens, [mtp_ce,] loss})."""
    tokens = batch["tokens"]
    targets = batch["targets"]
    x, _, aux, _ = forward_full(
        cfg, params, tokens, positions=batch.get("positions"),
        seg=batch.get("seg"), embeds=batch.get("embeds"), want_cache=False,
        remat=remat)
    if cfg.num_patch_tokens and batch.get("embeds") is not None:
        x_text = x[:, x.shape[1] - tokens.shape[1]:]
    else:
        x_text = x
    logits = logits_from_hidden(cfg, params, x_text)
    loss, n_tok = _ce_loss(logits, targets)
    metrics = {"ce": loss, "aux": aux, "tokens": n_tok}
    total = loss + cfg.moe.router_aux_weight * aux

    if cfg.mtp_depth > 0 and "mtp" in params:
        mtp = params["mtp"]
        h = rms_norm(x_text[:, :-1], mtp["ln_h"], cfg.norm_eps)
        e = rms_norm(params["embed"][tokens[:, 1:].long()], mtp["ln_e"],
                     cfg.norm_eps)
        hm = torch.cat([h, e], dim=-1) @ mtp["proj"]
        B, Sm, _ = hm.shape
        pos = torch.arange(Sm, dtype=torch.int32,
                           device=hm.device).expand(B, Sm)
        hm, _, mtp_aux, _ = _single_block(cfg, mtp["block"], hm, pos)
        mtp_logits = logits_from_hidden(
            cfg, params, rms_norm(hm, params["ln_f"], cfg.norm_eps))
        # position t predicts token t + 2: the targets shifted once more
        mtp_loss, _ = _ce_loss(mtp_logits[:, :-1], targets[:, 2:])
        metrics["mtp_ce"] = mtp_loss
        total = total + 0.3 * mtp_loss + cfg.moe.router_aux_weight * mtp_aux
    metrics["loss"] = total
    return total, metrics


def _single_block(cfg: ModelConfig, p, x, pos):
    """One block of the pattern's first kind (the MTP head's)."""
    y, entry, aux = block_full(p, x, cfg.layer_pattern[0], cfg, pos)
    return y, entry, aux, None


def _ce_loss(logits, targets):
    """Mean token cross-entropy in fp32 over the targets >= 0; returns
    (loss, the number of tokens counted, at least 1)."""
    mask = targets >= 0
    tgt = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    n = mask.sum().clamp_min(1)
    return -(ll * mask).sum() / n, n


def loss_fn(cfg: ModelConfig, params, batch, remat=False):
    loss, _ = forward_train(cfg, params, batch, remat)
    return loss


def prefill(cfg: ModelConfig, params, tokens, embeds=None, lengths=None,
            max_len=None, seg=None, positions=None, cache_dtype=None):
    """Run the whole prompt (B, S) in one forward and build the dense
    decode cache from it.  `lengths` (B,) are the rows' true lengths
    (default S; a VLM's patch prefix is added to them); `max_len` the
    cache's (default `cfg.max_seq_len`: pass it, a long default makes a
    large cache).  K/V of a row's valid tokens land at index = position
    (a SWA ring keeps in slot i the newest valid position p with p % W
    == i), kv_pos -1 elsewhere; SSM states and conv tails are the full
    forward's (over every token of the row, padding included, as the
    reference's); an encoder-decoder's cache holds every decoder layer's
    encoder K/V; `cur` = lengths + the patch prefix.  `prefill_chunk`
    and `decode_step` continue from it.  Returns (the logits of each
    row's last valid token (B, V), cache)."""
    B, S = tokens.shape
    max_len = max_len or cfg.max_seq_len
    cache_dtype = cache_dtype or params["embed"].dtype
    x, full, _aux, _enc = forward_full(cfg, params, tokens,
                                       positions=positions, seg=seg,
                                       embeds=embeds, want_cache=True)
    St = x.shape[1]
    dev = x.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32)
    full_lengths = lengths.to(device=dev, dtype=torch.int32) + (St - S)
    last = (full_lengths - 1).clamp(0, St - 1).long()
    logits = logits_from_hidden(cfg, params,
                                x[torch.arange(B, device=dev), last])
    cache = init_cache(cfg, B, max_len, cache_dtype, device=dev)
    if "k" in cache:
        W = cache["kv_pos"].shape[1]
        grid = torch.arange(St, dtype=torch.int32, device=dev).expand(B, St)
        if W >= St:
            cache["kv_pos"][:, :St] = torch.where(
                grid < full_lengths[:, None], grid, -1)
            for name in ("k", "v"):
                cache[name][:, :, :St] = full[name].to(cache_dtype)
        else:
            # SWA ring: slot i holds, per row, the newest VALID position
            # p with p % W == i (a row shorter than St sees no garbage)
            end = (full_lengths - 1)[:, None]
            tail = end - (end - torch.arange(W, device=dev)) % W   # (B, W)
            cache["kv_pos"] = torch.where(tail >= 0, tail, -1).to(
                torch.int32)
            idx = tail.clamp(0, St - 1)
            for name in ("k", "v"):
                new = full[name]                          # (L, B, St, ...)
                gi = idx.reshape((1, B, W) + (1,) * (new.dim() - 3)).expand(
                    (new.shape[0], B, W) + tuple(new.shape[3:]))
                cache[name] = torch.gather(new, 2, gi).to(cache_dtype)
    for name in SSM_STACKS + ENC_STACKS:
        if name in full:
            cache[name] = full[name].to(cache[name].dtype)
    cache["cur"] = full_lengths
    return logits, cache


def prefill_chunk(cfg: ModelConfig, params, tokens, cache):
    """Extend a dense cache by one chunk of prompt tokens (B, Sc): true
    chunked prefill with KV and SSM state continuation.  Returns
    (last-position logits (B, V), cache with `cur` + Sc and the new SSM
    states); the K/V rows are written in place.  An encoder-decoder's
    encoder K/V come from a prior `prefill` (the chunks extend only the
    decoder side, as in the reference).  A cache split over a DP's model
    ranks (`split_dense_cache`) runs the chunk on them
    (`_tp_prefill_chunk`)."""
    if is_merged(cache):
        return _tp_prefill_chunk(cfg, params, tokens, cache)
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
    (logits (slots, V), cache with `cur` + 1 and, for a hybrid, the new
    per-slot SSM states; every slot steps, as in `decode_step`).  The
    pools are written in place; an encoder-decoder's cross-attention
    reads each slot's encoder K/V and never writes them."""
    if is_merged(cache):
        return _sharded_decode(cfg, params, token, cache)
    pos = cache["cur"]
    tab = cache["block_tab"]
    x = params["embed"][token.long()]                    # (slots, 1, D)
    states: List = []
    for l, (p, (kind, i)) in enumerate(zip(params["layers"],
                                           stack_index(cfg))):
        entry = _layer_entry(cache, kind, i)
        if "xattn" in p:
            entry = (entry, (cache["enc_k"][l], cache["enc_v"][l]))
        x, entry = block_decode_paged(p, x, kind, cfg, entry,
                                      cache["kv_pos"], tab, pos)
        if kind not in ATTN_KINDS:
            states.append(entry)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, 0])
    out = dict(cache, **_stacked(states))
    out["cur"] = pos + 1
    return logits, out


def _require_pageable_prefill(cfg: ModelConfig) -> None:
    """Page-native prefill (and page sharing) needs every cached layer in
    pool pages: attention-only decoder-only configs."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: page-native prefill is attention-only "
            f"(encoder state has no page representation)")
    if any(k not in ATTN_KINDS for k in cfg.layer_kinds()):
        raise ValueError(
            f"{cfg.name}: page-native prefill is attention-only "
            f"(per-slot SSM state has no page representation)")


def paged_prefill_step(cfg: ModelConfig, params, tokens, cache, slot):
    """One chunked-prefill step writing straight into pool pages: extend
    slot `slot` by the chunk `tokens` ((1, Sc) int).  Earlier chunks and
    shared-prefix pages are read through the block table.  `slot` is an
    int or a one-element integer tensor on the cache's device (as the
    reference traces it: one compiled step serves every slot, and
    nothing reads it back to the host).  Returns (last-position logits
    (1, V), cache); the pools are written in place."""
    _require_pageable_prefill(cfg)
    if is_merged(cache):
        M = cache_model(cache)
        if isinstance(slot, torch.Tensor):
            # a one-DP view of a merged cache (an engine's chunk graph)
            if len(cache["shards"]) != M:
                raise TypeError("the merged cache takes host slot ids")
            d, s = 0, slot
        else:
            d, s = _dp_slot(cache, slot)
        if M > 1:
            return _tp_prefill(cfg, params, tokens, cache, d, s)
        c = cache["shards"][d]
        dev = c["cur"].device
        logits, new = paged_prefill_step(cfg, params_on(params, dev),
                                         move([tokens], [dev])[0], c, s)
        return move([logits], [tokens.device])[0], with_shard(cache, d, new)
    Sc = tokens.shape[1]
    if isinstance(slot, torch.Tensor):
        slot = slot.reshape(1).long()
        tab_row = cache["block_tab"][slot]                # (1, nbt)
    else:
        tab_row = cache["block_tab"][slot][None]          # (1, nbt)
    pos0 = cache["cur"][slot]
    positions = (pos0 + torch.arange(Sc, dtype=torch.int32,
                                     device=pos0.device)).reshape(1, Sc)
    x = params["embed"][tokens.long()]                    # (1, Sc, D)
    for l, p in enumerate(params["layers"]):
        x = block_extend_paged(p, x, cfg, cache["k"][l], cache["v"][l],
                               cache["kv_pos"], tab_row, positions)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x[:, -1])
    out = dict(cache)
    out["cur"] = _with(cache, "cur", slot, pos0 + Sc)
    return logits, out


def paged_decode_masked(cfg: ModelConfig, params, token, cache,
                        decode_mask):
    """The decode half of `mixed_step`: a paged decode step of the slots
    under `decode_mask` ((slots,) bool); the other rows decode against a
    -1 table (the null block) and keep `cur`.  With every row masked in,
    the same as `paged_decode_step`.  A hybrid's masked-out rows keep
    their SSM states and conv tails too (`_keep_masked`): a token fed to
    a row that is not decoding would corrupt its state for good.  The
    reference never masks a hybrid (its unified engine refuses them), so
    this only guards the port's own use.  Returns (logits (slots, V),
    cache)."""
    if is_merged(cache):
        return _sharded_decode(cfg, params, token, cache, decode_mask)
    tab = cache["block_tab"]
    cur = cache["cur"]
    dcache = dict(cache)
    dcache["block_tab"] = torch.where(decode_mask[:, None], tab, -1)
    logits, out = paged_decode_step(cfg, params, token, dcache)
    out = _keep_masked(out, cache, decode_mask)
    out["block_tab"] = tab
    out["cur"] = torch.where(decode_mask, cur + 1, cur)
    return logits, out


def mixed_step(cfg: ModelConfig, params, token, cache,
               chunks: Sequence, decode_mask=None, decode=None,
               prefill=None):
    """One unified mixed-batch step: the paged decode rows, then each
    `(tokens (1, Sc), slot)` prefill chunk in order, over one pool.

    `decode_mask` (slots,) bool marks the actively decoding slots;
    masked rows (prefilling residents, whose table rows are live) decode
    against a -1 table (the null block) and keep `cur`.  `decode(token,
    cache, mask)` and `prefill(tokens, cache, slot)`, when given, run
    the masked decode half and each chunk in place of
    `paged_decode_masked` and `paged_prefill_step` (the engines pass
    their compiled steps).  Returns (decode logits (slots, V), tuple of
    per-chunk last-position logits (1, V), cache)."""
    if decode is not None:
        logits, cache = decode(token, cache, decode_mask)
    elif decode_mask is not None:
        logits, cache = paged_decode_masked(cfg, params, token, cache,
                                            decode_mask)
    else:
        logits, cache = paged_decode_step(cfg, params, token, cache)
    chunk_logits = []
    for ctoks, slot in chunks:
        if prefill is not None:
            lg, cache = prefill(ctoks, cache, slot)
        else:
            lg, cache = paged_prefill_step(cfg, params, ctoks, cache, slot)
        chunk_logits.append(lg)
    return logits, tuple(chunk_logits), cache


# ---------------------------------------------------------------------------
# Page surgery
# ---------------------------------------------------------------------------

def paged_copy_block(cfg: ModelConfig, cache: Dict, src, dst) -> Dict:
    """Copy physical block `src` -> `dst` across every pool and the
    position map, in place (the copy half of copy-on-write).  Per-slot
    SSM entries are not pages: they are left alone."""
    if is_merged(cache):
        d = _home(cache)
        base = d * cache["blocks"]
        return _on_dp(cache, d, lambda m, c: paged_copy_block(
            cfg, c, src - base, dst - base))
    cache["kv_pos"][dst] = cache["kv_pos"][src]
    for name in ("k", "v"):
        cache[name][:, dst] = cache[name][:, src]
    return dict(cache)


def paged_gather_blocks(cfg: ModelConfig, cache: Dict, ids) -> Dict:
    """Block-granular handoff payload: the physical rows named by `ids`
    ((nbt,) int32, -1 padding) of every pool, plus their kv_pos rows
    (-1 on padding).  New tensors.  Pages only: a cache's per-slot SSM
    entries are not part of it (page-native prefill, the only producer,
    refuses hybrids).  On a merged cache of one DP (a TP page-native
    prefill engine's), each rank's payload on its device, split as the
    cache is ({"shards", "model"}: `_rank_share` copies rank to rank)."""
    if is_merged(cache):
        d = _home(cache)
        M = cache_model(cache)
        return {"shards": [paged_gather_blocks(
                    cfg, c, _local_blocks(cache, d, ids, c["cur"].device))
                    for c in cache["shards"][d * M:(d + 1) * M]],
                "model": M}
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
    if is_merged(dst):
        d, s = _dp_slot(dst, slot)

        def one(m, c):
            dev = c["cur"].device
            return paged_adopt_blocks(
                cfg, c, _rank_share(cfg, dst, payload, m, dev), s,
                _local_blocks(dst, d, tab_row, dev), copy_mask.to(dev),
                clear_mask.to(dev), cur)
        return _on_dp(dst, d, one)
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
    if is_merged(cache):
        d = _home(cache)
        return _on_dp(cache, d, lambda m, c: paged_clear_rows(
            c, _local_blocks(cache, d, ids, c["cur"].device)))
    cache["kv_pos"][ids.clamp_min(0).long()] = -1
    return dict(cache)


def paged_set_table(cache: Dict, slot: int, col: int, block: int) -> Dict:
    """`cache` with entry `col` of slot `slot`'s block-table row set to
    physical block `block` (a new `block_tab` tensor: a cache dict handed
    out earlier keeps its own)."""
    if is_merged(cache):
        d, s = _dp_slot(cache, slot)
        return _on_dp(cache, d, lambda m, c: paged_set_table(
            c, s, col, block - d * cache["blocks"]))
    out = dict(cache)
    out["block_tab"] = cache["block_tab"].clone()
    out["block_tab"][slot, col] = block
    return out


def paged_install_row(cache: Dict, slot: int, tab: torch.Tensor, cur: int
                      ) -> Dict:
    """`cache` with slot `slot`'s block-table row and cursor set (new
    `block_tab`/`cur` tensors: a cache dict handed out earlier keeps its
    own)."""
    if is_merged(cache):
        d, s = _dp_slot(cache, slot)
        return _on_dp(cache, d, lambda m, c: paged_install_row(
            c, s, _local_blocks(cache, d, tab, c["cur"].device), cur))
    out = dict(cache)
    out["block_tab"] = cache["block_tab"].clone()
    out["block_tab"][slot] = tab
    out["cur"] = cache["cur"].clone()
    out["cur"][slot] = cur
    return out


# ---------------------------------------------------------------------------
# Sharded plane: the merged paged cache
# ---------------------------------------------------------------------------

def _home(cache: Dict) -> int:
    """The DP a merged cache's page surgery acts on: a DP view's "home",
    or the only DP of a one-DP merged cache (a TP prefill engine's)."""
    if "home" in cache:
        return cache["home"]
    if len(cache["shards"]) != cache_model(cache):
        raise ValueError("page surgery on a merged cache of several DPs "
                         "needs a DP's view (its home)")
    return 0


def _dp_slot(cache: Dict, slot) -> Tuple[int, int]:
    """(DP unit, local slot) of global slot `slot` of a merged cache."""
    if isinstance(slot, torch.Tensor):
        raise TypeError("the merged cache takes host slot ids")
    d = slot // cache["slots"]
    return d, slot - d * cache["slots"]


def shard_slot(cache: Dict, slot) -> Tuple[int, Dict, int]:
    """(shard index, shard cache, local slot) of global slot `slot` of a
    merged cache: the shard of the slot's DP unit at model rank 0."""
    d, s = _dp_slot(cache, slot)
    k = d * cache_model(cache)
    return k, cache["shards"][k], s


def _local_blocks(cache: Dict, d: int, ids: torch.Tensor, device
                  ) -> torch.Tensor:
    """Global block ids of DP d (-1 padding kept) as its local ids, on
    `device`."""
    ids = ids.to(device, non_blocking=True)
    return torch.where(ids >= 0, ids - d * cache["blocks"], ids)


def with_shard(cache: Dict, k: int, shard: Dict) -> Dict:
    """`cache` (a merged cache or a DP's view of it) with shard k
    replaced."""
    shards = list(cache["shards"])
    shards[k] = shard
    return dict(cache, shards=shards)


def _rank_share(cfg: ModelConfig, cache: Dict, tree: Dict, m: int, device
                ) -> Dict:
    """`tree` (a dense batch-1 cache or a block payload) as model rank m of
    merged `cache` takes it, on `device`: its share of what the ranks
    split (`cache_tp_axis`: KV heads, SSM heads, encoder heads), cut
    from a whole tree, or rank m's shard of a tree already split over
    as many ranks (a TP prefill's row or payload: copied rank to
    rank)."""
    M = cache_model(cache)
    if is_merged(tree):
        if cache_model(tree) != M or len(tree["shards"]) != M:
            raise ValueError(f"a tree split over {len(tree['shards'])} "
                             f"ranks joins a cache of {M} model ranks")
        return {n: t.to(device, non_blocking=True)
                for n, t in tree["shards"][m].items()}
    return {n: rank_share(t, cache_tp_axis(cfg, n, M), m, M).to(
                device, non_blocking=True)
            for n, t in tree.items()}


def _on_dp(cache: Dict, d: int, fn) -> Dict:
    """`cache` (a merged cache or a DP's view of it) with each shard of
    DP d, model rank m, replaced by fn(m, shard)."""
    M = cache_model(cache)
    shards = list(cache["shards"])
    for m in range(M):
        shards[d * M + m] = fn(m, shards[d * M + m])
    return dict(cache, shards=shards)


def dp_view(cache: Dict, d: int) -> Dict:
    """The shards of DP d of a merged cache as a one-DP merged cache (an
    engine's chunk on that DP runs on it; `paged_prefill_step` takes a
    device slot on it)."""
    M = cache_model(cache)
    return dict(cache, shards=list(cache["shards"][d * M:(d + 1) * M]))


def with_dp(cache: Dict, d: int, view: Dict) -> Dict:
    """`cache` with DP d's shards taken from `view` (`dp_view`'s form)."""
    M = cache_model(cache)
    shards = list(cache["shards"])
    shards[d * M:(d + 1) * M] = view["shards"]
    return dict(cache, shards=shards)


def _embed_shards(cfg: ModelConfig, ps: List[Dict], toks: List,
                  groups: List[List[int]]) -> List[torch.Tensor]:
    """Each shard's embeddings of its tokens `toks` (on its device), with
    `ps` each shard's params: a whole table looked up; a tensor-parallel
    rank's slice of the vocabulary looked up where the ids fall in it
    (0 elsewhere) and all-reduced over the DP's ranks; its slice of
    d_model all-gathered."""
    w = ps[0]["embed"]
    if w.shape == (cfg.vocab_size, cfg.d_model):
        return [p["embed"][t.long()] for p, t in zip(ps, toks)]
    M = len(groups[0])
    if w.shape[0] < cfg.vocab_size:
        n = w.shape[0]
        parts = []
        for i, (p, t) in enumerate(zip(ps, toks)):
            loc = t.long() - (i % M) * n
            ok = ((loc >= 0) & (loc < n))[..., None]
            e = p["embed"][loc.clamp(0, n - 1)]
            parts.append(torch.where(ok, e, torch.zeros((), dtype=e.dtype,
                                                        device=e.device)))
        return all_reduce(parts, groups)
    return all_gather([p["embed"][t.long()] for p, t in zip(ps, toks)],
                      groups, dim=-1)


def _logits_shards(cfg: ModelConfig, ps: List[Dict], hs: List,
                   groups: List[List[int]], device) -> torch.Tensor:
    """The logits of every DP's rows, in DP order, on `device`, from each
    shard's final hidden states `hs` (rows, D): one DP's from its model
    rank 0 where the head is whole, its ranks' vocabulary slices
    gathered, or their d_model slices' partial products reduced."""
    M = len(groups[0])
    w = ps[0]["embed"] if cfg.tie_embeddings else ps[0]["lm_head"]
    v_ax = 0 if cfg.tie_embeddings else 1
    if M == 1 or w.shape[v_ax] == cfg.vocab_size and \
            w.shape[1 - v_ax] == cfg.d_model:
        lead = [logits_from_hidden(cfg, ps[g[0]], hs[g[0]]) for g in groups]
        return torch.cat(move(lead, [device] * len(lead)))
    if w.shape[v_ax] < cfg.vocab_size:
        parts = [logits_from_hidden(cfg, p, h) for p, h in zip(ps, hs)]
        return torch.cat(gather_to(parts, groups, -1, device))
    n = w.shape[1 - v_ax]
    parts = [logits_from_hidden(cfg, p, h[..., (i % M) * n:(i % M + 1) * n])
             for i, (p, h) in enumerate(zip(ps, hs))]
    return torch.cat(reduce_to(parts, groups, device))


def _sharded_decode(cfg: ModelConfig, params, token, cache: Dict,
                    decode_mask=None):
    """One decode step over every shard of a merged cache: per layer, each
    shard's mixer over its rows on its device (attention over its pages,
    or a hybrid's SSM decode from its slots' states; under TP as
    `attn_shards` and `ssm_shards` join them over the DP's model
    ranks), an encoder-decoder's cross-attention over each slot's
    encoder K/V (under TP each rank's heads, `cross_shards`), then the
    FFN over all shards' rows (`mlp_shards`).  `token` (n·S, 1) and
    the optional `decode_mask` (n·S,) in global slot order, or each a
    list of every shard's rows (its DP's) on its device (the engines'
    form: a step graph's static inputs per shard); masked-out rows
    decode against a -1 table and keep `cur` and their SSM states (as
    `paged_decode_masked`).  Returns (logits (n·S, V) on shard 0's
    device, the merged cache)."""
    S = cache["slots"]
    M = cache_model(cache)
    groups = dp_groups(cache)
    devs = [c["cur"].device for c in cache["shards"]]

    def per_shard(t):
        if t is None or isinstance(t, (list, tuple)):
            return t
        return move([t[(i // M) * S:(i // M + 1) * S]
                     for i in range(len(devs))], devs)
    toks, masks = per_shard(token), per_shard(decode_mask)
    ps, rows = [], []
    for i, c in enumerate(cache["shards"]):
        ps.append(rank_params(params, devs[i], i % M, M))
        tab, mask = c["block_tab"], None
        if masks is not None:
            mask = masks[i]
            tab = torch.where(mask[:, None], tab, -1)
        rows.append((c, tab, mask))
    xs = _embed_shards(cfg, ps, toks, groups)            # (S, 1, D) each
    states: List[List] = [[] for _ in devs]
    attend = (mla_decode_paged if cfg.attention == AttentionKind.MLA
              else attn_decode_paged)
    for l, (kind, i) in enumerate(stack_index(cfg)):
        lp = [p["layers"][l] for p in ps]
        ents = [_layer_entry(c, kind, i) for c, _t, _m in rows]
        if M > 1 and ssm_split(lp[0], cfg):
            ys, ents = ssm_shards(lp, xs, cfg, ents, groups)
        elif M > 1 and kind in ATTN_KINDS:
            ys = attn_shards(
                lp, xs, cfg, attend,
                [(e[0], e[1], c["kv_pos"], tab, c["cur"])
                 for e, (c, tab, _m) in zip(ents, rows)],
                [c["cur"][:, None] for c, _t, _m in rows], groups)
        else:
            outs = [mixer_decode_paged(p, x, kind, cfg, e, c["kv_pos"], tab,
                                       c["cur"])
                    for p, x, e, (c, tab, _m) in zip(lp, xs, ents, rows)]
            ys, ents = [y for y, _e in outs], [e for _y, e in outs]
        xs = [x + y for x, y in zip(xs, ys)]
        if kind not in ATTN_KINDS:
            for st, e in zip(states, ents):
                st.append(e)
        xs = cross_shards(lp, xs, cfg, [(c["enc_k"][l], c["enc_v"][l])
                                        for c, _t, _m in rows]
                          if "xattn" in lp[0] else None, groups)
        xs = mlp_shards(lp, xs, cfg, groups)
    hs = [rms_norm(x, p["ln_f"], cfg.norm_eps)[:, 0] for p, x in zip(ps, xs)]
    # the logits' move to shard 0 is the step's last cut on distinct
    # cards (`distributed.transfer`)
    logits = _logits_shards(cfg, ps, hs, groups, devs[0])
    shards = []
    for c, (_c, _tab, mask), st in zip(cache["shards"], rows, states):
        out = dict(c, **_stacked(st))
        if mask is None:
            out["cur"] = c["cur"] + 1
        else:
            out = _keep_masked(out, c, mask)
            out["cur"] = torch.where(mask, c["cur"] + 1, c["cur"])
        shards.append(out)
    return logits, dict(cache, shards=shards)


def _tp_layers(cfg: ModelConfig, ps: List[Dict], xs: List, cs: List[Dict],
               attend, args: List, positions: List, states: List[List]):
    """Every layer of a chunk on the M model ranks of one DP, each rank
    the same rows (`ps`, `xs`, `cs`: each rank's params, hidden states
    and cache; `attend`: the attention arm, `args[m]` its cache
    arguments after the K/V; `positions`: each rank's (B, Sc)
    positions): each attention layer as `attn_shards` (its split heads'
    partials all-reduced, or the row-parallel form), each SSM layer by
    heads through #4 (`ssm_shards`, its new states appended to
    `states`), a decoder layer's cross-attention over its heads of the
    encoder K/V (`cross_shards`), a dense FFN's partials all-reduced, an
    MoE once from rank 0's rows (`moe_lead_shards`).  Returns the hidden
    states of every rank."""
    group = [list(range(len(ps)))]
    for l, (kind, i) in enumerate(stack_index(cfg)):
        lp = [p["layers"][l] for p in ps]
        if kind in ATTN_KINDS:
            ys = attn_shards(lp, xs, cfg, attend,
                             [(c["k"][i], c["v"][i]) + tuple(a)
                              for c, a in zip(cs, args)], positions, group)
        elif ssm_split(lp[0], cfg):
            ys, ents = ssm_shards(lp, xs, cfg,
                                  [_layer_entry(c, kind, i) for c in cs],
                                  group, gated=mamba_forward_gated)
            for st, e in zip(states, ents):
                st.append(e)
        else:
            raise ValueError(f"{cfg.name}: an SSM layer whose heads do not "
                             f"split over {len(ps)} model ranks")
        xs = [x + y for x, y in zip(xs, ys)]
        xs = cross_shards(lp, xs, cfg, [(c["enc_k"][l], c["enc_v"][l])
                                        for c in cs]
                          if "xattn" in lp[0] else None, group)
        if "moe" in lp[0]:
            xs = moe_lead_shards(lp, xs, cfg, group)
        else:
            xs = mlp_shards(lp, xs, cfg, group)
    return xs


def _tp_prefill_chunk(cfg: ModelConfig, params, tokens, cache: Dict):
    """`prefill_chunk` on the M > 1 model ranks of one DP, over a dense
    cache split over them (`split_dense_cache`): each rank writes its
    heads' K/V into its share of the rows and attends with its heads
    (#2's contiguous entry; MLA: every rank the same latent rows into
    its whole latent rows, torch ops; the row-parallel form: the same
    K/V on every rank, the attention whole), each SSM layer runs its
    heads through #4 with the gated norm's sums of squares all-reduced;
    the partial outputs are all-reduced, an MoE runs once from rank 0's
    rows (see `_tp_layers`); the embedding and logits over the ranks'
    slices.  Nothing of the chunk runs on whole weights.  Returns (the
    last position's logits (B, V) on the tokens' device, the split
    cache with `cur` + Sc and each rank's new SSM states)."""
    M = cache_model(cache)
    cs = cache["shards"]
    if len(cs) != M:
        raise ValueError(f"a dense cache split over {M} model ranks holds "
                         f"one DP's ranks, not {len(cs)} shards")
    devs = [c["cur"].device for c in cs]
    group = [list(range(M))]
    ps = [rank_params(params, dev, m, M) for m, dev in enumerate(devs)]
    Sc = tokens.shape[1]
    poss = [c["cur"][:, None] + torch.arange(Sc, dtype=torch.int32,
                                             device=dev)[None]
            for c, dev in zip(cs, devs)]
    xs = _embed_shards(cfg, ps, move([tokens] * M, devs), group)
    attend = (mla_extend if cfg.attention == AttentionKind.MLA
              else attn_extend)
    states: List[List] = [[] for _ in devs]
    xs = _tp_layers(cfg, ps, xs, cs, attend,
                    [(c["kv_pos"], pos) for c, pos in zip(cs, poss)], poss,
                    states)
    hs = [rms_norm(x, p["ln_f"], cfg.norm_eps)[:, -1] for p, x in zip(ps, xs)]
    logits = _logits_shards(cfg, ps, hs, group, tokens.device)
    new = []
    for c, st in zip(cs, states):
        out = dict(c, **_stacked(st))
        out["cur"] = c["cur"] + Sc
        new.append(out)
    return logits, dict(cache, shards=new)


def _tp_prefill(cfg: ModelConfig, params, tokens, cache: Dict, d: int,
                slot):
    """`paged_prefill_step` on the M > 1 model ranks of DP d of a merged
    cache (`_tp_layers`): each rank writes its heads' K/V into its pools
    (an MLA layer: every rank the same latent rows into its whole latent
    pools; the row-parallel form: the same K/V into whole pools) and
    attends with its heads (#2's paged entry; MLA torch ops), the
    partial outputs all-reduced; a dense FFN's partials all-reduced; an
    MoE FFN run once from rank 0's rows (the EP layer's tensor form) and
    sent to the other ranks, split shared experts' partials all-reduced.
    `slot` is local to the DP: an int, or a one-element tensor (a
    `dp_view`'s chunk graph).  Returns (last-position logits (1, V) on
    the tokens' device, cache)."""
    M = cache_model(cache)
    cs = cache["shards"][d * M:(d + 1) * M]
    devs = [c["cur"].device for c in cs]
    group = [list(range(M))]
    ps = [rank_params(params, dev, m, M) for m, dev in enumerate(devs)]
    toks = move([tokens] * M, devs)
    slots = (move([slot.reshape(1).long()] * M, devs)
             if isinstance(slot, torch.Tensor) else [slot] * M)
    Sc = tokens.shape[1]
    tabs, poss, pos0s = [], [], []
    for c, s, dev in zip(cs, slots, devs):
        tabs.append(c["block_tab"][s] if isinstance(s, torch.Tensor)
                    else c["block_tab"][s][None])              # (1, nbt)
        pos0s.append(c["cur"][s])
        poss.append((pos0s[-1] + torch.arange(
            Sc, dtype=torch.int32, device=dev)).reshape(1, Sc))
    xs = _embed_shards(cfg, ps, toks, group)                    # (1, Sc, D)
    attend = (mla_extend_paged if cfg.attention == AttentionKind.MLA
              else attn_extend_paged)
    xs = _tp_layers(cfg, ps, xs, cs, attend,
                    [(c["kv_pos"], tab, pos)
                     for c, tab, pos in zip(cs, tabs, poss)], poss,
                    [[] for _ in devs])
    hs = [rms_norm(x, p["ln_f"], cfg.norm_eps)[:, -1] for p, x in zip(ps, xs)]
    logits = _logits_shards(cfg, ps, hs, group, tokens.device)
    new = []
    for c, s, pos0 in zip(cs, slots, pos0s):
        out = dict(c)
        out["cur"] = _with(c, "cur", s, pos0 + Sc)
        new.append(out)
    shards = list(cache["shards"])
    shards[d * M:(d + 1) * M] = new
    return logits, dict(cache, shards=shards)
