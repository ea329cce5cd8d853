"""PyTorch port: the paged cache of an encoder-decoder model (reduced
whisper-large-v3, fp32 on the CPU): each slot's encoder K/V beside the
pages, as the reference's `_paged_entry_struct`, held against the JAX
functions on the same bridged weights and numpy inputs:

  * `init_paged_cache` and `paged_cache_join` of three prefilled
    requests equal JAX's (`cache_to_numpy`), the encoder K/V in their
    slots; `paged_cache_take` returns each slot's dense batch-1 cache
    (its encoder K/V included) as JAX's does; `paged_cache_clear_slot`
    drops the table row only;
  * `paged_decode_step` over N_STEPS greedy steps, with an idle slot,
    equals JAX's (logits within 1e-5 of the largest, pools and encoder
    stacks within 1e-5) and the dense `decode_step`'s tokens;
  * the merged cache over four logical CPU shards, on a data-only
    (4, 1) mesh and on a (2, 2) mesh with tensor parallelism, carries
    the encoder K/V with their slots (under TP each rank its heads of
    them), and its decode step equals the unsharded one;
  * the page surgery (`paged_copy_block`, `paged_gather_blocks`,
    `paged_adopt_blocks`) moves pool pages only and leaves the encoder
    K/V in their slot, as JAX's; page-native prefill refuses an
    encoder-decoder model with ValueError in both packages;
  * chip_smoke.py's phase 6i paged leg rehearsed at the reduced size.

Tolerance: 1e-5 of the largest magnitude (fp32; sums taken in another
order by XLA and by PyTorch); tokens and integer maps exact.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models import model as JM

from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.config.base import ParallelConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.distributed.sharding import (
    cache_tp_axis, place_params, rank_share, shard_paged_cache,
    unshard_paged_cache,
)
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import model as TM
from repro_torch.serving.kv_pool import pad_block_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-large-v3"
MAX_LEN = 64
BLOCK = 8
NBT = MAX_LEN // BLOCK
SLOTS = 4
NBLOCKS = 4 * NBT
LENS = (5, 9, 13)          # prompts of the three joined requests
SLOT_OF = (2, 0, 3)        # slot 1 stays idle
N_STEPS = 6
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pair():
    cfg = get_arch(ARCH, reduced=True)
    tcfg = t_get_arch(ARCH, reduced=True)
    jp = jax.jit(JM.init_params, static_argnums=0)(cfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tcfg, tp


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _table(slot):
    """Slot `slot`'s blocks: NBT - 1 consecutive ids from 1 + slot·NBT,
    inside its DP's block range on the merged meshes below (block 0 of
    each range is a null block)."""
    return pad_block_table(list(range(1 + slot * NBT, (slot + 1) * NBT)),
                           NBT)


@pytest.fixture(scope="module")
def joined(pair):
    """Both packages' paged caches after joining the three prefilled
    requests, with each request's first token and dense cache."""
    cfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(11)
    frames = (rng.normal(size=(len(LENS), cfg.encoder_seq_len, cfg.d_model))
              * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(len(LENS), max(LENS)))
    jpre = jax.jit(lambda p, t, e: JM.prefill(cfg, p, t, embeds=e,
                                              max_len=MAX_LEN))
    jc = JM.init_paged_cache(cfg, SLOTS, NBLOCKS, MAX_LEN, BLOCK)
    tc = TM.init_paged_cache(tcfg, SLOTS, NBLOCKS, MAX_LEN, BLOCK,
                             device="cpu")
    zero = cache_to_numpy(tcfg, tc)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(zero)):
        assert np.array_equal(a, b)
    firsts, dense = [], []
    for r, (n, slot) in enumerate(zip(LENS, SLOT_OF)):
        tab = _table(slot)
        t = np.asarray(toks[r:r + 1, :n], np.int32)
        jl, jd = jpre(jp, jnp.asarray(t), jnp.asarray(frames[r:r + 1]))
        tl, td = TM.prefill(tcfg, tp, torch.tensor(t),
                            embeds=torch.tensor(frames[r:r + 1]),
                            max_len=MAX_LEN)
        assert _rel(tl.numpy(), jl) <= TOL
        firsts.append(int(np.argmax(np.asarray(jl)[0])))
        dense.append(td)
        jc = JM.paged_cache_join(cfg, jc, jd, slot, jnp.asarray(tab,
                                                                jnp.int32))
        tc = TM.paged_cache_join(tcfg, tc, td, slot,
                                 torch.tensor(tab, dtype=torch.int32))
    return jc, tc, firsts, dense


def test_join_and_take_match_jax(pair, joined):
    cfg, _jp, tcfg, _tp = pair
    jc, tc, _firsts, dense = joined
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc),
                            device="cpu")
    assert set(want) == set(tc) and "enc_k" in tc
    for name in want:
        if want[name].is_floating_point():
            assert _rel(tc[name].numpy(), want[name].numpy()) <= TOL, name
        else:
            assert torch.equal(tc[name], want[name]), name
    for r, slot in enumerate(SLOT_OF):
        # the joined request's encoder K/V sit in its slot, every layer
        for name in ("enc_k", "enc_v"):
            assert torch.equal(tc[name][:, slot], dense[r][name][:, 0])
        jt = JM.paged_cache_take(cfg, jc, slot)
        tt = TM.paged_cache_take(tcfg, tc, slot)
        jt_t = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jt),
                                device="cpu")
        assert set(jt_t) == set(tt)
        for name in tt:
            if tt[name].is_floating_point():
                assert _rel(tt[name].numpy(), jt_t[name].numpy()) <= TOL
            else:
                assert torch.equal(tt[name], jt_t[name]), name
        # a taken slot is a copy
        assert tt["enc_k"].data_ptr() != tc["enc_k"].data_ptr()
    cleared = TM.paged_cache_clear_slot(tc, SLOT_OF[0])
    jcl = JM.paged_cache_clear_slot(jc, SLOT_OF[0])
    assert np.array_equal(cleared["block_tab"].numpy(),
                          np.asarray(jcl["block_tab"]))
    assert (cleared["block_tab"][SLOT_OF[0]] == -1).all()
    assert cleared["enc_k"] is tc["enc_k"]
    assert (tc["block_tab"][SLOT_OF[0]] >= 0).any()   # a new table


def _clone(c):
    return {k: v.clone() for k, v in c.items()}


def test_paged_decode_steps_match_jax_and_dense(pair, joined):
    cfg, jp, tcfg, tp = pair
    jc, tc, firsts, dense = joined
    tc = _clone(tc)
    jdec = jax.jit(lambda p, t, c: JM.paged_decode_step(cfg, p, t, c))
    tok = np.zeros((SLOTS, 1), np.int32)
    for r, slot in enumerate(SLOT_OF):
        tok[slot, 0] = firsts[r]
    got = [[] for _ in LENS]
    for _ in range(N_STEPS):
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = TM.paged_decode_step(tcfg, tp, torch.tensor(tok), tc)
        assert _rel(tl.numpy(), jl) <= TOL
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(nxt, tl.argmax(-1).numpy())
        for r, slot in enumerate(SLOT_OF):
            got[r].append(int(nxt[slot]))
        tok = nxt[:, None]
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc),
                            device="cpu")
    for name in ("k", "v", "enc_k", "enc_v"):
        assert _rel(tc[name].numpy(), want[name].numpy()) <= TOL, name
    assert torch.equal(tc["kv_pos"], want["kv_pos"])
    assert torch.equal(tc["cur"], want["cur"])
    # the dense decode of each request alone gives the same tokens
    for r in range(len(LENS)):
        c, t, toks = _clone(dense[r]), firsts[r], []
        for _ in range(N_STEPS):
            lg, c = TM.decode_step(tcfg, tp, torch.tensor([[t]]), c)
            t = int(lg[0].argmax())
            toks.append(t)
        assert toks == got[r], r


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["dp4", "dp2xtp2"])
def test_merged_cache_carries_encoder_kv_and_steps(pair, joined, shape):
    _cfg, _jp, tcfg, tp = pair
    _jc, tc, firsts, _dense = joined
    data, model = shape
    mesh = make_engine_mesh(data, model, devices=["cpu"] * 4)
    glob = _clone(tc)
    merged = shard_paged_cache(_clone(tc), mesh, tcfg)
    S = SLOTS // data
    for i, c in enumerate(merged["shards"]):
        d, m = divmod(i, model)
        for name in ("enc_k", "enc_v"):
            # each model rank holds its heads of its DP's slots
            assert torch.equal(c[name], rank_share(
                glob[name][:, d * S:(d + 1) * S],
                cache_tp_axis(tcfg, name, model), m, model))
    back = unshard_paged_cache(merged, "cpu", tcfg)
    for name in glob:
        assert torch.equal(back[name], glob[name]), name
    params = place_params(tcfg, tp, mesh, ParallelConfig())
    tok = torch.zeros((SLOTS, 1), dtype=torch.int64)
    for r, slot in enumerate(SLOT_OF):
        tok[slot, 0] = firsts[r]
    for _ in range(3):
        lg_s, merged = TM.paged_decode_step(tcfg, params, tok, merged)
        lg_1, glob = TM.paged_decode_step(tcfg, tp, tok, glob)
        assert _rel(lg_s.numpy(), lg_1.numpy()) <= TOL
        tok = lg_1.argmax(-1)[:, None]
        assert torch.equal(lg_s.argmax(-1)[:, None], tok)
    back = unshard_paged_cache(merged, "cpu", tcfg)
    B = NBLOCKS // data
    live = torch.arange(NBLOCKS) % B != 0
    for name in ("k", "v"):
        assert _rel(back[name][:, live].numpy(),
                    glob[name][:, live].numpy()) <= TOL
    for name in ("enc_k", "enc_v", "cur"):
        assert torch.equal(back[name], glob[name]), name


def test_page_surgery_moves_pages_only_and_prefill_refuses(pair, joined):
    cfg, jp, tcfg, tp = pair
    jc, tc, _firsts, _dense = joined
    tc = _clone(tc)
    enc = tc["enc_k"].clone()
    src_slot, dst_slot = SLOT_OF[2], 1
    ids = tc["block_tab"][src_slot]
    payload = TM.paged_gather_blocks(tcfg, tc, ids)
    jpay = JM.paged_gather_blocks(cfg, jc, jnp.asarray(ids.numpy()))
    assert set(payload) == {"kv_pos", "k", "v"}
    assert np.array_equal(payload["kv_pos"].numpy(),
                          np.asarray(jpay["kv_pos"]))
    tab = torch.tensor(pad_block_table(list(range(NBLOCKS - 3, NBLOCKS)),
                                       NBT), dtype=torch.int32)
    copy = torch.arange(NBT) < 2
    clear = torch.arange(NBT) == 2
    tc = TM.paged_adopt_blocks(tcfg, tc, payload, dst_slot, tab, copy,
                               clear, 13)
    jc = JM.paged_adopt_blocks(cfg, jc, jpay, dst_slot,
                               jnp.asarray(tab.numpy()),
                               jnp.asarray(copy.numpy()),
                               jnp.asarray(clear.numpy()), 13)
    tc = TM.paged_copy_block(tcfg, tc, NBLOCKS - 3, NBLOCKS - 1)
    jc = JM.paged_copy_block(cfg, jc, NBLOCKS - 3, NBLOCKS - 1)
    # the encoder K/V stay where they were: the adopted slot's are not
    # written (a payload carries pages only)
    assert torch.equal(tc["enc_k"], enc)
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc),
                            device="cpu")
    for name in want:
        if want[name].is_floating_point():
            assert _rel(tc[name].numpy(), want[name].numpy()) <= TOL, name
        else:
            assert torch.equal(tc[name], want[name]), name
    chunk = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        TM.paged_prefill_step(tcfg, tp, chunk, tc, 0)
    with pytest.raises(ValueError, match="attention-only"):
        JM.paged_prefill_step(cfg, jp, jnp.asarray(chunk.numpy()), jc, 0)


def test_chip_smoke_paged_encdec_leg_rehearsed(pair):
    """Phase 6i's paged leg at the reduced size on the CPU: the requests
    joined into a paged cache after the dense prefill decode beside the
    dense steps with the same logits, and the clear empties the table."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    _cfg, _jp, tcfg, tp = pair
    rep = chip_smoke.paged_encdec(tcfg, tp, "cpu", [], lens=(4, 9, 17),
                                  max_len=128, steps=4)
    assert rep["logits_rel_err"] <= 1e-4
    assert rep["tokens_equal"] and rep["table_cleared"]
    L = tcfg.num_layers
    assert rep["expected"] == {"paged_decode_attention": L * 4,
                               "flash_prefill_noncausal": L * 4}
