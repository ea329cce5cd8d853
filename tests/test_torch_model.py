"""PyTorch port: the paged step family (`paged_prefill_step`,
`paged_decode_step`, `mixed_step` with `decode_mask`) and the page
surgery around it, and the dense family (`attn_extend`/`attn_decode`,
`prefill_chunk`/`decode_step`, `cache_join`/`cache_take`), run in
lockstep with the JAX functions on the same (bridged) weights of reduced
deepseek-7b — the dense family also on reduced h2o-danube-3-4b, whose
window-64 ring cache wraps, on reduced mamba2-370m (SSM layers only:
the SSD scan, the per-row SSM and conv state) and on a MoE-free hybrid
(reduced jamba with the layer pattern (SSM, DENSE): the per-kind cache
stacks side by side) — in fp32.

Scenarios of tests/test_mixed_batch.py:100-230 (mid-stream graduation,
decode-mask protection, the degenerate step) and
tests/test_real_plane.py:156-250 (paged batched decode with late joins,
the take round trip).  Tokens must match exactly; logits within 1e-4
(fp32 through two layers, sums in another order); pool contents and
conv tails within 1e-5, except the null block 0, which holds garbage by
design; SSM states within 1e-5 of their largest magnitude.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import LayerKind as JLK
from repro.models import model as JM
from repro.serving.kv_pool import BlockPool, pad_block_table

from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.config.base import LayerKind as TLK
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import model as TM

MAX_LEN = 96
BLOCK = 16
NBT = MAX_LEN // BLOCK
N_NEW = 5
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Jax:
    """The JAX step family (jitted), behind one small interface."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params
        self._prefill = jax.jit(
            lambda p, t, c, s: JM.paged_prefill_step(cfg, p, t, c, s))
        self._decode = jax.jit(
            lambda p, t, c: JM.paged_decode_step(cfg, p, t, c))
        self._mixed = jax.jit(
            lambda p, t, c, ch, m: JM.mixed_step(cfg, p, t, c, ch, m))
        self._dense_chunk = jax.jit(
            lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
        self._dense_decode = jax.jit(
            lambda p, t, c: JM.decode_step(cfg, p, t, c))

    def cache(self, slots, n_blocks):
        return JM.init_paged_cache(self.cfg, slots, n_blocks, MAX_LEN, BLOCK)

    def stage(self, c, slot, ids):
        tab = jnp.asarray(pad_block_table(ids, NBT), jnp.int32)
        return dict(c, block_tab=c["block_tab"].at[slot].set(tab),
                    cur=c["cur"].at[slot].set(0))

    def prefill(self, c, ids, slot):
        lg, c = self._prefill(self.params, jnp.asarray([ids], jnp.int32), c,
                              jnp.int32(slot))
        return np.asarray(lg), c

    def decode(self, c, toks):
        lg, c = self._decode(self.params, jnp.asarray(toks, jnp.int32)[:, None],
                             c)
        return np.asarray(lg), c

    def mixed(self, c, toks, chunks, mask):
        ch = tuple((jnp.asarray([ids], jnp.int32), jnp.int32(s))
                   for ids, s in chunks)
        m = None if mask is None else jnp.asarray(mask)
        if m is None:
            lg, clg, c = JM.mixed_step(
                self.cfg, self.params, jnp.asarray(toks, jnp.int32)[:, None],
                c, ch)
        else:
            lg, clg, c = self._mixed(
                self.params, jnp.asarray(toks, jnp.int32)[:, None], c, ch, m)
        return np.asarray(lg), [np.asarray(x) for x in clg], c

    def numpy(self, c):
        return jax.tree.map(np.asarray, c)


class _Torch:
    """The port's step family behind the same interface."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def cache(self, slots, n_blocks):
        return TM.init_paged_cache(self.cfg, slots, n_blocks, MAX_LEN, BLOCK,
                                   device="cpu")

    def stage(self, c, slot, ids):
        c = dict(c, block_tab=c["block_tab"].clone(), cur=c["cur"].clone())
        c["block_tab"][slot] = torch.tensor(pad_block_table(ids, NBT))
        c["cur"][slot] = 0
        return c

    def prefill(self, c, ids, slot):
        lg, c = TM.paged_prefill_step(self.cfg, self.params,
                                      torch.tensor([ids]), c, slot)
        return lg.numpy(), c

    def decode(self, c, toks):
        lg, c = TM.paged_decode_step(self.cfg, self.params,
                                     torch.tensor(toks)[:, None], c)
        return lg.numpy(), c

    def mixed(self, c, toks, chunks, mask):
        ch = tuple((torch.tensor([ids]), s) for ids, s in chunks)
        m = None if mask is None else torch.tensor(mask)
        lg, clg, c = TM.mixed_step(self.cfg, self.params,
                                   torch.tensor(toks)[:, None], c, ch, m)
        return lg.numpy(), [x.numpy() for x in clg], c

    def numpy(self, c):
        return cache_to_numpy(self.cfg, c)


@pytest.fixture(scope="module")
def pair():
    cfg = get_arch("deepseek-7b", reduced=True)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return _Jax(cfg, params), _Torch(tcfg, tparams)


def _assert_caches_match(jc, tc):
    """Same cursors, tables and positions; same pool contents outside the
    null block (block 0 takes every inactive row's garbage write)."""
    for key in ("cur", "block_tab"):
        assert np.array_equal(jc[key], tc[key]), key
    assert np.array_equal(jc["kv_pos"][1:], tc["kv_pos"][1:])
    for a, b in zip(jc["blocks"]["p0"], tc["blocks"]["p0"]):
        assert np.abs(a[:, 1:] - b[:, 1:]).max() <= 1e-5


def _argmax(lg):
    return [int(x) for x in np.argmax(lg, axis=-1)]


def _prompts(cfg, lens, seed):
    rng = random.Random(seed)
    return [[rng.randrange(cfg.vocab_size) for _ in range(L)] for L in lens]


# ---------------------------------------------------------------------------
# tests/test_mixed_batch.py:100 — graduation inside mixed steps
# ---------------------------------------------------------------------------

def _mixed_graduation(api, prompts):
    """Slots 0 and 2 decode while slot 1 prefills chunk by chunk INSIDE
    the same mixed steps, then graduates into the decode half.  Returns
    (token streams, every logits array, final cache)."""
    pool = BlockPool(18, BLOCK)
    c = api.cache(3, 18)
    toks, logs, next_tok = {}, [], [0, 0, 0]
    for s in (0, 2):
        c = api.stage(c, s, pool.alloc(pool.blocks_for(len(prompts[s])
                                                       + N_NEW)))
        for i in range(0, len(prompts[s]), 16):
            lg, c = api.prefill(c, prompts[s][i:i + 16], s)
        logs.append(lg)
        toks[s] = [_argmax(lg)[0]]
        next_tok[s] = toks[s][0]
    c = api.stage(c, 1, pool.alloc(pool.blocks_for(len(prompts[1]) + N_NEW)))
    consumed, mask = 0, [True, False, True]
    for _ in range(2 * N_NEW + len(prompts[1]) // 16 + 2):
        active = [s for s in toks if len(toks[s]) < N_NEW]
        if not active and consumed >= len(prompts[1]):
            break
        chunks = []
        if consumed < len(prompts[1]):
            chunks = [(prompts[1][consumed:consumed + 16], 1)]
        lg, clg, c = api.mixed(c, next_tok, chunks, list(mask))
        logs += [lg] + clg
        nxt = _argmax(lg)
        for s in active:
            toks[s].append(nxt[s])
            next_tok[s] = nxt[s]
        if chunks:
            consumed += len(chunks[0][0])
            if consumed >= len(prompts[1]):
                toks[1] = [_argmax(clg[0])[0]]
                next_tok[1] = toks[1][0]
                mask[1] = True
    return [toks[s] for s in range(3)], logs, api.numpy(c)


def test_mixed_step_graduation_token_exact_vs_jax(pair):
    jx, tx = pair
    prompts = _prompts(jx.cfg, (23, 48, 37), seed=0)
    jt, jl, jc = _mixed_graduation(jx, prompts)
    tt, tl, tc = _mixed_graduation(tx, prompts)
    assert tt == jt
    assert all(len(t) == N_NEW for t in tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.abs(a - b).max() <= LOGIT_TOL
    _assert_caches_match(jc, tc)


# ---------------------------------------------------------------------------
# tests/test_mixed_batch.py:178 — decode_mask protects prefilling rows
# ---------------------------------------------------------------------------

def _masked_step(api, ids):
    pool = BlockPool(12, BLOCK)
    c = api.cache(2, 12)
    c = api.stage(c, 0, pool.alloc(pool.blocks_for(16 + 4)))
    lg, c = api.prefill(c, ids, 0)
    held = pool.alloc(pool.blocks_for(48))
    c = api.stage(c, 1, held)
    _, c = api.prefill(c, ids, 1)
    before = api.numpy(c)
    lg2, _, c = api.mixed(c, [_argmax(lg)[0], 0], [], [True, False])
    return held, before, api.numpy(c), lg2


def test_mixed_step_decode_mask_protects_prefilling_rows(pair):
    jx, tx = pair
    ids = _prompts(jx.cfg, (16,), seed=2)[0]
    held, before, after, tl = _masked_step(tx, ids)
    assert after["cur"][1] == before["cur"][1]          # cursor untouched
    assert after["cur"][0] == 17                         # active row moved
    assert np.array_equal(after["kv_pos"][held], before["kv_pos"][held])
    for a, b in zip(after["blocks"]["p0"], before["blocks"]["p0"]):
        assert np.array_equal(a[:, held], b[:, held])    # pages untouched
    _jheld, _jb, jafter, jl = _masked_step(jx, ids)
    assert np.abs(jl[0] - tl[0]).max() <= LOGIT_TOL
    _assert_caches_match(jafter, after)


def test_mixed_step_degenerates_to_paged_decode(pair):
    """No chunks, no mask: the fused step IS paged_decode_step (and both
    match the JAX step)."""
    jx, tx = pair
    ids = _prompts(jx.cfg, (16,), seed=3)[0]
    out = []
    for api in (tx, jx):
        pool = BlockPool(8, BLOCK)
        c = api.cache(2, 8)
        c = api.stage(c, 0, pool.alloc(pool.blocks_for(16 + 4)))
        lg, c = api.prefill(c, ids, 0)
        toks = [_argmax(lg)[0], 0]
        ml, chunk_lg, mc = api.mixed(c, toks, [], None)
        dl, dc = api.decode(c, toks)
        assert chunk_lg == []
        assert np.array_equal(np.argmax(ml, -1), np.argmax(dl, -1))
        assert np.array_equal(api.numpy(mc)["cur"], api.numpy(dc)["cur"])
        out.append(ml)
    assert np.abs(out[0] - out[1]).max() <= LOGIT_TOL


# ---------------------------------------------------------------------------
# tests/test_real_plane.py:156-250 — joins of dense caches, take round trip
# ---------------------------------------------------------------------------

def _dense_prefill(jx, ids):
    """The JAX seed prefill: batch-1 chunked build of a dense cache."""
    cache = JM.init_cache(jx.cfg, 1, MAX_LEN)
    for i in range(0, len(ids), 16):
        lg, cache = jx._dense_chunk(jx.params,
                                    jnp.asarray([ids[i:i + 16]], jnp.int32),
                                    cache)
    return int(jnp.argmax(lg[0])), cache


def _serial(jx, t0, cache, n):
    toks = [t0]
    for _ in range(n - 1):
        lg, cache = jx._dense_decode(jx.params,
                                     jnp.asarray([[toks[-1]]], jnp.int32),
                                     cache)
        toks.append(int(jnp.argmax(lg[0])))
    return toks


def _join(api, c, pool, dense, slot, life):
    ids = pool.alloc(pool.blocks_for(life))
    if isinstance(api, _Torch):
        src = cache_from_numpy(api.cfg, jax.tree.map(np.asarray, dense),
                               device="cpu")
        tab = torch.tensor(pad_block_table(ids, NBT), dtype=torch.int32)
        return TM.paged_cache_join(api.cfg, c, src, slot, tab), ids
    tab = jnp.asarray(pad_block_table(ids, NBT), jnp.int32)
    return JM.paged_cache_join(api.cfg, c, dense, slot, tab), ids


def test_paged_batched_continuous_decode_matches_serial(pair):
    """Requests joining a paged cache at different steps generate exactly
    the serial decode's tokens, on both frameworks, in lockstep."""
    jx, tx = pair
    prompts = _prompts(jx.cfg, (23, 37, 11), seed=0)
    hand = [_dense_prefill(jx, p) for p in prompts]
    serial = [_serial(jx, t0, c, N_NEW) for t0, c in hand]
    streams = []
    for api in (jx, tx):
        pool = BlockPool(16, BLOCK)
        c = api.cache(4, 16)
        toks, next_tok, slot_of = {}, [0] * 4, {}
        for r, slot in ((0, 0), (1, 2)):
            c, _ = _join(api, c, pool, hand[r][1], slot,
                         len(prompts[r]) + N_NEW - 1)
            toks[slot], next_tok[slot], slot_of[r] = ([hand[r][0]],
                                                      hand[r][0], slot)
        for step in range(N_NEW + 2):
            if step == 2:                      # late join into a free slot
                c, _ = _join(api, c, pool, hand[2][1], 1,
                             len(prompts[2]) + N_NEW - 1)
                toks[1], next_tok[1], slot_of[2] = ([hand[2][0]],
                                                    hand[2][0], 1)
            active = [s for s in toks if len(toks[s]) < N_NEW]
            if not active:
                break
            lg, c = api.decode(c, next_tok)
            nxt = _argmax(lg)
            for s in active:
                toks[s].append(nxt[s])
                next_tok[s] = nxt[s]
        streams.append([toks[slot_of[i]] for i in range(3)])
    assert streams[0] == serial
    assert streams[1] == serial


def test_paged_take_roundtrip_matches_jax(pair):
    """paged_cache_take extracts the same dense batch-1 cache as JAX's;
    re-joined into a fresh paged cache it decodes on exactly like the
    serial cache; the freed pages return to the pool."""
    jx, tx = pair
    ids = _prompts(jx.cfg, (29,), seed=1)[0]
    t0, dense = _dense_prefill(jx, ids)
    serial = _serial(jx, t0, dense, 6)
    taken = []
    for api in (jx, tx):
        pool = BlockPool(12, BLOCK)
        c = api.cache(3, 12)
        c, blocks = _join(api, c, pool, dense, 1, 29 + 6)
        toks, next_tok = [t0], [0, t0, 0]
        for _ in range(2):
            lg, c = api.decode(c, next_tok)
            toks.append(_argmax(lg)[1])
            next_tok[1] = toks[-1]
        if api is tx:
            out = TM.paged_cache_take(api.cfg, c, 1)
            c = TM.paged_cache_clear_slot(c, 1)
            taken.append(cache_to_numpy(api.cfg, out))
            assert (c["block_tab"][1] == -1).all()
        else:
            out = JM.paged_cache_take(api.cfg, c, 1)
            taken.append(jax.tree.map(np.asarray, out))
        pool.free(blocks)
        pool.check()
        assert pool.used_count == 0
    a, b = taken
    assert np.array_equal(a["cur"], b["cur"])
    assert np.array_equal(a["kv_pos"], b["kv_pos"])
    for x, y in zip(a["blocks"]["p0"], b["blocks"]["p0"]):
        assert np.abs(x - y).max() <= 1e-5
    # the port's parked cache re-joins and continues like the serial one
    back = cache_from_numpy(tx.cfg, b, device="cpu")
    pool = BlockPool(12, BLOCK)
    c = tx.cache(2, 12)
    ids2 = pool.alloc(pool.blocks_for(29 + 6))
    c = TM.paged_cache_join(tx.cfg, c, back, 0,
                            torch.tensor(pad_block_table(ids2, NBT),
                                         dtype=torch.int32))
    toks, next_tok = list(toks), [toks[-1], 0]
    for _ in range(3):
        lg, c = tx.decode(c, next_tok)
        toks.append(_argmax(lg)[0])
        next_tok[0] = toks[-1]
    assert toks == serial


# ---------------------------------------------------------------------------
# page surgery: copy, gather, adopt, clear
# ---------------------------------------------------------------------------

def test_page_surgery_matches_jax(pair):
    jx, tx = pair
    rng = np.random.default_rng(11)
    jc = jax.tree.map(np.array, JM.init_paged_cache(jx.cfg, 3, 10,
                                                      MAX_LEN, BLOCK))
    k, v = jc["blocks"]["p0"]
    jc["blocks"]["p0"] = (rng.normal(size=k.shape).astype(np.float32),
                          rng.normal(size=v.shape).astype(np.float32))
    jc["kv_pos"] = rng.integers(-1, 90, size=jc["kv_pos"].shape
                                ).astype(np.int32)
    jc["block_tab"][1, :3] = [4, 7, 2]
    jc["cur"][:] = [5, 40, 0]

    def both(jfn, tfn):
        j = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, jc)))
        t = cache_to_numpy(tx.cfg, tfn(cache_from_numpy(tx.cfg, jc, device="cpu")))
        for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(t)):
            assert np.array_equal(a, b)

    cfg, tcfg = jx.cfg, tx.cfg
    both(lambda c: JM.paged_copy_block(cfg, c, 7, 9),
         lambda c: TM.paged_copy_block(tcfg, c, 7, 9))
    ids = np.array([4, 7, -1, 2], np.int32)
    both(lambda c: JM.paged_clear_rows(c, jnp.asarray(ids)),
         lambda c: TM.paged_clear_rows(c, torch.tensor(ids)))
    both(lambda c: JM.paged_cache_clear_slot(c, 1),
         lambda c: TM.paged_cache_clear_slot(c, 1))
    # gather a payload, then adopt it into another slot: rows 0-1 copied,
    # row 2 cleared (growth), the rest untouched
    jpay = JM.paged_gather_blocks(cfg, jax.tree.map(jnp.asarray, jc),
                                  jnp.asarray(pad_block_table([4, 7, 2], NBT)))
    tpay = TM.paged_gather_blocks(
        tcfg, cache_from_numpy(tcfg, jc, device="cpu"),
        torch.tensor(pad_block_table([4, 7, 2], NBT), dtype=torch.int32))
    assert np.array_equal(np.asarray(jpay["kv_pos"]), tpay["kv_pos"].numpy())
    assert np.array_equal(np.asarray(jpay["blocks"]["p0"][0]),
                          tpay["k"].numpy())
    tab = pad_block_table([3, 5, 8], NBT)
    idx = np.arange(NBT)
    cm, km = (idx < 2), (idx == 2)
    both(lambda c: JM.paged_adopt_blocks(
        cfg, c, jpay, 2, jnp.asarray(tab), jnp.asarray(cm), jnp.asarray(km),
        29),
        lambda c: TM.paged_adopt_blocks(
            tcfg, c, tpay, 2, torch.tensor(tab, dtype=torch.int32),
            torch.tensor(cm), torch.tensor(km), 29))


# ---------------------------------------------------------------------------
# the dense (padded) family: tests/test_real_plane.py:76-154, and the
# sliding-window ring on reduced h2o-danube-3-4b (window 64 < MAX_LEN)
# ---------------------------------------------------------------------------

def _pair(name):
    """(JAX cfg, JAX params, port cfg, port params) of one reduced model;
    "jamba-hybrid" is reduced jamba with the layer pattern (SSM, DENSE)
    and so no MoE layer."""
    arch = "jamba-v0.1-52b" if name == "jamba-hybrid" else name
    cfg = get_arch(arch, reduced=True)
    tcfg = t_get_arch(arch, reduced=True)
    if name == "jamba-hybrid":
        cfg = dataclasses.replace(cfg, layer_pattern=(JLK.SSM, JLK.DENSE))
        tcfg = dataclasses.replace(tcfg, layer_pattern=(TLK.SSM, TLK.DENSE))
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module", params=["deepseek-7b", "h2o-danube-3-4b"])
def dense_pair(request):
    """(JAX cfg, JAX params, port cfg, port params) of one model."""
    return _pair(request.param)


@pytest.fixture(scope="module", params=["deepseek-7b", "h2o-danube-3-4b",
                                        "mamba2-370m", "jamba-hybrid"])
def model_pair(request):
    """As dense_pair, over attention, SSM and hybrid layer stacks."""
    return _pair(request.param)


def _layer_leaves(c):
    """The per-layer cache entries of a JAX-layout cache, as a list."""
    return jax.tree.leaves((c.get("prefix", ()), c["blocks"]))


def _jax_steps(cfg):
    return (jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c)),
            jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c)))


def _assert_entries_close(tcfg, jc, tc):
    """Every layer's K/V rows and conv tails within 1e-5, its SSM state
    within 1e-5 of the state's largest magnitude (a state sums the whole
    prompt, up to about 15 here, where fp32 resolves about 1e-6)."""
    j = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert set(j) == set(tc)
    for name in ("k", "v", "conv_x", "conv_bc", "ssm"):
        if name not in tc:
            continue
        ref = j[name]
        tol = 1e-5 * max(1.0, float(ref.abs().max())) if name == "ssm" \
            else 1e-5
        assert float((tc[name] - ref).abs().max()) <= tol, name


def _assert_dense_match(tcfg, jc, tc):
    """Same cursors and positions, every layer's entries close."""
    t = cache_to_numpy(tcfg, tc)
    assert np.array_equal(np.asarray(jc["cur"]), t["cur"])
    assert np.array_equal(np.asarray(jc["kv_pos"]), t["kv_pos"])
    _assert_entries_close(tcfg, jc, tc)


def test_dense_cache_bridge_roundtrip(model_pair):
    """A dense batch-B cache (the SWA ring's S_buf included; SSM states
    and conv tails) crosses the bridge both ways unchanged."""
    cfg, _p, tcfg, _tp = model_pair
    jc = jax.tree.map(np.array, JM.init_cache(cfg, 3, MAX_LEN))
    rng = np.random.default_rng(2)
    S = TM.kv_buffer_len(tcfg, MAX_LEN) if TM._has_attn_cache(tcfg) else 1
    assert jc["kv_pos"].shape[1] == S
    jc["blocks"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jc["blocks"])
    jc["kv_pos"] = rng.integers(-1, 90, size=jc["kv_pos"].shape
                                ).astype(np.int32)
    jc["cur"][:] = [3, 70, 0]
    back = cache_to_numpy(tcfg, cache_from_numpy(tcfg, jc, device="cpu"))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    t = TM.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    z = jax.tree.map(np.asarray, JM.init_cache(cfg, 3, MAX_LEN))
    for a, b in zip(jax.tree.leaves(z),
                    jax.tree.leaves(cache_to_numpy(tcfg, t))):
        assert np.array_equal(a, b)


def test_attn_decode_and_extend_match_jax(dense_pair):
    """One dense attention sub-layer on a cache with history (a wrapped
    ring for SWA): the chunk extend (written before it attends) and the
    single-token decode give JAX's outputs and JAX's cache writes."""
    from repro.models import blocks as JB
    from repro_torch.models import blocks as TB
    cfg, jparams, tcfg, tparams = dense_pair
    S = TM.kv_buffer_len(tcfg, MAX_LEN)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(3)
    B = 2
    kc = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    vc = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    cur = np.array([80, 7], np.int32)              # row 0 wrapped if SWA
    kvp = np.full((B, S), -1, np.int32)
    for b, c in enumerate(cur):
        for t in range(max(c - S, 0), c):
            kvp[b, t % S] = t
    Sc = 12
    positions = (cur[:, None] + np.arange(Sc)).astype(np.int32)
    x = rng.normal(size=(B, Sc, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["p0"]["attn"])
    tp = tparams["layers"][0]["attn"]
    jo, (jk, jv, jkvp) = jax.jit(JB.attn_extend, static_argnums=2)(
        jp, jnp.asarray(x), cfg, *(jnp.asarray(a) for a in
                                   (kc, vc, kvp, positions)))
    t = [torch.tensor(a) for a in (kc, vc, kvp)]
    to = TB.attn_extend(tp, torch.tensor(x), tcfg, *t,
                        torch.tensor(positions))
    assert np.abs(np.asarray(jo) - to.numpy()).max() <= LOGIT_TOL
    for j, tt in ((jk, t[0]), (jv, t[1]), (jkvp, t[2])):
        assert np.abs(np.asarray(j) - tt.numpy()).max() <= 1e-5
    pos = (cur + Sc).astype(np.int32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jo, (jk, jv, jkvp) = jax.jit(JB.attn_decode, static_argnums=2)(
        jp, jnp.asarray(x1), cfg, jk, jv, jkvp, jnp.asarray(pos))
    to = TB.attn_decode(tp, torch.tensor(x1), tcfg, *t, torch.tensor(pos))
    assert np.abs(np.asarray(jo) - to.numpy()).max() <= LOGIT_TOL
    for j, tt in ((jk, t[0]), (jv, t[1]), (jkvp, t[2])):
        assert np.abs(np.asarray(j) - tt.numpy()).max() <= 1e-5


def test_prefill_chunk_and_decode_step_match_jax(model_pair):
    """Batch-2 chunked prefill past the window (SSD: in chunks shorter
    than the scan's, padded), then batched decode, in lockstep with JAX:
    logits within 1e-4, caches equal."""
    cfg, jparams, tcfg, tparams = model_pair
    jchunk, jdecode = _jax_steps(cfg)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, MAX_LEN)
    tc = TM.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    for i in range(0, 80, 16):
        jl, jc = jchunk(jparams, jnp.asarray(ids[:, i:i + 16]), jc)
        tl, tc = TM.prefill_chunk(tcfg, tparams, torch.tensor(ids[:, i:i + 16]),
                                  tc)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() <= LOGIT_TOL
    _assert_dense_match(tcfg, jc, tc)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.tensor(tok), tc)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() <= LOGIT_TOL
        assert _argmax(np.asarray(jl)) == _argmax(tl.numpy())
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    _assert_dense_match(tcfg, jc, tc)


def test_padded_batched_continuous_decode_matches_serial(model_pair):
    """tests/test_real_plane.py:76 on the port: requests joining a padded
    batch cache at different steps generate exactly the JAX serial
    decode's tokens (prompts past the window on the SWA model; a joined
    SSM row carries its prefill's state and conv tails)."""
    cfg, jparams, tcfg, tparams = model_pair
    jchunk, jdecode = _jax_steps(cfg)
    prompts = _prompts(cfg, (23, 70, 11), seed=0)
    serial, hand = [], []
    for ids in prompts:
        c = JM.init_cache(cfg, 1, MAX_LEN)
        for i in range(0, len(ids), 16):
            lg, c = jchunk(jparams, jnp.asarray([ids[i:i + 16]], jnp.int32), c)
        t0 = int(jnp.argmax(lg[0]))
        hand.append((t0, cache_from_numpy(tcfg, jax.tree.map(np.asarray, c),
                                          device="cpu")))
        toks = [t0]
        for _ in range(N_NEW - 1):
            lg, c = jdecode(jparams, jnp.asarray([[toks[-1]]], jnp.int32), c)
            toks.append(int(jnp.argmax(lg[0])))
        serial.append(toks)
    B = 4
    bc = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    toks, next_tok, slot_of = {}, [0] * B, {}
    for slot, r in ((0, 0), (2, 1)):
        bc = TM.cache_join(bc, hand[r][1], slot)
        toks[slot], next_tok[slot], slot_of[r] = [hand[r][0]], hand[r][0], slot
    for step in range(N_NEW + 2):
        if step == 2:                          # late join into a free slot
            bc = TM.cache_join(bc, hand[2][1], 1)
            toks[1], next_tok[1], slot_of[2] = [hand[2][0]], hand[2][0], 1
        active = [s for s in toks if len(toks[s]) < N_NEW]
        if not active:
            break
        lg, bc = TM.decode_step(tcfg, tparams,
                                torch.tensor(next_tok)[:, None], bc)
        nxt = _argmax(lg.numpy())
        for s in active:                       # inactive slots step garbage
            toks[s].append(nxt[s])
            next_tok[s] = nxt[s]
    assert [toks[slot_of[i]] for i in range(3)] == serial


def test_cache_take_roundtrip_matches_jax(model_pair):
    """tests/test_real_plane.py:127 on the port: cache_take extracts the
    same batch-1 cache as JAX's and it continues like the serial cache;
    the taken cache is a copy (later steps of the batch do not touch
    it)."""
    cfg, jparams, tcfg, tparams = model_pair
    jchunk, jdecode = _jax_steps(cfg)
    ids = _prompts(cfg, (69,), seed=1)[0]
    c = JM.init_cache(cfg, 1, MAX_LEN)
    for i in range(0, len(ids), 16):
        lg, c = jchunk(jparams, jnp.asarray([ids[i:i + 16]], jnp.int32), c)
    t0 = int(jnp.argmax(lg[0]))
    serial, sc = [t0], c
    for _ in range(5):
        lg, sc = jdecode(jparams, jnp.asarray([[serial[-1]]], jnp.int32), sc)
        serial.append(int(jnp.argmax(lg[0])))
    jb = JM.cache_join(JM.init_cache(cfg, 3, MAX_LEN), c, 1)
    tb = TM.cache_join(TM.init_cache(tcfg, 3, MAX_LEN, device="cpu"),
                       cache_from_numpy(tcfg, jax.tree.map(np.asarray, c),
                                        device="cpu"), 1)
    toks, next_tok = [t0], [0, t0, 0]
    for _ in range(2):
        jl, jb = jdecode(jparams, jnp.asarray(next_tok, jnp.int32)[:, None],
                         jb)
        tl, tb = TM.decode_step(tcfg, tparams, torch.tensor(next_tok)[:, None],
                                tb)
        toks.append(_argmax(tl.numpy())[1])
        next_tok[1] = toks[-1]
    jt = jax.tree.map(np.asarray, JM.cache_take(jb, 1))
    tt = TM.cache_take(tb, 1)
    snap = cache_to_numpy(tcfg, tt)
    assert np.array_equal(jt["cur"], snap["cur"])
    assert np.array_equal(jt["kv_pos"], snap["kv_pos"])
    _assert_entries_close(tcfg, jt, tt)
    TM.decode_step(tcfg, tparams, torch.tensor(next_tok)[:, None], tb)
    for a, b in zip(_layer_leaves(snap),
                    _layer_leaves(cache_to_numpy(tcfg, tt))):
        assert np.array_equal(a, b)                  # a copy, not a view
    for _ in range(3):
        tl, tt = TM.decode_step(tcfg, tparams, torch.tensor([[toks[-1]]]), tt)
        toks.append(_argmax(tl.numpy())[0])
    assert toks == serial


def test_paged_layout_refuses_ssm_layers():
    """SSM state has no page form: a config without attention cannot be
    paged (ValueError, as JAX's paged_layout); a hybrid pages its
    attention layers, with its SSM state per slot beside the pages, to
    the same table geometry as JAX's."""
    for arch in ("mamba2-370m",):
        with pytest.raises(ValueError):
            JM.paged_layout(get_arch(arch, reduced=True), MAX_LEN, BLOCK)
        with pytest.raises(ValueError):
            TM.paged_layout(t_get_arch(arch, reduced=True), MAX_LEN, BLOCK)
    hybrid = dataclasses.replace(t_get_arch("jamba-v0.1-52b", reduced=True),
                                 layer_pattern=(TLK.SSM, TLK.DENSE))
    jhybrid = dataclasses.replace(get_arch("jamba-v0.1-52b", reduced=True),
                                  layer_pattern=(JLK.SSM, JLK.DENSE))
    assert TM.paged_layout(hybrid, MAX_LEN, BLOCK) == (NBT, BLOCK)
    assert JM.paged_layout(jhybrid, MAX_LEN, BLOCK) == (NBT, BLOCK)


def test_ssm_cache_stacks_by_kind():
    """K/V stack over the attention layers only, SSM state (fp32) and
    conv tails (cache dtype) over the SSM layers only; the index maps
    every layer to its own stack."""
    hybrid = dataclasses.replace(t_get_arch("jamba-v0.1-52b", reduced=True),
                                 layer_pattern=(TLK.SSM, TLK.DENSE))
    c = TM.init_cache(hybrid, 2, MAX_LEN, dtype=torch.bfloat16, device="cpu")
    assert TM.stack_index(hybrid) == [(TLK.SSM, 0), (TLK.DENSE, 0)]
    assert c["k"].shape[:3] == (1, 2, MAX_LEN)
    sc = hybrid.ssm
    nh = hybrid.d_model * sc.expand // sc.head_dim
    assert c["ssm"].shape == (1, 2, nh, sc.head_dim, sc.d_state)
    assert c["ssm"].dtype == torch.float32
    assert c["conv_x"].dtype == c["conv_bc"].dtype == torch.bfloat16
    m = TM.init_cache(t_get_arch("mamba2-370m", reduced=True), 2, MAX_LEN,
                      device="cpu")
    assert "k" not in m and m["kv_pos"].shape == (2, 1)
    assert m["ssm"].shape[0] == 2
