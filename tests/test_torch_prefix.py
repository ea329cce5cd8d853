"""PyTorch port: page-native P/D prefill, the block-granular `PageHandoff`
and prefix sharing (`RealSBSServer(prefix_cache=True)`), against the JAX
package on reduced deepseek-7b with the JAX weights bridged over, in
fp32 on the CPU:

  * the gates of tests/test_page_sharing.py (an exact repeat runs no
    prefill chunk; shared-prefix traffic is token-exact and every pool
    drains after eviction) and tests/test_preemption.py (the decode
    admission credit for a resident prefix);
  * the P/D server under sbs, sbs-la and immediate against the JAX
    server on the same requests: tokens and `prefix_stats()`;
  * the engines' edges: a claim that differs from the scheduler's
    credit raises; a resident that joined by `PageHandoff` is preempted
    and re-admitted, or drained while a step is in flight, token-exact;
    a published tail block stays frozen at the prompt's length, although
    the port writes K/V in place; the unified plane with
    `prefix_cache=True` reports what the reference reports.

Token streams must match exactly.
"""
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import ServingConfig as JServingConfig
from repro.models import model as JM

from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import DecodeDPState, DispatchCommand, Request
from repro_torch.models.model import (
    init_paged_cache, paged_cache_join, paged_gather_blocks,
)
from repro_torch.serving import real_engine as RE
from repro_torch.serving.plane import ASYNC
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, PageHandoff, RealDecodeEngine,
    RealPrefillEngine,
)
from repro_torch.serving.server import RealSBSServer

MAX_LEN = 96
BLOCK = 16
PREFIX = 48             # shared system prefix: 3 whole pages


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Oracle:
    """The JAX seed path: chunked dense prefill, then serial decode."""

    def __init__(self):
        cfg = get_arch("deepseek-7b", reduced=True)
        self.cfg = cfg
        self.params = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        self._chunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
        self._decode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))

    def prefill(self, ids):
        cache = JM.init_cache(self.cfg, 1, MAX_LEN)
        for i in range(0, len(ids), 16):
            lg, cache = self._chunk(self.params,
                                    jnp.asarray([ids[i:i + 16]], jnp.int32),
                                    cache)
        return int(jnp.argmax(lg[0])), cache

    def tokens(self, ids, n):
        t0, cache = self.prefill(ids)
        toks = [t0]
        for _ in range(n - 1):
            lg, cache = self._decode(self.params,
                                     jnp.asarray([[toks[-1]]], jnp.int32),
                                     cache)
            toks.append(int(jnp.argmax(lg[0])))
        return toks


@pytest.fixture(scope="module")
def oracle():
    return _Oracle()


@pytest.fixture(scope="module")
def port(oracle):
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    return tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, oracle.params), device="cpu")


def _req(rid, tokens, t=0.0, out=3):
    return Request(rid=rid, arrival_time=t, input_len=len(tokens),
                   output_len=out, tokens=tuple(tokens))


def _share_scfg(**kw):
    # ONE prefill instance: SBS staggers dispatch windows per instance,
    # so with several a repeat only probabilistically lands on the engine
    # holding its pages (tests/test_page_sharing.py:200-204)
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=2,
                num_decode_instances=1, decode_dp_per_instance=2,
                chunk_size=32, t_default=0.05, l_net=0.001,
                max_batch_per_dp=4, block_size=BLOCK, n_limit=64)
    base.update(kw)
    return base


def _drain_pools(srv):
    """Evict every binder; every prefill and decode pool must be empty."""
    for eng in srv.engines:
        if eng.binder is not None:
            assert eng.binder.ensure_free(eng.pool.num_blocks - 1)
        eng.pool.check()
        assert eng.pool.used_count == 0
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            assert st.binder.ensure_free(st.pool.num_blocks - 1)
            st.pool.check()
            assert st.pool.used_count == 0


# ---------------------------------------------------------------------------
# tests/test_page_sharing.py's real-plane gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def share_server(port):
    tcfg, tparams = port
    return RealSBSServer(tcfg, tparams, ServingConfig(**_share_scfg()),
                         scheduler="sbs", max_len=MAX_LEN, max_new=3,
                         prefix_cache=True, device="cpu")


def test_full_prefix_hit_runs_zero_chunks(oracle, port, share_server):
    """An exact repeat of a published prompt computes NOTHING on the
    prefill plane: the claim covers the whole prompt, the stored first
    token replays, and decode continues token-identically."""
    tcfg, _ = port
    srv = share_server
    rng = random.Random(21)
    prompt = [rng.randrange(tcfg.vocab_size) for _ in range(40)]

    first = srv.serve([_req(0, prompt)], timeout=120)
    s1 = srv.prefix_stats()
    again = srv.serve([_req(1, prompt)], timeout=120)
    s2 = srv.prefix_stats()

    assert len(first) == 1 and len(again) == 1
    assert first[0].tokens == oracle.tokens(prompt, 3)
    assert again[0].tokens == first[0].tokens
    assert s2["prefill_chunks_run"] == s1["prefill_chunks_run"]
    assert s2["prefill_full_hits"] == s1["prefill_full_hits"] + 1
    assert s2["prefix_hit_tokens"] >= s1["prefix_hit_tokens"] + len(prompt)


def test_shared_prefix_serving_token_exact_and_drains(oracle, port,
                                                      share_server):
    """Multi-tenant waves (a common 48-token prefix and an exact repeat)
    through the whole server: token-exact against the JAX serial oracle,
    with pages really shared and copied on write; after evicting the
    caches every pool is empty — nothing leaked."""
    tcfg, _ = port
    srv = share_server
    rng = random.Random(9)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(PREFIX)]
    prompts = [prefix + [rng.randrange(tcfg.vocab_size)
                         for _ in range(8 + i)] for i in range(4)]
    prompts.append(list(prompts[0]))            # exact repeat
    s0 = srv.prefix_stats()
    # two waves so wave 2 claims pages wave 1 published
    gens = list(srv.serve([_req(100 + i, p, t=i * 0.05)
                           for i, p in enumerate(prompts)], timeout=120))
    gens += srv.serve([_req(200 + i, p, t=i * 0.05)
                       for i, p in enumerate(prompts)], timeout=120)
    s1 = srv.prefix_stats()

    assert len(gens) == 2 * len(prompts)
    want = {i: oracle.tokens(p, 3) for i, p in enumerate(prompts)}
    for g in gens:
        assert g.tokens == want[g.rid % 100], g.rid
    assert s1["prefix_hit_tokens"] > s0["prefix_hit_tokens"]
    assert s1["decode_blocks_shared"] > s0["decode_blocks_shared"]
    assert s1["decode_cow_copies"] > s0["decode_cow_copies"]
    _drain_pools(srv)


def test_published_tail_block_stays_frozen(oracle, port):
    """The port writes K/V in place, so a page a binder has published
    must never be a write target again.  After a serve, the partial tail
    block every binder holds for each prompt still has exactly the
    prompt's positions (then -1) and the prompt's K/V: the first decode
    write went to the row's private copy (the eager copy-on-write), not
    into the published block."""
    tcfg, tparams = port
    srv = RealSBSServer(tcfg, tparams, ServingConfig(**_share_scfg()),
                        scheduler="sbs-la", max_len=MAX_LEN, max_new=5,
                        prefix_cache=True, device="cpu")
    rng = random.Random(4)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(PREFIX)]
    prompts = [prefix + [rng.randrange(tcfg.vocab_size) for _ in range(n)]
               for n in (5, 11, 27)]
    gens = srv.serve([_req(i, p, t=i * 0.05, out=5)
                      for i, p in enumerate(prompts)], timeout=120)
    assert len(gens) == len(prompts)
    holders = [(eng.pool, eng.cache) for eng in srv.engines]
    holders += [(st.pool, st.cache) for eng in srv.decode_engines
                for st in eng._dp.values() if st.cache is not None]
    checked = 0
    for p in prompts:
        L = len(p)
        lw, n = L // BLOCK, L % BLOCK
        _t0, dense = oracle.prefill(p)
        dense = cache_from_numpy(tcfg, jax.tree.map(np.asarray, dense),
                                 device="cpu")
        for pool, cache in holders:
            blk = pool.lookup(tuple(p))
            if blk is None:
                continue
            checked += 1
            want = list(range(lw * BLOCK, L)) + [-1] * (BLOCK - n)
            assert cache["kv_pos"][blk].tolist() == want
            for name in ("k", "v"):
                torch.testing.assert_close(
                    cache[name][:, blk, :n],
                    dense[name][:, 0, lw * BLOCK:L], rtol=1e-4, atol=1e-4)
    # the prefill binder and at least one decode binder per prompt
    assert checked >= 2 * len(prompts)


def test_reused_prefill_pages_are_cleared(oracle, port):
    """A page a prefill engine hands out may still hold a previous
    tenant's positions (any earlier prompt's, at any logical index):
    staging must clear them, or the kernels' walk would read that
    tenant's keys as history.  Every pool page starts out holding
    positions 0-15 here; a 40-token prompt's partial third page must end
    with its own 8 positions and -1, and its tokens be exact."""
    tcfg, tparams = port
    srv = RealSBSServer(tcfg, tparams, ServingConfig(**_share_scfg()),
                        scheduler="sbs-la", max_len=MAX_LEN, max_new=4,
                        prefix_cache=True, device="cpu")
    eng = srv.engines[0]
    eng.cache["kv_pos"][1:] = torch.arange(BLOCK, dtype=torch.int32)
    tables = {}
    inner = eng._stage

    def stage(req, ctx):
        ok = inner(req, ctx)
        if ok:
            tables[req.rid] = list(ctx.table)
        return ok
    eng._stage = stage
    rng = random.Random(12)
    prompt = [rng.randrange(tcfg.vocab_size) for _ in range(40)]
    gens = srv.serve([_req(0, prompt, out=4)], timeout=120)
    assert gens[0].tokens == oracle.tokens(prompt, 4)
    tail = tables[0][2]
    assert eng.cache["kv_pos"][tail].tolist() == (list(range(32, 40))
                                                  + [-1] * 8)


# ---------------------------------------------------------------------------
# tests/test_preemption.py: admission credit for a resident prefix
# ---------------------------------------------------------------------------

def test_free_kv_tokens_credits_shared_prefix(port):
    """A prompt whose block-aligned prefix is resident in the DP's binder
    is credited those pages — they will be pointed at, never
    allocated."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=4,
                      block_size=BLOCK, device="cpu")
    eng = RealDecodeEngine(0, [0], spec, KVHandoffBus(), share_prefix=True)
    dp = eng._dp[0]
    rng = random.Random(11)
    prefix = tuple(rng.randrange(tcfg.vocab_size) for _ in range(2 * BLOCK))
    blocks = dp.pool.alloc(2)
    dp.binder.insert(prefix, blocks, first_token=None)
    dp.pool.free(blocks)            # engine refs dropped; binder's remain
    base = dp.pool.free_count * BLOCK

    prompt = list(prefix) + [rng.randrange(tcfg.vocab_size) for _ in range(8)]
    assert eng.free_kv_tokens(0) == base
    assert eng.free_kv_tokens(0, tokens=prompt) == base + 2 * BLOCK
    # a prompt with no resident prefix gets no credit
    cold = [rng.randrange(tcfg.vocab_size) for _ in range(2 * BLOCK)]
    assert eng.free_kv_tokens(0, tokens=cold) == base


# ---------------------------------------------------------------------------
# the P/D server against the JAX server, each scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def specs(oracle, port):
    """One spec per package for the parity serves (1 decode DP of 8 rows'
    memory: no pool pressure, so no eviction depends on timing)."""
    from repro.serving.real_engine import EngineSpec as JEngineSpec
    tcfg, tparams = port
    scfg = ServingConfig(**_share_scfg(decode_dp_per_instance=1,
                                       max_batch_per_dp=8))
    kw = dict(max_len=MAX_LEN, max_batch=8, max_new=4, block_size=BLOCK,
              decode_slots=scfg.resolved_decode_slots)
    return (JEngineSpec(oracle.cfg, oracle.params, **kw),
            EngineSpec(tcfg, tparams, device="cpu", **kw))


def _parity_waves(vocab):
    """Wave 1: one seed prompt (the 48-token prefix + 10).  Wave 2: the
    seed again (a full hit) and four prompts that share only the prefix
    with it and with each other, so every claim and every decode-side
    share resolves against wave 1's pages whatever order wave 2 runs in;
    10 tokens are left after a 48-token claim, so no prompt's prefill
    splits across passes."""
    rng = random.Random(17)
    prefix = [rng.randrange(vocab) for _ in range(PREFIX)]
    seed = prefix + [rng.randrange(vocab) for _ in range(10)]
    wave2 = [seed] + [prefix + [rng.randrange(vocab) for _ in range(10)]
                      for _ in range(4)]
    return [seed], wave2


@pytest.mark.parametrize("scheduler", ["sbs", "sbs-la", "immediate"])
def test_pd_prefix_serve_matches_jax_server(port, oracle, specs, scheduler):
    """Page-native P/D with prefix_cache=True: the port's server and the
    JAX server serve the same two waves with the same tokens and the same
    reuse counters (`immediate` shares on the decode side only).  Prefill
    chunk counts depend on how passes batch prompts only under
    `immediate`, which computes every prompt whole."""
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    tcfg, tparams = port
    jspec, tspec = specs
    base = _share_scfg(decode_dp_per_instance=1, max_batch_per_dp=8)
    wave1, wave2 = _parity_waves(tcfg.vocab_size)
    jsrv = JServer(oracle.cfg, oracle.params, JServingConfig(**base),
                   scheduler=scheduler, spec=jspec, prefix_cache=True)
    tsrv = RealSBSServer(tcfg, tparams, ServingConfig(**base),
                         scheduler=scheduler, spec=tspec, prefix_cache=True)
    out, stats = {}, {}
    for name, srv, R in (("jax", jsrv, JRequest), ("port", tsrv, Request)):
        gens = []
        for w, wave in enumerate((wave1, wave2)):
            gens += srv.serve([R(rid=10 * w + i, arrival_time=0.05 * i,
                                 input_len=len(p), output_len=3 + i % 2,
                                 tokens=tuple(p))
                               for i, p in enumerate(wave)], timeout=120)
        out[name] = {g.rid: g.tokens for g in gens}
        stats[name] = srv.prefix_stats()
    assert sorted(out["port"]) == [0, 10, 11, 12, 13, 14]
    assert out["port"] == out["jax"]
    assert out["port"][10] == out["port"][0]          # the full hit replays
    chunks = {k: s.pop("prefill_chunks_run") for k, s in stats.items()}
    assert stats["port"] == stats["jax"]
    # decode: the seed's pages (3 + tail) published at its join, then 3
    # prefix pages per wave-2 prompt and the whole seed for its repeat;
    # every join copies its partial tail on write
    assert stats["port"]["decode_blocks_shared"] == 4 + 4 * 3
    assert stats["port"]["decode_cow_copies"] == 6
    if scheduler == "immediate":
        assert stats["port"]["prefix_hit_tokens"] == 0
        assert min(chunks.values()) >= 6 * 2
    else:
        # one full hit; four 48-token claims, each leaving one chunk;
        # the seed alone in two (32 + 26)
        assert stats["port"]["prefill_full_hits"] == 1
        assert stats["port"]["prefix_hit_tokens"] == 58 + 4 * PREFIX
        assert chunks == {"jax": 2 + 4, "port": 2 + 4}
    _drain_pools(tsrv)


def test_unified_prefix_cache_stats_match_reference(port, oracle):
    """`prefix_cache=True` on the unified plane: the decode-side binders
    exist but nothing on that plane claims from or inserts into them, so
    the tokens and `prefix_stats()` equal the reference's (all zero)."""
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    tcfg, tparams = port
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                chunk_size=16, t_default=0.05, l_net=0.001,
                max_batch_per_dp=4, block_size=BLOCK, mixed_batch=True,
                mixed_chunk=32)
    rng = random.Random(3)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(32)]
    prompts = [prefix + [rng.randrange(tcfg.vocab_size) for _ in range(n)]
               for n in (7, 20)]
    prompts.append(list(prompts[0]))
    out, stats = {}, {}
    for name, srv, R in (
            ("jax", JServer(oracle.cfg, oracle.params,
                            JServingConfig(**base), scheduler="sbs-la",
                            max_len=MAX_LEN, max_new=4, prefix_cache=True),
             JRequest),
            ("port", RealSBSServer(tcfg, tparams, ServingConfig(**base),
                                   scheduler="sbs-la", max_len=MAX_LEN,
                                   max_new=4, prefix_cache=True,
                                   device="cpu"), Request)):
        gens = srv.serve([R(rid=i, arrival_time=0.05 * i, input_len=len(p),
                            output_len=4, tokens=tuple(p))
                          for i, p in enumerate(prompts)], timeout=120)
        out[name] = {g.rid: g.tokens for g in gens}
        stats[name] = srv.prefix_stats()
    assert len(out["port"]) == 3 and out["port"] == out["jax"]
    assert stats["port"] == stats["jax"]


@pytest.mark.parametrize("mixed", [False, True], ids=["pd", "mixed"])
def test_prefix_cache_needs_a_paged_deployment(oracle, port, mixed):
    """prefix_cache=True on a padded deployment raises ValueError in both
    packages."""
    from repro.serving.server import RealSBSServer as JServer
    tcfg, tparams = port
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                max_batch_per_dp=4, block_size=0, mixed_batch=mixed)
    with pytest.raises(ValueError, match="paged deployment"):
        JServer(oracle.cfg, oracle.params, JServingConfig(**base),
                max_len=MAX_LEN, prefix_cache=True)
    with pytest.raises(ValueError, match="paged deployment"):
        RealSBSServer(tcfg, tparams, ServingConfig(**base), max_len=MAX_LEN,
                      prefix_cache=True, device="cpu")


# ---------------------------------------------------------------------------
# engine edges: the claim check, PageHandoff residents preempted or drained
# ---------------------------------------------------------------------------

def test_claim_mismatch_raises(port):
    """The engine's claim must equal the hit the scheduler credited: a
    request whose cached prefix the scheduler did not credit raises at
    enqueue; one it credited claims exactly those pages."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4,
                      block_size=BLOCK, device="cpu")
    eng = RealPrefillEngine(0, [0], 32, spec, KVHandoffBus(),
                            page_native=True, share_prefix=True)
    rng = random.Random(2)
    prompt = [rng.randrange(tcfg.vocab_size) for _ in range(40)]
    blocks = eng.pool.alloc(2)
    eng.binder.insert(prompt[:2 * BLOCK], blocks)
    eng.pool.free(blocks)
    # credited the 32 cached tokens: granted the last 8
    r = _req(0, prompt)
    r.remaining_prefill = 0
    eng.enqueue(DispatchCommand(0, {0: [(r, 8)]}), 0.0)
    ctx = eng._pctx[0]
    assert (ctx.claimed, ctx.table, ctx.slot) == (32, blocks, None)
    assert eng.pool.refcount(blocks[0]) == 2        # binder + claim
    # credited nothing: granted 32, 8 left
    r = _req(1, prompt)
    r.remaining_prefill = 8
    with pytest.raises(RuntimeError, match="scheduler credited a 0-token"):
        eng.enqueue(DispatchCommand(0, {0: [(r, 32)]}), 0.0)


def _handoff(oracle, tcfg, spec, ids):
    """A `PageHandoff` of the prompt `ids` as a page-native prefill
    engine publishes it: the JAX prefill's cache scattered into pages,
    then only the prompt's pages gathered (nbt-padded)."""
    first, dense = oracle.prefill(ids)
    dense = cache_from_numpy(tcfg, jax.tree.map(np.asarray, dense),
                             device="cpu")
    nbt = spec.nbt
    pages = init_paged_cache(tcfg, 1, nbt + 1, MAX_LEN, BLOCK, device="cpu")
    pages = paged_cache_join(tcfg, pages, dense, 0,
                             spec.table(range(1, nbt + 1)))
    n = -(-len(ids) // BLOCK)
    payload = paged_gather_blocks(tcfg, pages, spec.table(range(1, n + 1)))
    return first, PageHandoff(payload, len(ids))


def _step(eng, dps):
    done = threading.Event()
    eng._post = lambda kind, payload: done.set()
    assert eng.start_step([dps], 0.0) is ASYNC
    assert done.wait(60)
    return eng.finish_step(0.0, [dps])


def _shared_residents(oracle, tcfg, spec, eng, bus, dps, seed):
    """Two requests sharing a 32-token prefix, published as PageHandoffs
    and admitted to DP 0 of `eng`; returns (requests, serial tokens)."""
    rng = random.Random(seed)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(2 * BLOCK)]
    reqs = [Request(rid=i, arrival_time=0.0, input_len=32 + n, output_len=6,
                    tokens=tuple(prefix + [rng.randrange(tcfg.vocab_size)
                                           for _ in range(n)]),
                    priority=2 - 2 * i)
            for i, n in enumerate((8, 13))]
    want = {}
    for r in reqs:
        want[r.rid] = oracle.tokens(list(r.tokens), r.output_len)
        first, ph = _handoff(oracle, tcfg, spec, list(r.tokens))
        bus.publish(r.rid, ph, first)
        r.generated = 1                      # the prefill-emitted token
        dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
        eng.admit(0, r)
    return reqs, want


def test_preempt_readmit_page_handoff_resident(oracle, port):
    """Two residents joined by PageHandoff share their prefix pages; the
    one that published them is preempted (parked as a dense batch-1
    cache, its references dropped — the other resident keeps reading
    the shared pages), re-admitted through the dense join, and both
    finish with the serial tokens; the pool drains after eviction."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=6,
                      block_size=BLOCK, device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus, share_prefix=True)
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=BLOCK)
    reqs, want = _shared_residents(oracle, tcfg, spec, eng, bus, dps, 7)
    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        dp = eng._dp[0]
        assert (eng.blocks_shared, eng.cow_copies) == (2, 2)
        shared = dp.held[1][:2]
        assert dp.held[0][:2] == shared
        victim = eng.preempt(0)
        assert victim is reqs[0]
        assert all(dp.pool.refcount(b) == 2 for b in shared)  # tree + rid 1
        parked = bus.gen(0).cache
        assert not isinstance(parked, PageHandoff)
        assert int(parked["cur"][0]) == reqs[0].input_len + 1
        finished += _step(eng, dps)           # rid 1 alone
        eng.admit(0, reqs[0])                 # re-admission
        while eng.has_work():
            finished += _step(eng, dps)
    finally:
        eng.stop()
        eng.join_worker(timeout=10)
    assert sorted(r.rid for r in finished) == [0, 1]
    for r in reqs:
        assert bus.gen(r.rid).tokens == want[r.rid]
    assert dp.binder.ensure_free(dp.pool.num_blocks - 1)
    dp.pool.check()
    assert dp.pool.used_count == 0


def test_page_handoff_join_clears_growth_blocks(oracle, port):
    """A PageHandoff join copies the payload pages and must clear the
    request's growth pages, which may hold a previous tenant's positions:
    every pool page starts out holding positions 0-15 here; after the
    serial tokens, the growth page holds exactly the positions decode
    wrote, then -1."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=6,
                      block_size=BLOCK, device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus, share_prefix=True)
    st = eng._dp[0]
    st.cache = spec.paged_cache()
    st.cache["kv_pos"][1:] = torch.arange(BLOCK, dtype=torch.int32)
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=BLOCK)
    rng = random.Random(5)
    r = _req(0, [rng.randrange(tcfg.vocab_size) for _ in range(30)], out=6)
    first, ph = _handoff(oracle, tcfg, spec, list(r.tokens))
    bus.publish(r.rid, ph, first)
    r.generated = 1
    dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
    eng.admit(0, r)
    eng.start()
    try:
        _step(eng, dps)                       # joins, one step
        growth = st.held[0][2]                # positions 32-34
        while eng.has_work():
            _step(eng, dps)
    finally:
        eng.stop()
        eng.join_worker(timeout=10)
    assert bus.gen(0).tokens == oracle.tokens(list(r.tokens), 6)
    assert st.cache["kv_pos"][growth].tolist() == [32, 33, 34] + [-1] * 13


def test_drain_during_inflight_step_with_page_handoff_residents(
        oracle, port, monkeypatch):
    """The watchdog's drain of a busy decode instance whose residents
    joined by PageHandoff over shared pages: the drain waits for the
    step, parks the pre-step snapshots, returns the residents' pages
    (the published ones stay in the binder, frozen: the step's writes
    went to private blocks), and the requests finish token-exact on a
    healthy instance."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=6,
                      block_size=BLOCK, device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus, share_prefix=True)
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=BLOCK)
    reqs, want = _shared_residents(oracle, tcfg, spec, eng, bus, dps, 9)
    inner = RE.paged_decode_step
    gate = threading.Event()

    def gated(*args):
        assert gate.wait(30)
        return inner(*args)

    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        st = eng._dp[0]
        monkeypatch.setattr(RE, "paged_decode_step", gated)
        eng._post = lambda kind, payload: None
        assert eng.start_step([dps], 0.0) is ASYNC
        threading.Timer(0.3, gate.set).start()
        t0 = time.monotonic()
        out = eng.drain()
        assert time.monotonic() - t0 >= 0.2   # it waited for the step
        assert sorted(r.rid for v in out.values() for r in v) == [0, 1]
        assert not st.occupied() and not eng.busy
        st.pool.check()
        assert st.pool.used_count == 2 + 2    # the binder's prefix + tails
        for r in reqs:
            blk = st.pool.lookup(tuple(r.tokens))
            n = r.input_len % BLOCK
            assert st.cache["kv_pos"][blk].tolist() == (
                list(range(r.input_len - n, r.input_len))
                + [-1] * (BLOCK - n))
        monkeypatch.undo()
    finally:
        gate.set()
        eng.stop()
        eng.join_worker(timeout=10)
    for r in reqs:                            # the pre-step snapshot
        assert int(bus.gen(r.rid).cache["cur"][0]) == r.input_len + 1
        assert len(bus.gen(r.rid).tokens) == 2
    eng2 = RealDecodeEngine(1, [0], spec, bus, share_prefix=True)
    dps2 = DecodeDPState(dp_id=0, instance_id=1, block_size=BLOCK)
    for r in reqs:
        dps2.admit(r.input_len + r.generated,
                   reserve_len=r.input_len + r.output_len)
        eng2.admit(0, r)
    eng2.start()
    try:
        while eng2.has_work():
            finished += _step(eng2, dps2)
    finally:
        eng2.stop()
        eng2.join_worker(timeout=10)
    assert sorted(r.rid for r in finished) == [0, 1]
    for r in reqs:
        assert bus.gen(r.rid).tokens == want[r.rid]
    for e in (eng, eng2):
        st = e._dp[0]
        assert st.binder.ensure_free(st.pool.num_blocks - 1)
        st.pool.check()
        assert st.pool.used_count == 0


# ---------------------------------------------------------------------------
# MoE and MLA on the shared-prefix P/D plane: reduced granite-moe-1b-a400m
# (MoE FFNs over the page-native chunks and the decode rows) and reduced
# minicpm3-4b (latent pages claimed, handed off, adopted and copied on
# write)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b"])
def test_pd_prefix_serve_moe_and_mla_match_jax_server(arch):
    """The parity waves of `test_pd_prefix_serve_matches_jax_server`
    under sbs-la on another model family: the same tokens and the same
    reuse counters, chunk counts included, as the JAX server."""
    from repro.core.types import Request as JRequest
    from repro.serving.real_engine import EngineSpec as JEngineSpec
    from repro.serving.server import RealSBSServer as JServer
    cfg = get_arch(arch, reduced=True)
    tcfg = t_get_arch(arch, reduced=True)
    jp = jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    base = _share_scfg(decode_dp_per_instance=1, max_batch_per_dp=8)
    kw = dict(max_len=MAX_LEN, max_batch=8, max_new=4, block_size=BLOCK,
              decode_slots=ServingConfig(**base).resolved_decode_slots)
    jsrv = JServer(cfg, jp, JServingConfig(**base), scheduler="sbs-la",
                   spec=JEngineSpec(cfg, jp, **kw), prefix_cache=True)
    tsrv = RealSBSServer(tcfg, tp, ServingConfig(**base), scheduler="sbs-la",
                         spec=EngineSpec(tcfg, tp, device="cpu", **kw),
                         prefix_cache=True)
    wave1, wave2 = _parity_waves(tcfg.vocab_size)
    out, stats = {}, {}
    for name, srv, R in (("jax", jsrv, JRequest), ("port", tsrv, Request)):
        gens = []
        for w, wave in enumerate((wave1, wave2)):
            gens += srv.serve([R(rid=10 * w + i, arrival_time=0.05 * i,
                                 input_len=len(p), output_len=3 + i % 2,
                                 tokens=tuple(p))
                               for i, p in enumerate(wave)], timeout=120)
        out[name] = {g.rid: g.tokens for g in gens}
        stats[name] = srv.prefix_stats()
    assert sorted(out["port"]) == [0, 10, 11, 12, 13, 14]
    assert out["port"] == out["jax"]
    assert out["port"][10] == out["port"][0]
    assert stats["port"] == stats["jax"]
    assert stats["port"]["prefill_full_hits"] == 1
    assert stats["port"]["decode_cow_copies"] == 6
    _drain_pools(tsrv)


# ---------------------------------------------------------------------------
# a budgeted prefill binder (RealPrefillEngine's cache_budget_tokens)
# ---------------------------------------------------------------------------

class _Loop:
    """The `post` target of an engine driven without a runtime."""

    def __init__(self):
        self.done = threading.Event()

    def post(self, kind, payload):
        self.done.set()


def _prefill_until_done(eng, loop):
    """Run `eng`'s passes until its queue is empty; returns the completed
    requests."""
    done = []
    while eng.has_work():
        loop.done.clear()
        assert eng.start_pass(0.0) is not None     # each package's ASYNC
        assert loop.done.wait(120)
        done += eng.finish_pass(0.0).completed
    return done


def test_prefill_cache_budget_matches_jax_engine(oracle, port):
    """`RealPrefillEngine(..., cache_budget_tokens=N)` bounds its prefix
    binder as the reference's engine does: the same prompts through a
    page-native prefill engine of each package, with a 64-token budget
    (4 pages of a 13-page pool), give after every completion the same
    evicted entries and pages, pool free count, hit and seen tokens, full
    hits and chunks run, and the same first tokens.  The prompts repeat
    one another (a full hit), share a prefix, and overflow the budget so
    that entries are evicted and a later repeat misses."""
    from repro.core.types import DispatchCommand as JDispatchCommand
    from repro.core.types import Request as JRequest
    from repro.serving.real_engine import EngineSpec as JEngineSpec
    from repro.serving.real_engine import KVHandoffBus as JBus
    from repro.serving.real_engine import RealPrefillEngine as JPrefill
    tcfg, tparams = port
    kw = dict(max_len=MAX_LEN, max_batch=4, block_size=BLOCK,
              prefill_slots=2, prefill_pool_blocks=13)
    pkgs = {
        "jax": (JPrefill(0, [0], 32, JEngineSpec(oracle.cfg, oracle.params,
                                                 **kw), JBus(),
                         page_native=True, share_prefix=True,
                         cache_budget_tokens=4 * BLOCK),
                JRequest, JDispatchCommand),
        "torch": (RealPrefillEngine(0, [0], 32,
                                    EngineSpec(tcfg, tparams, device="cpu",
                                               **kw), KVHandoffBus(),
                                    page_native=True, share_prefix=True,
                                    cache_budget_tokens=4 * BLOCK),
                  Request, DispatchCommand)}
    evicted = {}
    for name, (eng, _r, _c) in pkgs.items():
        count = evicted[name] = {"entries": 0, "pages": 0}
        inner = eng.binder.tree._on_evict

        def on_evict(node, _count=count, _inner=inner):
            _count["entries"] += 1
            _count["pages"] += len(node.blocks or ())
            _inner(node)
        eng.binder.tree._on_evict = on_evict
    rng = random.Random(23)
    a = [rng.randrange(tcfg.vocab_size) for _ in range(40)]
    b = a[:2 * BLOCK] + [rng.randrange(tcfg.vocab_size) for _ in range(20)]
    c = [rng.randrange(tcfg.vocab_size) for _ in range(56)]
    d = [rng.randrange(tcfg.vocab_size) for _ in range(33)]
    prompts = [a, a, b, c, d, a, b]
    loops = {name: _Loop() for name in pkgs}
    for name, (eng, _r, _c) in pkgs.items():
        eng.bind_loop(loops[name])
        eng.start()
    try:
        for rid, prompt in enumerate(prompts):
            seen = {}
            for name, (eng, R, Cmd) in pkgs.items():
                req = R(rid=rid, arrival_time=0.0, input_len=len(prompt),
                        output_len=2, tokens=tuple(prompt))
                claim, _full = eng.binder.peek(prompt)
                req.remaining_prefill = 0
                eng.enqueue(Cmd(0, {0: [(req, len(prompt) - claim)]}), 0.0)
                done = _prefill_until_done(eng, loops[name])
                assert [r.rid for r in done] == [rid]
                seen[name] = (eng.bus.gen(rid).tokens[0], dict(evicted[name]),
                              eng.pool.free_count, eng.binder.hit_tokens,
                              eng.binder.seen_tokens, eng.full_hits,
                              eng.chunks_run, eng.binder.tree.size)
            assert seen["torch"] == seen["jax"], (rid, seen)
    finally:
        for eng, _r, _c in pkgs.values():
            eng.stop()
            eng.join_worker()
    assert evicted["torch"]["entries"] > 0
    assert pkgs["torch"][0].full_hits >= 1
