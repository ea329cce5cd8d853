"""PyTorch port: `RealSBSServer` end to end against the JAX serial
oracle (chunked dense prefill + batch-of-1 decode) on reduced
deepseek-7b with the JAX weights bridged over, in fp32 on the CPU:

  * the unified mixed-batch plane, as tests/test_mixed_batch.py:240 —
    piggyback and disjoint, each scheduler;
  * the P/D-separated deployment, as tests/test_real_plane.py:260-612 —
    padded and paged decode, each scheduler, with conservation and TTFT
    stamped at prefill completion; padded on reduced h2o-danube-3-4b,
    whose window-64 ring wraps;
  * the engines' recovery paths: page-level preemption, a drain while a
    step is in flight (the watchdog's), a live watchdog run, and
    worker errors that surface promptly;
  * SSM serving on the P/D padded plane (reduced mamba2-370m, and a
    MoE-free hybrid: reduced jamba with the layer pattern (SSM, DENSE)),
    whose tokens depend on where prefill chunks start (the SSD scan
    chunks each prefill chunk from its start), so the oracle replays the
    serve's chunk boundaries; preemption and a drain while busy keep an
    SSM row token-exact; paged and mixed-batch SSM deployments raise.

Token streams must match exactly.
"""
import dataclasses
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import LayerKind as JLK
from repro.config.base import ServingConfig as JServingConfig
from repro.models import model as JM

from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.config.base import LayerKind as TLK
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import DecodeDPState, Request, RequestPhase
from repro_torch.serving import real_engine as RE
from repro_torch.serving.plane import ASYNC
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, RealDecodeEngine,
)
from repro_torch.serving.server import RealSBSServer

MAX_LEN = 96
BLOCK = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Oracle:
    """The JAX seed path: chunked dense prefill, then serial decode.
    `cfg` defaults to reduced deepseek-7b."""

    def __init__(self, cfg=None):
        cfg = cfg or get_arch("deepseek-7b", reduced=True)
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

    def tokens(self, ids, n, chunks=None):
        """n tokens of the serial path; `chunks` (prefill chunk lengths)
        replays a serve's chunk boundaries instead of 16-token chunks."""
        if chunks is None:
            t0, cache = self.prefill(ids)
        else:
            assert sum(chunks) == len(ids)
            cache, at = JM.init_cache(self.cfg, 1, MAX_LEN), 0
            for c in chunks:
                lg, cache = self._chunk(self.params, jnp.asarray(
                    [ids[at:at + c]], jnp.int32), cache)
                at += c
            t0 = int(jnp.argmax(lg[0]))
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


def _requests(cfg, n=4, out_len=5, seed=5):
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        L = rng.randrange(16, 48)
        reqs.append(Request(
            rid=i, arrival_time=i * 0.02, input_len=L, output_len=out_len,
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    return reqs


@pytest.fixture(scope="module")
def expected(oracle, port):
    return {r.rid: oracle.tokens(list(r.tokens), r.output_len)
            for r in _requests(port[0])}


def _scfg(**kw):
    return ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=16, t_default=0.05, l_net=0.001,
        max_batch_per_dp=4, block_size=BLOCK,
        mixed_batch=True, mixed_chunk=32, **kw)


@pytest.mark.parametrize("scheduler,piggyback", [
    ("sbs-la", True), ("sbs-la", False), ("sbs", True), ("immediate", True)])
def test_unified_server_matches_jax_oracle(port, expected, scheduler,
                                           piggyback):
    tcfg, tparams = port
    reqs = _requests(tcfg)
    srv = RealSBSServer(tcfg, tparams, _scfg(mixed_piggyback=piggyback),
                        scheduler=scheduler, max_len=MAX_LEN, max_new=5,
                        device="cpu")
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [r.rid for r in reqs]
    for g in gens:
        assert g.tokens == expected[g.rid]
        assert g.ttft > 0
    # every prompt token was prefilled on the decode pool, no handoff
    eng = srv.decode_engines[0]
    assert eng.prefill_tokens == sum(r.input_len for r in reqs)
    for st in eng._dp.values():
        st.pool.check()
        assert st.pool.used_count == 0
        assert not st.occupied()
    assert all(e._worker is None for e in srv.decode_engines)


def test_server_serves_twice_on_one_spec(port, expected):
    """A spec (and its caches' pages) is reusable across servers and
    serve() calls; a second run gives the same tokens."""
    tcfg, tparams = port
    scfg = _scfg()
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=5,
                      block_size=BLOCK, decode_slots=scfg.resolved_decode_slots,
                      device="cpu")
    srv = RealSBSServer(tcfg, tparams, scfg, scheduler="sbs-la", spec=spec)
    for _ in range(2):
        gens = srv.serve(_requests(tcfg), timeout=120)
        assert {g.rid: g.tokens for g in gens} == expected


@pytest.mark.parametrize("kw", [dict(mixed_batch=True), dict(mixed_batch=False)])
def test_server_rejects_what_is_not_ported(port, kw):
    """Page sharing (with page-native prefill) is ROADMAP Queue 1 item 6,
    on either deployment."""
    tcfg, tparams = port
    scfg = ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1, decode_dp_per_instance=2,
                         max_batch_per_dp=4, block_size=BLOCK, **kw)
    with pytest.raises(NotImplementedError):
        RealSBSServer(tcfg, tparams, scfg, max_len=MAX_LEN, device="cpu",
                      prefix_cache=True)


def test_unified_plane_needs_pages(port):
    tcfg, tparams = port
    scfg = ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1, decode_dp_per_instance=2,
                         max_batch_per_dp=4, block_size=0, mixed_batch=True)
    with pytest.raises(ValueError):
        RealSBSServer(tcfg, tparams, scfg, max_len=MAX_LEN, device="cpu")


def test_default_serving_config_matches_reference():
    """Both packages fill in the same ServingConfig when none is given."""
    from repro.serving.server import _default_serving_config as j_default
    from repro_torch.serving.server import _default_serving_config
    assert (dataclasses.asdict(_default_serving_config())
            == dataclasses.asdict(j_default()))


def test_server_builds_and_serves_without_serving_cfg(port, expected):
    """`RealSBSServer(cfg, params)` takes the reference's default
    deployment (P/D, 2 prefill instances × 2 DP, chunk 32, padded
    decode) and serves token-exact against the JAX oracle."""
    from repro_torch.serving.server import _default_serving_config
    tcfg, tparams = port
    srv = RealSBSServer(tcfg, tparams, max_len=MAX_LEN, max_new=5,
                        device="cpu")
    assert (dataclasses.asdict(srv.scfg)
            == dataclasses.asdict(_default_serving_config()))
    assert len(srv.engines) == 2 and not srv.scfg.mixed_batch
    reqs = _requests(tcfg)
    gens = srv.serve(reqs, timeout=120)
    assert {g.rid: g.tokens for g in gens} == expected


# ---------------------------------------------------------------------------
# page-level preemption on the paged decode engine
# ---------------------------------------------------------------------------

def _step(eng, dps):
    done = threading.Event()
    eng._post = lambda kind, payload: done.set()
    assert eng.start_step([dps], 0.0) is ASYNC
    assert done.wait(60)
    return eng.finish_step(0.0, [dps])


def test_engine_preempt_readmit_token_exact(oracle, port):
    """Two residents decode; the batch-class one is preempted (KV parked
    on the bus as a dense batch-1 cache, pages returned), re-admitted
    through the join path, and both finish with the serial tokens."""
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=6,
                      block_size=BLOCK, device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus)
    rng = random.Random(7)
    reqs = [Request(rid=i, arrival_time=0.0, input_len=24, output_len=6,
                    tokens=tuple(rng.randrange(tcfg.vocab_size)
                                 for _ in range(24)),
                    priority=2 - 2 * i)
            for i in range(2)]
    want = {}
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=BLOCK)
    for r in reqs:
        t0, dense = oracle.prefill(list(r.tokens))
        want[r.rid] = oracle.tokens(list(r.tokens), r.output_len)
        bus.publish(r.rid, cache_from_numpy(
            tcfg, jax.tree.map(np.asarray, dense), device="cpu"), t0)
        r.generated = 1                      # the prefill-emitted token
        dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
        eng.admit(0, r)
    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        dp = eng._dp[0]
        free_before = dp.pool.free_count
        victim = eng.preempt(0)
        assert victim is reqs[0]
        assert dp.pool.free_count == free_before + dp.pool.blocks_for(24 + 5)
        parked = bus.gen(0).cache
        assert int(parked["cur"][0]) == 25 and parked["kv_pos"].shape == (
            1, MAX_LEN)
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
    dp.pool.check()
    assert dp.pool.used_count == 0


# ---------------------------------------------------------------------------
# the P/D-separated deployment (tests/test_real_plane.py:260-612)
# ---------------------------------------------------------------------------

def _pd_scfg(block_size, **kw):
    # n_limit well above the default: SBS flow control (not under test
    # here) rejects a prompt after a number of dispatch cycles, which a
    # slow, loaded host could reach
    base = dict(num_prefill_instances=2, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                chunk_size=32, t_default=0.05, l_net=0.001,
                max_batch_per_dp=4, block_size=block_size, n_limit=64)
    base.update(kw)
    return ServingConfig(**base)


def _record_steps(srv):
    """Wall stamps of every decode step completion of `srv`."""
    stamps = []
    for eng in srv.decode_engines:
        inner = eng.finish_step
        eng.finish_step = (lambda now, dps, _f=inner:
                           (stamps.append(now), _f(now, dps))[1])
    return stamps


def _assert_conserved(srv, reqs):
    """Requests in == completions; no KV tokens, rows or pages outlive
    their request; the decode plane emitted every non-prefill token."""
    assert all(r.finish_time is not None for r in reqs)
    assert sum(d.kv_tokens for d in srv.state.decode_dps) == 0
    assert sum(d.batch for d in srv.state.decode_dps) == 0
    assert sum(d.kv_blocks for d in srv.state.decode_dps) == 0
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            if srv.spec.paged:
                st.pool.check()
                assert st.pool.used_count == 0
            assert not st.occupied()
    assert sum(e.tokens_generated for e in srv.decode_engines) == sum(
        r.generated - 1 for r in reqs)
    assert sum(e.tokens_processed for e in srv.engines) == sum(
        r.input_len for r in reqs)
    assert all(e._worker is None for e in srv.engines + srv.decode_engines)


@pytest.mark.parametrize("block_size", [0, BLOCK], ids=["padded", "paged"])
@pytest.mark.parametrize("scheduler", ["sbs", "sbs-la", "immediate"])
def test_pd_server_matches_jax_oracle(port, expected, scheduler, block_size):
    tcfg, tparams = port
    reqs = _requests(tcfg)
    arrivals = [r.arrival_time for r in reqs]
    srv = RealSBSServer(tcfg, tparams, _pd_scfg(block_size),
                        scheduler=scheduler, max_len=MAX_LEN, max_new=5,
                        device="cpu")
    steps = _record_steps(srv)
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [r.rid for r in reqs]
    for g in gens:
        assert g.tokens == expected[g.rid]
    for r in reqs:
        assert r.generated == r.output_len
        assert r.dispatch_time <= r.prefill_start <= r.first_token_time
        # TTFT is stamped when prefill completes (a pass_end), before any
        # decode step the request took part in
        assert r.first_token_time not in steps
        assert any(r.first_token_time < t for t in steps)
        assert r.first_token_time < r.finish_time
    assert [r.arrival_time for r in reqs] == arrivals
    _assert_conserved(srv, reqs)


@pytest.fixture(scope="module")
def danube():
    """Reduced h2o-danube-3-4b (sliding window 64 < MAX_LEN): JAX and
    port params from one JAX init."""
    cfg = get_arch("h2o-danube-3-4b", reduced=True)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = t_get_arch("h2o-danube-3-4b", reduced=True)
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def test_pd_padded_swa_ring_matches_jax(danube):
    """Prompts past the window: the prefill ring wraps, and decode
    continues on the wrapped ring.  The reference writes a whole chunk
    into the ring before its queries attend, so its tokens depend on the
    chunk boundaries; the oracle replays the boundaries the port's
    prefill engines used."""
    cfg, jparams, tcfg, tparams = danube
    rng = random.Random(3)
    reqs = []
    for i, L in enumerate((70, 85, 66)):
        reqs.append(Request(
            rid=i, arrival_time=i * 0.02, input_len=L, output_len=5,
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    srv = RealSBSServer(tcfg, tparams, _pd_scfg(0), scheduler="sbs-la",
                        max_len=MAX_LEN, max_new=5, device="cpu")
    assert srv.spec.batch_cache()["kv_pos"].shape[1] == 64
    chunks = {}
    for eng in srv.engines:
        inner = eng._run_chunk
        eng._run_chunk = (lambda req, tok, _f=inner: (
            chunks.setdefault(req.rid, []).append(tok), _f(req, tok))[1])
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [0, 1, 2]
    jchunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    for g, r in zip(gens, reqs):
        assert sum(chunks[r.rid]) == r.input_len
        cache, at = JM.init_cache(cfg, 1, MAX_LEN), 0
        for n in chunks[r.rid]:
            lg, cache = jchunk(jparams, jnp.asarray(
                [r.tokens[at:at + n]], jnp.int32), cache)
            at += n
        toks = [int(jnp.argmax(lg[0]))]
        for _ in range(r.output_len - 1):
            lg, cache = jdecode(jparams, jnp.asarray([[toks[-1]]], jnp.int32),
                                cache)
            toks.append(int(jnp.argmax(lg[0])))
        assert g.tokens == toks
    _assert_conserved(srv, reqs)


def test_pd_worker_errors_surface_promptly(port, monkeypatch):
    """A failing forward on a prefill or a decode worker raises out of
    serve() at once, not at the timeout horizon."""
    tcfg, tparams = port
    for name in ("prefill_chunk", "decode_step"):
        def boom(*args, _name=name):
            raise RuntimeError(f"boom in {_name}")
        with monkeypatch.context() as m:
            m.setattr(RE, name, boom)
            srv = RealSBSServer(tcfg, tparams, _pd_scfg(0), scheduler="sbs",
                                max_len=MAX_LEN, max_new=5, device="cpu")
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match=f"boom in {name}"):
                srv.serve(_requests(tcfg, n=2), timeout=60)
            assert time.monotonic() - t0 < 30
            assert all(e._worker is None
                       for e in srv.engines + srv.decode_engines)


# ---------------------------------------------------------------------------
# drain while a step is in flight (the watchdog's), and a live watchdog
# ---------------------------------------------------------------------------

def _publish(oracle, tcfg, bus, dps, eng, reqs):
    for r in reqs:
        t0, dense = oracle.prefill(list(r.tokens))
        bus.publish(r.rid, cache_from_numpy(
            tcfg, jax.tree.map(np.asarray, dense), device="cpu"), t0)
        r.generated = 1                      # the prefill-emitted token
        dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
        eng.admit(0, r)


@pytest.mark.parametrize("block_size", [0, BLOCK], ids=["padded", "paged"])
def test_drain_during_inflight_step_is_token_exact(oracle, port, monkeypatch,
                                                   block_size):
    """A drain while a step is in flight waits (bounded) for the step to
    return before any slot or page comes back, raises if the step never
    returns, and parks the pre-step snapshot: re-admitted elsewhere, the
    requests finish with the serial tokens."""
    _check_drain_inflight(oracle, port, monkeypatch, block_size)


def _check_drain_inflight(oracle, port, monkeypatch, block_size):
    tcfg, tparams = port
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=4, max_new=6,
                      block_size=block_size, device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus)
    rng = random.Random(9)
    reqs = [Request(rid=i, arrival_time=0.0, input_len=L, output_len=6,
                    tokens=tuple(rng.randrange(tcfg.vocab_size)
                                 for _ in range(L)))
            for i, L in enumerate((21, 40))]
    want = {r.rid: oracle.tokens(list(r.tokens), r.output_len) for r in reqs}
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=block_size)
    _publish(oracle, tcfg, bus, dps, eng, reqs)
    name = "paged_decode_step" if block_size else "decode_step"
    inner = getattr(RE, name)
    gate = threading.Event()
    returned = []

    def gated(*args):
        assert gate.wait(30)
        out = inner(*args)
        returned.append(time.monotonic())
        return out

    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        st = eng._dp[0]
        monkeypatch.setattr(RE, name, gated)
        posted = threading.Event()
        stale = []
        eng._post = lambda kind, payload: (stale.append(payload),
                                           posted.set())
        assert eng.start_step([dps], 0.0) is ASYNC
        # a step that does not return: drain refuses and hands back nothing
        eng.drain_wait_s = 0.2
        with pytest.raises(RuntimeError, match="did not return"):
            eng.drain()
        assert eng.busy and st.occupied()
        # the step returns while drain waits
        eng.drain_wait_s = 30.0
        threading.Timer(0.3, gate.set).start()
        out = eng.drain()
        drained_at = time.monotonic()
        assert returned and returned[0] <= drained_at
        assert sorted(r.rid for v in out.values() for r in v) == [0, 1]
        assert not st.occupied() and not eng.busy
        if block_size:
            st.pool.check()
            assert st.pool.used_count == 0
        assert posted.wait(30)
        assert stale[0][1] != eng.epoch       # its step_end is stale
        monkeypatch.undo()
    finally:
        gate.set()
        eng.stop()
        eng.join_worker(timeout=10)
    for r in reqs:                            # the pre-step snapshot
        assert int(bus.gen(r.rid).cache["cur"][0]) == r.input_len + 1
        assert len(bus.gen(r.rid).tokens) == 2
    # re-admission on a healthy instance
    eng2 = RealDecodeEngine(1, [0], spec, bus)
    dps2 = DecodeDPState(dp_id=0, instance_id=1, block_size=block_size)
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


@pytest.mark.parametrize("plane", ["pd-padded", "pd-paged", "unified"])
def test_live_watchdog_terminates_and_conserves(oracle, port, monkeypatch,
                                                plane):
    """tests/test_runtime.py:207 on the real plane: an aggressive
    watchdog (0.5× the step-time EWMA) drains busy instances and
    re-dispatches their requests.  Such a budget cannot promise progress
    (a re-joined request's next step may overrun it again, until the
    horizon), but the run must terminate, no request may vanish, and
    every request that finishes has exactly the serial tokens (a drain
    parks the pre-step snapshot).  Decode steps are slowed until the
    first migration, so the drain path is sure to run."""
    tcfg, tparams = port
    reqs = _requests(tcfg, n=6)
    for r in reqs:
        r.arrival_time *= 2.5
    mixed = plane == "unified"
    scfg = _pd_scfg(0 if plane == "pd-padded" else BLOCK,
                    num_prefill_instances=1, num_decode_instances=2,
                    decode_dp_per_instance=1,
                    **(dict(mixed_batch=True, mixed_chunk=32) if mixed
                       else {}))
    name = "mixed_step" if mixed else (
        "decode_step" if plane == "pd-padded" else "paged_decode_step")
    inner = getattr(RE, name)
    calls = []

    def slowed(*args):
        calls.append(1)
        if len(calls) > 2 and not any(r.migrations for r in reqs):
            time.sleep(0.2)
        return inner(*args)

    monkeypatch.setattr(RE, name, slowed)
    srv = RealSBSServer(tcfg, tparams, scfg, scheduler="sbs-la",
                        max_len=MAX_LEN, max_new=5, watchdog_multiplier=0.5,
                        device="cpu")
    t0 = time.monotonic()
    gens = srv.serve(reqs, timeout=4.0)
    assert time.monotonic() - t0 < 30
    assert sum(r.migrations for r in reqs) > 0
    done = {g.rid: g.tokens for g in gens}
    engines = {r.rid: r for e in srv.decode_engines
               for r in (*(x for v in e.running.values() for x in v),
                         *(x for _d, x in e._pending),
                         *(x for q in getattr(e, "prefilling", {}).values()
                           for x in q))}
    buffered = {r.rid for r in srv.dsched.buffer}
    for r in reqs:
        if r.rid in done:                     # exactly-once, token-exact
            assert r.generated == r.output_len
            assert done[r.rid] == oracle.tokens(list(r.tokens),
                                                r.output_len)
            assert r.rid not in engines and r.rid not in buffered
        elif r.phase == RequestPhase.DECODING:
            # handed to the decode plane and not finished: still held
            assert (r.rid in engines) != (r.rid in buffered)
    # the decode plane's KV accounting matches the requests it holds
    assert sum(d.kv_tokens for d in srv.state.decode_dps) == sum(
        r.input_len + r.generated for r in engines.values())


# ---------------------------------------------------------------------------
# SSM serving on the P/D padded plane: reduced mamba2-370m and a MoE-free
# hybrid (reduced jamba with the layer pattern (SSM, DENSE))
# ---------------------------------------------------------------------------

def _ssm_model(name):
    """(JAX oracle, (port cfg, port params)) on one JAX init."""
    arch = "jamba-v0.1-52b" if name == "jamba-hybrid" else name
    cfg = get_arch(arch, reduced=True)
    tcfg = t_get_arch(arch, reduced=True)
    if name == "jamba-hybrid":
        cfg = dataclasses.replace(cfg, layer_pattern=(JLK.SSM, JLK.DENSE))
        tcfg = dataclasses.replace(tcfg, layer_pattern=(TLK.SSM, TLK.DENSE))
    orc = _Oracle(cfg)
    return orc, (tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, orc.params), device="cpu"))


@pytest.fixture(scope="module")
def mamba():
    return _ssm_model("mamba2-370m")


@pytest.fixture(scope="module")
def hybrid():
    return _ssm_model("jamba-hybrid")


def _record_chunks(srv):
    """Prefill chunk lengths per request, as the port's engines ran them."""
    chunks = {}
    for eng in srv.engines:
        inner = eng._run_chunk
        eng._run_chunk = (lambda req, tok, _f=inner: (
            chunks.setdefault(req.rid, []).append(tok), _f(req, tok))[1])
    return chunks


def _check_ssm_pd_serve(orc, tcfg, tparams, scheduler):
    reqs = _requests(tcfg)
    srv = RealSBSServer(tcfg, tparams, _pd_scfg(0), scheduler=scheduler,
                        max_len=MAX_LEN, max_new=5, device="cpu")
    assert "ssm" in srv.spec.batch_cache()
    chunks = _record_chunks(srv)
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [r.rid for r in reqs]
    for g, r in zip(gens, reqs):
        assert g.tokens == orc.tokens(list(r.tokens), r.output_len,
                                      chunks=chunks[r.rid])
        assert r.generated == r.output_len
    _assert_conserved(srv, reqs)


@pytest.mark.parametrize("scheduler", ["sbs", "sbs-la", "immediate"])
def test_pd_ssm_server_matches_jax_oracle(mamba, scheduler):
    """Reduced mamba2-370m behind the P/D server on the padded plane:
    prefill chunks carry the SSM and conv state, the handoff carries it
    to a decode row, and every token matches the JAX serial path on the
    serve's chunk boundaries."""
    orc, (tcfg, tparams) = mamba
    _check_ssm_pd_serve(orc, tcfg, tparams, scheduler)


def test_pd_hybrid_server_matches_jax_oracle(hybrid):
    """The per-kind cache stacks side by side (K/V of the attention
    layer, SSM state of the SSM layer) through prefill, handoff, joins
    and decode."""
    orc, (tcfg, tparams) = hybrid
    _check_ssm_pd_serve(orc, tcfg, tparams, "sbs-la")


def test_ssm_preempt_readmit_token_exact(mamba):
    """A padded SSM row is preempted (its state and conv tails parked on
    the bus as a batch-1 cache, its slot freed), re-admitted through the
    join path, and finishes with the serial tokens."""
    orc, (tcfg, tparams) = mamba
    spec = EngineSpec(tcfg, tparams, max_len=MAX_LEN, max_batch=2, max_new=6,
                      device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus)
    rng = random.Random(7)
    reqs = [Request(rid=i, arrival_time=0.0, input_len=L, output_len=6,
                    tokens=tuple(rng.randrange(tcfg.vocab_size)
                                 for _ in range(L)),
                    priority=2 - 2 * i)
            for i, L in enumerate((24, 37))]
    want = {r.rid: orc.tokens(list(r.tokens), r.output_len) for r in reqs}
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=0)
    _publish(orc, tcfg, bus, dps, eng, reqs)
    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        st = eng._dp[0]
        victim = eng.preempt(0)
        assert victim is reqs[0] and st.free_slot() is not None
        parked = bus.gen(0).cache
        assert int(parked["cur"][0]) == 25
        assert parked["ssm"].shape[1] == 1 and parked["conv_x"].shape[1] == 1
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
    assert not st.occupied()


def test_ssm_drain_during_inflight_step_is_token_exact(mamba, monkeypatch):
    """The watchdog's drain of a busy padded instance with SSM rows: the
    step returns new SSM states and leaves the ones it read intact, so
    the parked pre-step snapshot re-joins token-exact."""
    orc, port = mamba
    _check_drain_inflight(orc, port, monkeypatch, 0)


@pytest.mark.parametrize("kw", [dict(block_size=BLOCK),
                                dict(block_size=BLOCK, mixed_batch=True),
                                dict(block_size=0, mixed_batch=True)],
                         ids=["pd-paged", "mixed-paged", "mixed-padded"])
def test_ssm_paged_and_mixed_deployments_raise(mamba, kw):
    """SSM state has no page form: a paged or mixed-batch deployment of
    mamba2 raises ValueError in the port, as in the JAX server."""
    from repro.serving.server import RealSBSServer as JServer
    orc, (tcfg, tparams) = mamba
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                max_batch_per_dp=4, **kw)
    with pytest.raises(ValueError):
        JServer(orc.cfg, orc.params, JServingConfig(**base),
                max_len=MAX_LEN)
    with pytest.raises(ValueError):
        RealSBSServer(tcfg, tparams, ServingConfig(**base), max_len=MAX_LEN,
                      device="cpu")
