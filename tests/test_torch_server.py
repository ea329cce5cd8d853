"""PyTorch port: the unified mixed-batch `RealSBSServer` end to end
against the JAX serial oracle (chunked dense prefill + batch-of-1
decode), as tests/test_mixed_batch.py:240 — piggyback and disjoint, each
scheduler — plus page-level preemption on the paged decode engine, on
reduced deepseek-7b with the JAX weights bridged over, in fp32 on the
CPU.  Token streams must match exactly.
"""
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models import model as JM

from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import DecodeDPState, Request
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


@pytest.mark.parametrize("kw,srv_kw", [
    (dict(mixed_batch=False), {}),
    (dict(block_size=0), {}),
    ({}, dict(prefix_cache=True)),
    ({}, dict(watchdog_multiplier=2.0)),
])
def test_server_rejects_what_is_not_ported(port, kw, srv_kw):
    tcfg, tparams = port
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                max_batch_per_dp=4, block_size=BLOCK, mixed_batch=True)
    base.update(kw)
    with pytest.raises(NotImplementedError):
        RealSBSServer(tcfg, tparams, ServingConfig(**base), max_len=MAX_LEN,
                      device="cpu", **srv_kw)


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
