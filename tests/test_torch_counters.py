"""PyTorch port: the decode engines' residency and starvation counters
against the JAX engines' on the same trace and weights (reduced
deepseek-7b, fp32 on the CPU), where they do not depend on timing: the
engines are stepped directly, one step at a time.

  * `peak_resident` (the most requests resident at once; read by the
    serving benchmark's paged-vs-padded gate): a burst that all fits,
    joined from dense caches on the padded and the paged plane, from
    `PageHandoff`s sharing a prefix, and staged raw on the unified plane;
  * `forced_grants` (starvation-bound activations on the unified engine;
    read by the mixed-batch A/B): decode rows that use up the whole
    `mixed_chunk` budget while a prompt waits, until the bound forces a
    minimum grant (the real-engine counterpart of
    tests/test_mixed_batch.py::test_sim_unified_starvation_bound_forces_grant).

Tokens must match too.
"""
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.core.types import DecodeDPState as JDecodeDPState
from repro.core.types import Request as JRequest
from repro.models import model as JM
from repro.serving import real_engine as JRE

from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import DecodeDPState, Request
from repro_torch.models.model import (
    init_paged_cache, paged_cache_join, paged_gather_blocks,
)
from repro_torch.serving import real_engine as RE

MAX_LEN = 96
BLOCK = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params, jitted JAX chunk) on
    one JAX init."""
    cfg = get_arch("deepseek-7b", reduced=True)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    chunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"), chunk


def _prefill(model, ids):
    """(first token, JAX dense batch-1 cache) of the prompt `ids`."""
    cfg, params, _tcfg, _tp, chunk = model
    cache = JM.init_cache(cfg, 1, MAX_LEN)
    for i in range(0, len(ids), 16):
        lg, cache = chunk(params, jnp.asarray([ids[i:i + 16]], jnp.int32),
                          cache)
    return int(jnp.argmax(lg[0])), cache


def _page_handoffs(model, jspec, tspec, ids):
    """The prompt `ids` as a `PageHandoff` on each side: its dense cache
    scattered into pages, then the prompt's pages gathered."""
    cfg, _p, tcfg, _tp, _c = model
    first, dense = _prefill(model, ids)
    nbt, n = jspec.nbt, -(-len(ids) // BLOCK)

    def jtab(ids_):
        return jnp.asarray(JRE.pad_block_table(list(ids_), nbt), jnp.int32)
    pages = JM.init_paged_cache(cfg, 1, nbt + 1, MAX_LEN, BLOCK)
    pages = JM.paged_cache_join(cfg, pages, dense, 0, jtab(range(1, nbt + 1)))
    jpay = JM.paged_gather_blocks(cfg, pages, jtab(range(1, n + 1)))
    tdense = cache_from_numpy(tcfg, jax.tree.map(np.asarray, dense),
                              device="cpu")
    tpages = init_paged_cache(tcfg, 1, nbt + 1, MAX_LEN, BLOCK, device="cpu")
    tpages = paged_cache_join(tcfg, tpages, tdense, 0,
                              tspec.table(range(1, nbt + 1)))
    tpay = paged_gather_blocks(tcfg, tpages, tspec.table(range(1, n + 1)))
    return (first, JRE.PageHandoff(jpay, len(ids)),
            RE.PageHandoff(tpay, len(ids)))


def _step(eng, dps):
    done = threading.Event()
    eng._post = lambda kind, payload: done.set()
    assert eng.start_step([dps], 0.0) is not None
    assert done.wait(120)
    return eng.finish_step(0.0, [dps])


def _run(eng, dps):
    """Step `eng` until it has no work; returns the finished rids."""
    finished = []
    eng.start()
    try:
        while eng.has_work():
            finished += [r.rid for r in _step(eng, dps)]
    finally:
        eng.stop()
        eng.join_worker(timeout=10)
    return sorted(finished)


def _burst(vocab, lens, out_len, seed, prefix=()):
    rng = random.Random(seed)
    return [(len(prefix) + L, out_len,
             tuple(prefix) + tuple(rng.randrange(vocab) for _ in range(L)))
            for L in lens]


def _serve_both(model, trace, spec_kw, *, unified=None, handoff=None,
                raw=()):
    """Admit `trace` ((input_len, output_len, tokens) per request, its KV
    published on the bus: a dense cache, or with `handoff` a
    `PageHandoff`) and the raw prompts `raw` (no KV: staged by the
    unified engine) to DP 0 of a JAX and a port engine of the same
    shape, and step both to the end.  `unified` is the unified engine's
    (chunk, starve_limit); `handoff` turns on share_prefix.  Returns
    {side: (engine, {rid: tokens}, finished rids)}."""
    cfg, params, tcfg, tparams, _c = model
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            spec = JRE.EngineSpec(cfg, params, max_len=MAX_LEN, **spec_kw)
            mod, R, D = JRE, JRequest, JDecodeDPState
        else:
            spec = RE.EngineSpec(tcfg, tparams, max_len=MAX_LEN,
                                 device="cpu", **spec_kw)
            mod, R, D = RE, Request, DecodeDPState
        bus = mod.KVHandoffBus()
        if unified:
            eng = mod.RealUnifiedEngine(0, [0], spec, bus, chunk=unified[0],
                                        starve_limit=unified[1])
        else:
            eng = mod.RealDecodeEngine(0, [0], spec, bus,
                                       share_prefix=bool(handoff))
        dps = D(dp_id=0, instance_id=0, block_size=spec_kw.get(
            "block_size", 0))
        for rid, (L, n, toks) in enumerate(trace):
            r = R(rid=rid, arrival_time=0.0, input_len=L, output_len=n,
                  tokens=toks)
            if handoff:
                first, jph, tph = _page_handoffs(model, handoff[0],
                                                 handoff[1], list(toks))
                bus.publish(rid, jph if side == "jax" else tph, first)
            else:
                first, dense = _prefill(model, list(toks))
                bus.publish(rid, dense if side == "jax" else cache_from_numpy(
                    tcfg, jax.tree.map(np.asarray, dense), device="cpu"),
                    first)
            r.generated = 1                   # the prefill-emitted token
            dps.admit(L, reserve_len=L + n)
            eng.admit(0, r)
        for k, (L, n, toks) in enumerate(raw):
            r = R(rid=100 + k, arrival_time=0.0, input_len=L, output_len=n,
                  tokens=toks)
            dps.admit(L, reserve_len=L + n)
            eng.admit(0, r)
        done = _run(eng, dps)
        toks = {rid: list(bus.gen(rid).tokens)
                for rid in list(range(len(trace)))
                + [100 + k for k in range(len(raw))]}
        out[side] = (eng, toks, done)
    assert out["port"][2] == out["jax"][2] == sorted(out["port"][1])
    assert out["port"][1] == out["jax"][1]
    return out


@pytest.mark.parametrize("plane", ["padded", "paged"])
def test_peak_resident_matches_jax_pd(model, plane):
    """Six 20-token prompts joined from dense caches at equal KV memory
    (two max_len rows per DP): the padded plane holds two at a time, the
    paged plane all six (2 pages each of 12), on both packages."""
    spec_kw = dict(max_batch=2, max_new=3)
    if plane == "paged":
        spec_kw.update(block_size=BLOCK, decode_slots=8)
    trace = _burst(model[2].vocab_size, [20] * 6, 3, seed=5)
    out = _serve_both(model, trace, spec_kw)
    peaks = [out[s][0].peak_resident for s in ("jax", "port")]
    assert peaks == [2, 2] if plane == "padded" else peaks == [6, 6]


def test_peak_resident_matches_jax_page_handoff(model):
    """Three PageHandoffs that share a 32-token prefix joined at once
    into a DP with a prefix binder (pointed-at pages, eager
    copy-on-write of the shared tail)."""
    cfg, params, tcfg, tparams, _c = model
    spec_kw = dict(max_batch=4, max_new=6, block_size=BLOCK)
    jspec = JRE.EngineSpec(cfg, params, max_len=MAX_LEN, **spec_kw)
    tspec = RE.EngineSpec(tcfg, tparams, max_len=MAX_LEN, device="cpu",
                          **spec_kw)
    rng = random.Random(7)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(2 * BLOCK)]
    trace = _burst(tcfg.vocab_size, [8, 13, 5], 6, seed=8, prefix=prefix)
    out = _serve_both(model, trace, spec_kw, handoff=(jspec, tspec))
    assert [out[s][0].peak_resident for s in ("jax", "port")] == [3, 3]
    assert out["port"][0].blocks_shared == out["jax"][0].blocks_shared > 0


def test_peak_resident_matches_jax_unified_burst(model):
    """Four raw prompts admitted at once to the unified engine: all are
    staged as prefilling residents in one join, then decode."""
    trace = _burst(model[2].vocab_size, [40, 17, 33, 24], 4, seed=9)
    out = _serve_both(model, [], dict(max_batch=4, max_new=4,
                                      block_size=BLOCK, decode_slots=8),
                      unified=(32, 4), raw=trace)
    assert [out[s][0].peak_resident for s in ("jax", "port")] == [4, 4]
    assert [out[s][0].forced_grants for s in ("jax", "port")] == [0, 0]


def test_forced_grants_matches_jax_unified(model):
    """Four decoding residents use up a 4-token mixed budget while a
    1-token prompt waits: prefill starves for starve_limit - 1 steps,
    then the bound forces a minimum grant of max(1, 4 // 4) tokens,
    which completes the prompt; it decodes beside the residents."""
    vocab = model[2].vocab_size
    residents = _burst(vocab, [20, 26, 18, 31], 8, seed=11)
    prompt = _burst(vocab, [1], 3, seed=12)
    out = _serve_both(model, residents, dict(max_batch=4, max_new=8,
                                             block_size=BLOCK,
                                             decode_slots=8),
                      unified=(4, 3), raw=prompt)
    for side in ("jax", "port"):
        eng = out[side][0]
        assert (eng.forced_grants, eng.peak_resident,
                eng.prefill_tokens) == (1, 5, 1), side
