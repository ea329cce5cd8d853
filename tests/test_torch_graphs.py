"""PyTorch port: the compiled-step runner (`serving/step_graphs.py`) on
the CPU, where nothing is captured and each step is called on the
runner's static buffers.

Every step the engines run through the runner — padded and paged
decode, the unified engine's masked decode half, page-native prefill
chunks at several lengths and slots — gives bit for bit what a direct
call of the step function gives: logits, the pools written in place,
the new cursors and SSM and conv states (reduced deepseek-7b,
granite-moe-1b-a400m, minicpm3-4b, mamba2-370m and h2o-danube-3-4b,
fp32).  The runner leaves the pre-step cache's cursors and SSM and conv
states as they were (the drain parks that snapshot), raises when a pool
or a weight is not the storage it was first run on, and counts kernel
launches per replay.  `paged_prefill_step` with a tensor slot equals
the int slot and the JAX function on bridged weights.  Servers with
step graphs and without give the same tokens and reuse counters.
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

from repro_torch.bridge import cache_to_numpy, params_from_numpy
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import Request
from repro_torch.models import model as TM
from repro_torch.serving.real_engine import EngineSpec
from repro_torch.serving.server import RealSBSServer
from repro_torch.serving.step_graphs import (
    REPLACED, StepGraphs, add_counts, settle_counts,
)

MAX_LEN = 96
BLOCK = 16
NBT = MAX_LEN // BLOCK


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_MODELS = {}


def _model(name):
    """(cfg, fp32 params on the CPU) of one reduced model, made once."""
    if name not in _MODELS:
        cfg = t_get_arch(name, reduced=True)
        _MODELS[name] = (cfg, TM.init_params(cfg, seed=0, device="cpu"))
    return _MODELS[name]


def _ids(cfg, n, rng):
    return [rng.randrange(cfg.vocab_size) for _ in range(n)]


def _padded_cache(cfg, params, lens, seed):
    """A padded batch cache whose row b holds a prompt of lens[b] tokens
    (0: an idle row), prefilled in 16-token chunks and joined: the
    h2o-danube ring (window 64) wraps at 70."""
    rng = random.Random(seed)
    cache = TM.init_cache(cfg, len(lens), MAX_LEN, device="cpu")
    for b, L in enumerate(lens):
        if not L:
            continue
        one = TM.init_cache(cfg, 1, MAX_LEN, device="cpu")
        ids = _ids(cfg, L, rng)
        for at in range(0, L, 16):
            _, one = TM.prefill_chunk(cfg, params,
                                      torch.tensor([ids[at:at + 16]]), one)
        cache = TM.cache_join(cache, one, b)
    return cache


def _paged_cache(cfg, params, lens, seed, slots=4):
    """A paged cache of `slots` rows, each with a table of its own pages;
    row b holds a prompt of lens[b] tokens, prefilled in 16-token
    chunks through `paged_prefill_step`."""
    rng = random.Random(seed)
    cache = TM.init_paged_cache(cfg, slots, slots * NBT + 1, MAX_LEN, BLOCK,
                                device="cpu")
    cache["block_tab"] = torch.arange(
        1, slots * NBT + 1, dtype=torch.int32).reshape(slots, NBT)
    for b, L in enumerate(lens):
        ids = _ids(cfg, L, rng)
        for at in range(0, L, 16):
            _, cache = TM.paged_prefill_step(
                cfg, params, torch.tensor([ids[at:at + 16]]), cache, b)
    return cache


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _runner(params):
    return StepGraphs(params, "cpu", threading.RLock())


def _lockstep(fn, cache, args, key, runner, n_steps=3):
    """Run `fn` directly and through the runner side by side for
    `n_steps` decode steps (each feeding its argmax back): bit-identical
    logits and caches, and the pre-step cache's replaced entries
    untouched by the runner's step."""
    direct, served = _clone(cache), _clone(cache)
    for _ in range(n_steps):
        before = {k: (served[k], served[k].clone()) for k in served
                  if k in REPLACED}
        lg_d, direct = fn(direct, **args)
        lg_s, served = runner.run(key, fn, served, **args)
        assert torch.equal(lg_d, lg_s)
        _assert_same(direct, served)
        for k, (t, copy) in before.items():
            assert torch.equal(t, copy), k      # the pre-step snapshot
        args = dict(args, token=lg_d.argmax(-1).to(torch.int32)[:, None])
    return served


_DECODE_CASES = [
    ("deepseek-7b", "padded"), ("deepseek-7b", "paged"),
    ("deepseek-7b", "unified"), ("granite-moe-1b-a400m", "paged"),
    ("granite-moe-1b-a400m", "unified"), ("minicpm3-4b", "paged"),
    ("mamba2-370m", "padded"), ("h2o-danube-3-4b", "padded"),
]


@pytest.mark.parametrize("arch,plane", _DECODE_CASES,
                         ids=[f"{a}-{p}" for a, p in _DECODE_CASES])
def test_runner_decode_matches_direct_call(arch, plane):
    """Decode steps through the runner equal direct calls bit for bit:
    padded (dense K/V rows, the SWA ring past its wrap, SSM and conv
    states), paged (K/V pools, MoE, MLA latent pools) and the unified
    engine's masked decode half (a prefilling row masked out)."""
    cfg, params = _model(arch)
    lens = [70, 21, 0, 40]
    if plane == "padded":
        cache = _padded_cache(cfg, params, lens, seed=1)

        def fn(c, token):
            return TM.decode_step(cfg, params, token, c)
        args = {}
    else:
        cache = _paged_cache(cfg, params, lens, seed=1)
        if plane == "paged":
            def fn(c, token):
                return TM.paged_decode_step(cfg, params, token, c)
            args = {}
        else:
            def fn(c, token, mask):
                return TM.paged_decode_masked(cfg, params, token, c, mask)
            args = {"mask": torch.tensor([True, False, True, True])}
    args["token"] = torch.tensor([[3], [5], [7], [11]], dtype=torch.int32)
    _lockstep(fn, cache, args, ("decode", 0), _runner(params))


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m",
                                  "minicpm3-4b"])
def test_runner_prefill_chunks_match_direct_call(arch):
    """Page-native prefill chunks through the runner (one graph per chunk
    length, the slot a static input) equal direct calls with an int slot
    bit for bit, across chunk lengths, slots and repeats of a length."""
    cfg, params = _model(arch)
    cache = _paged_cache(cfg, params, [0, 0, 0, 0], seed=2)
    direct, served = _clone(cache), _clone(cache)
    runner = _runner(params)
    rng = random.Random(3)

    def fn(c, tokens, slot):
        return TM.paged_prefill_step(cfg, params, tokens, c, slot)
    for slot, n in ((0, 16), (2, 13), (1, 32), (0, 13), (2, 16), (3, 5)):
        toks = torch.tensor([_ids(cfg, n, rng)])
        pre = served["cur"].clone()
        pre_t = served["cur"]
        lg_d, direct = TM.paged_prefill_step(cfg, params, toks, direct, slot)
        lg_s, served = runner.run(("prefill", 0, n), fn, served,
                                  tokens=toks, slot=slot)
        assert torch.equal(lg_d, lg_s)
        _assert_same(direct, served)
        assert torch.equal(pre_t, pre) and served["cur"] is not pre_t
    assert runner.captured == 0 and runner.replays == 0   # the CPU


def test_runner_leaves_the_prestep_cache_untouched():
    """A step's new cursor and SSM and conv states are new tensors, never
    written into the pre-step cache's (the drain parks that snapshot),
    and not the runner's static buffers (the next step refills those):
    one mamba2 padded step and one deepseek-7b paged step."""
    for arch, paged in (("mamba2-370m", False), ("deepseek-7b", True)):
        cfg, params = _model(arch)
        if paged:
            cache = _paged_cache(cfg, params, [20, 0, 33, 9], seed=4)

            def fn(c, token):
                return TM.paged_decode_step(cfg, params, token, c)
        else:
            cache = _padded_cache(cfg, params, [20, 0, 33, 9], seed=4)

            def fn(c, token):
                return TM.decode_step(cfg, params, token, c)
        runner = _runner(params)
        tok = torch.tensor([[1], [2], [3], [4]], dtype=torch.int32)
        pre = dict(cache)
        snap = {k: v.clone() for k, v in cache.items() if k in REPLACED}
        _lg, new = runner.run(("decode", 0), fn, cache, token=tok)
        entry = runner._entries[("decode", 0)]
        for k, copy in snap.items():
            assert torch.equal(pre[k], copy), k
            if k != "block_tab":              # block_tab passes through
                assert new[k] is not pre[k]
                assert new[k].data_ptr() != entry.cache[k].data_ptr()
        assert torch.equal(new["cur"], snap["cur"] + 1)
        held = {k: new[k].clone() for k in new if k in REPLACED}
        runner.run(("decode", 0), fn, new, token=tok)
        for k, copy in held.items():
            assert torch.equal(new[k], copy), k


def test_runner_raises_on_replaced_storage():
    """A pool, a dense K/V stack or a weight that is not the storage the
    step was first run on raises; the step is not run again."""
    cfg, params = _model("deepseek-7b")
    cache = _paged_cache(cfg, params, [20, 5, 0, 0], seed=5)
    tok = torch.zeros((4, 1), dtype=torch.int32)
    runner = _runner(params)

    def fn(c, token):
        return TM.paged_decode_step(cfg, params, token, c)
    _lg, cache = runner.run(("decode", 0), fn, cache, token=tok)
    for name in ("k", "v", "kv_pos"):
        bad = dict(cache, **{name: cache[name].clone()})
        with pytest.raises(RuntimeError, match="not the storage"):
            runner.run(("decode", 0), fn, bad, token=tok)
    dense = _padded_cache(cfg, params, [9, 0], seed=5)
    runner.run(("decode", 1), lambda c, token: TM.decode_step(
        cfg, params, token, c), dense, token=tok[:2])
    with pytest.raises(RuntimeError, match="not the storage"):
        runner.run(("decode", 1), lambda c, token: TM.decode_step(
            cfg, params, token, c), dict(dense, k=dense["k"].clone()),
            token=tok[:2])
    w = params["layers"][0]["attn"]["w_q"]
    params["layers"][0]["attn"]["w_q"] = w.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            runner.run(("decode", 0), fn, cache, token=tok)
    finally:
        params["layers"][0]["attn"]["w_q"] = w
    with pytest.raises(RuntimeError, match="captured as"):
        runner.run(("decode", 0), fn, cache, token=tok[:2])


class _Counter:
    def __init__(self, n):
        self.launches = n


def test_launch_count_arithmetic():
    """A capture's warm-up and capture calls are taken back from the
    counters; each replay adds the capture's calls (two kernels: one
    called 3 times a step, one once, one never)."""
    ws = [_Counter(10), _Counter(4), _Counter(0)]
    before = [w.launches for w in ws]
    for w, n in zip(ws, (3, 1, 0)):          # warm-up
        w.launches += n
    warm = [w.launches for w in ws]
    for w, n in zip(ws, (3, 1, 0)):          # capture
        w.launches += n
    per = settle_counts(ws, before, warm, [w.launches for w in ws])
    assert per == [3, 1, 0]
    assert [w.launches for w in ws] == before
    for _ in range(5):
        add_counts(ws, per)
    assert [w.launches for w in ws] == [25, 9, 0]


def test_paged_prefill_tensor_slot_matches_int_slot_and_jax():
    """paged_prefill_step with a one-element tensor slot equals the int
    slot bit for bit, and both equal the JAX step (slot a traced scalar)
    on bridged reduced deepseek-7b: logits within 1e-4, cursors,
    tables and positions exact, pools within 1e-5."""
    jcfg = get_arch("deepseek-7b", reduced=True)
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    cfg = t_get_arch("deepseek-7b", reduced=True)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jstep = jax.jit(lambda p, t, c, s: JM.paged_prefill_step(jcfg, p, t, c, s))
    n_blocks = 3 * NBT + 1
    jc = JM.init_paged_cache(jcfg, 3, n_blocks, MAX_LEN, BLOCK)
    tc = TM.init_paged_cache(cfg, 3, n_blocks, MAX_LEN, BLOCK, device="cpu")
    tab = np.arange(1, n_blocks, dtype=np.int32).reshape(3, NBT)
    jc = dict(jc, block_tab=jnp.asarray(tab))
    tc["block_tab"] = torch.tensor(tab)
    tc_int = _clone(tc)
    rng = random.Random(6)
    for slot, n in ((1, 16), (0, 7), (1, 13), (2, 32), (0, 16)):
        ids = _ids(cfg, n, rng)
        jl, jc = jstep(jparams, jnp.asarray([ids], jnp.int32), jc,
                       jnp.int32(slot))
        tl, tc = TM.paged_prefill_step(cfg, params, torch.tensor([ids]), tc,
                                       torch.tensor([slot]))
        il, tc_int = TM.paged_prefill_step(cfg, params, torch.tensor([ids]),
                                           tc_int, slot)
        assert torch.equal(tl, il)
        _assert_same(tc, tc_int)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() <= 1e-4
    j, t = jax.tree.map(np.asarray, jc), cache_to_numpy(cfg, tc)
    for key in ("cur", "block_tab", "kv_pos"):
        assert np.array_equal(j[key], t[key]), key
    for a, b in zip(j["blocks"]["p0"], t["blocks"]["p0"]):
        assert np.abs(a[:, 1:] - b[:, 1:]).max() <= 1e-5


def _waves(cfg, plane):
    """Unified and padded P/D: one wave of four unrelated prompts.  On
    pages with prefix_cache=True, the waves of tests/test_torch_prefix.py
    (a seed prompt of a 48-token prefix + 10, then the seed again and
    four prompts sharing only the prefix), whose claims resolve the same
    whatever order a wave runs in."""
    rng = random.Random(7)
    if plane != "pd-prefix":
        return [[_ids(cfg, L, rng) for L in (17, 40, 33, 64)]]
    prefix = _ids(cfg, 48, rng)
    seed = prefix + _ids(cfg, 10, rng)
    return [[seed], [seed] + [prefix + _ids(cfg, 10, rng) for _ in range(4)]]


@pytest.mark.parametrize("plane", ["unified", "pd-padded", "pd-prefix"])
def test_servers_with_and_without_step_graphs_agree(plane):
    """The same requests on a server whose spec runs the steps through
    the runner and on one that runs them eagerly give the same tokens
    and, on pages with prefix_cache=True, the same reuse counters."""
    cfg, params = _model("deepseek-7b")
    # on pages with prefix sharing one decode DP unit of 8 rows, as
    # tests/test_torch_prefix.py's parity test: which of two units a
    # prompt lands on, and so what it shares, follows timing
    prefix = plane == "pd-prefix"
    scfg = ServingConfig(
        num_prefill_instances=1 if prefix else 2,
        prefill_dp_per_instance=2 if prefix else 1,
        num_decode_instances=1, decode_dp_per_instance=1 if prefix else 2,
        chunk_size=32, t_default=0.05, l_net=0.001,
        max_batch_per_dp=8 if prefix else 4, n_limit=64,
        block_size=0 if plane == "pd-padded" else BLOCK,
        **(dict(mixed_batch=True, mixed_chunk=32) if plane == "unified"
           else {}))
    out = {}
    for graphs in (True, False):
        spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                          max_batch=scfg.max_batch_per_dp,
                          max_new=6, block_size=scfg.block_size,
                          decode_slots=(scfg.resolved_decode_slots
                                        if scfg.block_size else 0),
                          device="cpu", step_graphs=graphs)
        srv = RealSBSServer(cfg, params, scfg, scheduler="sbs", spec=spec,
                            prefix_cache=plane == "pd-prefix")
        tokens = {}
        for w, wave in enumerate(_waves(cfg, plane)):
            gens = srv.serve([Request(rid=10 * w + i, arrival_time=0.05 * i,
                                      input_len=len(p), output_len=3 + i % 2,
                                      tokens=tuple(p))
                              for i, p in enumerate(wave)], timeout=120)
            assert len(gens) == len(wave)
            tokens.update({g.rid: g.tokens for g in gens})
        out[graphs] = (tokens, srv.prefix_stats())
        engines = [*srv.engines, *srv.decode_engines]
        assert all((e.graphs is not None) == graphs for e in engines)
    assert out[True] == out[False]
    if plane == "pd-prefix":
        assert out[True][1]["prefill_full_hits"] == 1
