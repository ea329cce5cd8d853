"""PyTorch port: compiled sharded steps, on a logical 4-shard CPU mesh
(`make_engine_mesh(4, devices=["cpu"] * 4)`), in fp32.  On the CPU the
step runner (`serving.step_graphs.StepGraphs`) captures nothing but runs
its static-buffer handling around every step, so these tests hold that
handling on the merged cache:

  * `RealSBSServer(mesh=...)` serves with step graphs by default, and is
    token-exact against the JAX single-device server and against the
    port's eager sharded server: P/D, unified, and P/D with
    `prefix_cache=True` (page-native prefill, `PageHandoff` joins into
    the merged cache);
  * the runner's merged entries: the merged decode step through the
    runner equals the direct step bit for bit; a swapped shard pool,
    kv_pos map or expert weight slice raises; the exchange counters
    after N runs equal N times one step's;
  * `param_leaves` over `ShardedParams`, `add_exchanges`, and the rule
    by which `distributed.transfer.move` cuts a segmented capture.

JAX weights are bridged over (`params_from_numpy`); the JAX server runs
on its single CPU device.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import ServingConfig as JServingConfig
from repro.models import model as JM

from repro_torch.bridge import params_from_numpy
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import Request
from repro_torch.distributed.sharding import ExpertShards, param_leaves
from repro_torch.distributed.transfer import cutting, move
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe_ep as TEP
from repro_torch.serving.kv_pool import pad_block_table
from repro_torch.serving.real_engine import EngineSpec
from repro_torch.serving.server import RealSBSServer

MAX_LEN = 64
N_DP = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_PAIRS = {}


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params): the JAX init's
    weights, bridged."""
    if arch not in _PAIRS:
        cfg = get_arch(arch, reduced=True)
        jp = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        tcfg = t_get_arch(arch, reduced=True)
        tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        _PAIRS[arch] = (cfg, jp, tcfg, tp)
    return _PAIRS[arch]


def _mesh():
    return make_engine_mesh(N_DP, devices=["cpu"] * N_DP)


def _scfg(mixed=False):
    extra = {"mixed_batch": True, "mixed_chunk": 32} if mixed else {}
    return ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1,
                         decode_dp_per_instance=N_DP, chunk_size=32,
                         t_default=0.05, l_net=0.001, max_batch_per_dp=2,
                         block_size=8, **extra)


def _reqs(vocab, plane, R=Request):
    """The reference's sharded-plane traffic (6 prompts of 16 tokens,
    20 ms apart); for the prefix plane 8 prompts sharing a 20-token
    prefix, 50 ms apart."""
    rng = random.Random(7)
    if plane != "pd-prefix":
        return [R(rid=i, input_len=16, output_len=5, arrival_time=0.02 * i,
                  tokens=[rng.randrange(vocab) for _ in range(16)])
                for i in range(6)]
    prefix = [rng.randrange(vocab) for _ in range(20)]
    prompts = [prefix + [rng.randrange(vocab) for _ in range(5 + i)]
               for i in range(8)]
    return [R(rid=i, input_len=len(p), output_len=5, arrival_time=0.05 * i,
              tokens=tuple(p)) for i, p in enumerate(prompts)]


def _serve(srv, reqs):
    return {g.rid: g.tokens for g in srv.serve(reqs, timeout=120)}


_PLANES = ["pd", "unified", "pd-prefix"]


@pytest.mark.parametrize("plane", _PLANES)
def test_sharded_graph_server_token_exact_vs_eager_and_jax(plane):
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    cfg, jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    scfg = _scfg(plane == "unified")
    prefix = plane == "pd-prefix"
    sched = "immediate" if prefix else "sbs"
    srv_g = RealSBSServer(tcfg, tp, scfg, scheduler=sched, max_len=MAX_LEN,
                          max_new=5, prefix_cache=prefix, mesh=_mesh())
    assert srv_g.spec.sharded and srv_g.spec.step_graphs
    t_g = _serve(srv_g, _reqs(tcfg.vocab_size, plane))
    eager = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, max_new=5,
                       block_size=8, decode_slots=scfg.resolved_decode_slots,
                       mesh=_mesh(), step_graphs=False)
    srv_e = RealSBSServer(tcfg, tp, scfg, scheduler=sched, max_len=MAX_LEN,
                          max_new=5, prefix_cache=prefix, spec=eager,
                          mesh=_mesh())
    t_e = _serve(srv_e, _reqs(tcfg.vocab_size, plane))
    srv_j = JServer(cfg, jp, JServingConfig(**dataclasses.asdict(scfg)),
                    scheduler=sched, max_len=MAX_LEN, max_new=5,
                    prefix_cache=prefix)
    t_j = _serve(srv_j, _reqs(cfg.vocab_size, plane, JRequest))
    assert set(t_g) == set(range(len(_reqs(tcfg.vocab_size, plane))))
    assert t_g == t_e == t_j
    # every step went through the runner: the merged decode graph, and
    # the chunks' graphs by shard (unified), the dense chunk (P/D) or
    # the page-native chunk (prefix)
    eng = srv_g.decode_engines[0]
    keys = set(eng.graphs._entries)
    assert ("decode", "merged") in keys
    if plane == "unified":
        shards = {k[1] for k in keys if k[0] == "prefill"}
        assert shards and shards <= set(range(N_DP))
        assert eng.mixed_steps > 0
    else:
        pkeys = {k[0] for e in srv_g.engines for k in e.graphs._entries}
        assert pkeys == {"prefill" if prefix else "prefill-dense"}
        assert all(ex > 0 for ex, _b, _s in eng.ep_samples)
    if prefix:
        stats = srv_g.prefix_stats()
        assert stats["decode_blocks_shared"] > 0
    for st in eng._dp.values():
        st.pool.check()
        assert not st.occupied()
        # prefix binders keep the pages they published
        assert prefix or st.pool.used_count == 0


def _merged_case(spec, seed):
    """A merged cache with every DP's rows holding a random prefix, and
    per-shard feed tokens."""
    S, B = spec.paged_slots, spec.paged_pool_blocks
    cache = spec.merged_paged_cache()
    g = torch.Generator().manual_seed(seed)
    for k, c in enumerate(cache["shards"]):
        c["k"].normal_(generator=g)
        c["v"].normal_(generator=g)
        for s in range(S - 1):                  # the last row idle
            L = int(torch.randint(1, 3 * 8, (), generator=g))
            blocks = [1 + 3 * s + j for j in range(-(-L // 8))]
            c["block_tab"][s, :len(blocks)] = torch.tensor(blocks)
            for t in range(L):
                c["kv_pos"][blocks[t // 8], t % 8] = t
            c["cur"][s] = L
    toks = [torch.randint(0, spec.cfg.vocab_size, (S, 1), generator=g,
                          dtype=torch.int32) for _ in range(N_DP)]
    return cache, toks


def _spec():
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    return EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=8,
                      mesh=_mesh())


def test_merged_entry_equals_the_direct_step_and_guards_each_shard():
    spec = _spec()
    runner = spec.step_graphs_for()
    cache, toks = _merged_case(spec, seed=3)
    ref_cache = {"shards": [{n: t.clone() for n, t in c.items()}
                            for c in cache["shards"]],
                 "slots": cache["slots"], "blocks": cache["blocks"]}
    key = ("decode", "merged")
    lg, new = runner.run(key, spec.decode_fn, cache, token=toks)
    lg_d, new_d = spec.decode_fn(ref_cache, toks)
    assert torch.equal(lg, lg_d)
    for a, b in zip(new["shards"], new_d["shards"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    # the pools were written in place; the replaced entries came back new
    for a, c in zip(new["shards"], cache["shards"]):
        assert a["k"] is c["k"] and a["cur"] is not c["cur"]
    # a shard's pool, kv_pos map, or an expert slice that is not the
    # storage of the capture raises
    for name in ("k", "v", "kv_pos"):
        shards = list(new["shards"])
        shards[2] = dict(shards[2], **{name: shards[2][name].clone()})
        with pytest.raises(RuntimeError, match="of shard 2 is not the"):
            runner.run(key, spec.decode_fn, dict(new, shards=shards),
                       token=toks)
    w = spec.params["layers"][0]["moe"]["w_up"]
    assert isinstance(w, ExpertShards)
    old = w.shards[3]
    w.shards[3] = old.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            runner.run(key, spec.decode_fn, new, token=toks)
    finally:
        w.shards[3] = old
    runner.run(key, spec.decode_fn, new, token=toks)
    with pytest.raises(RuntimeError, match="captured with"):
        runner.run(key, spec.decode_fn, new, token=toks[:3])


def test_exchange_counts_over_runs_are_n_times_one_step():
    spec = _spec()
    runner = spec.step_graphs_for()
    cache, toks = _merged_case(spec, seed=4)
    mask = [torch.arange(spec.paged_slots) % 2 == 0] * N_DP
    with TEP.count_exchanges() as one:
        spec.masked_decode_fn(cache, toks, mask)
    assert one.exchanges == 2 * spec.cfg.num_layers and one.bytes > 0
    n = 3
    with TEP.count_exchanges() as st:
        for _ in range(n):
            _lg, cache = runner.run(("decode", "merged"),
                                    spec.masked_decode_fn, cache,
                                    token=toks, mask=mask)
    assert (st.exchanges, st.bytes) == (n * one.exchanges, n * one.bytes)
    # a replay's share, counted into the caller's block only
    TEP.add_exchanges(5, 100)
    with TEP.count_exchanges() as st:
        TEP.add_exchanges(*(one.exchanges, one.bytes))
    assert (st.exchanges, st.bytes) == (one.exchanges, one.bytes)
    assert st.seconds() is None


def test_param_leaves_cover_every_replica_and_expert_slice():
    spec = _spec()
    leaves = param_leaves(spec.params)
    ids = {id(t) for t in leaves}
    assert len(ids) == len(leaves)
    for layer in spec.params["layers"]:
        for name in ("w_gate", "w_up", "w_down"):
            shards = layer["moe"][name].shards
            assert all(id(t) in ids for t in shards)
        assert id(layer["moe"]["router"]) in ids
    _cfg, _jp, _tcfg, tp = _pair("granite-moe-1b-a400m")
    plain = param_leaves(tp)
    assert [t.data_ptr() for t in plain] == [
        t.data_ptr() for t in param_leaves(tp)]
    assert all(isinstance(t, torch.Tensor) for t in plain)


def test_move_cuts_only_where_a_tensor_crosses_devices():
    calls = []

    def cutter(tensors, devices):
        calls.append([str(d) for d in devices])
        return [t.to(d) for t, d in zip(tensors, devices)]
    a = torch.ones(3)
    with cutting(cutter):
        same = move([a, a], ["cpu", "cpu"])
        assert same[0] is a and not calls
        out = move([a, a], ["cpu", "meta"])
    assert calls == [["cpu", "meta"]]
    assert out[1].device.type == "meta"
    # outside a capture a move is `.to`
    assert move([a], ["meta"])[0].device.type == "meta" and len(calls) == 1
    with pytest.raises(ValueError):
        move([a], ["cpu", "cpu"])


def test_unified_chunk_keys_are_per_shard_with_local_slots():
    """The unified plane's chunk of global slot s runs on shard s // S
    with its local slot: through the runner and eagerly, the same
    logits and the same shard cache, and the other shards untouched."""
    spec = _spec()
    runner = spec.step_graphs_for()
    cache, _toks = _merged_case(spec, seed=6)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    slot = 2 * S + S - 1                        # shard 2's idle row
    tab = torch.tensor(pad_block_table([2 * B + 10, 2 * B + 11], spec.nbt),
                       dtype=torch.int32)

    def staged(c):
        c = TM.paged_clear_rows(dict(c, home=2), tab[:2])
        c.pop("home")
        return TM.paged_install_row(c, slot, tab, 0)
    cache = staged(cache)
    ids = torch.randint(0, spec.cfg.vocab_size, (1, 16),
                        generator=torch.Generator().manual_seed(8),
                        dtype=torch.int32)
    before = [c["cur"].clone() for c in cache["shards"]]
    lg, new = spec.paged_prefill(runner, ids, cache, slot)
    assert list(runner._entries) == [("prefill", 2, 16)]
    assert int(new["shards"][2]["cur"][S - 1]) == 16
    for k in (0, 1, 3):
        assert torch.equal(new["shards"][k]["cur"], before[k])
    fresh = staged(_merged_case(spec, seed=6)[0])
    lg_e, new_e = spec.paged_prefill(None, ids, fresh, slot)
    assert torch.equal(lg, lg_e)
    assert torch.equal(new["shards"][2]["k"], new_e["shards"][2]["k"])
