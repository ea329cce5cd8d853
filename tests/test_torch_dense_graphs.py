"""PyTorch port: the compiled dense P/D prefill (`EngineSpec.dense_prefill`
through a prefill engine's pool of dense rows, `_DenseRows`) on the CPU,
where the step runner fills the same static buffers as on the card and
calls the step.

  * The runner's chunks (the rows' K/V and positions copied into the
    static batch-1 working cache and back, the cursor and SSM and conv
    states carried in the row) equal direct `prefill_chunk` calls on a
    fresh batch-1 cache bit for bit, the eager path on the rows equals
    both, and all three equal the JAX `prefill_chunk` on bridged weights
    (fp32: logits within 1e-4; every cache entry within 2e-5 of its
    largest magnitude, see `_valid_equal`) on reduced
    deepseek-7b, h2o-danube-3-4b (its window-64 ring wraps),
    mamba2-370m, a MoE-free jamba hybrid (layer pattern (SSM, DENSE))
    and granite-moe-1b-a400m, with prompts interleaved chunk by chunk
    and a released row reused;
  * `cache_clear_row` resets what every step reads; a reused row gives
    the tokens a fresh `init_cache` row gives;
  * the payload a dense prefill engine publishes shares no storage with
    its pool and stays intact after its row is reused; the pool grows
    instead of deferring a prompt, and counts it;
  * the P/D server on the padded plane gives the same tokens with step
    graphs and without, and the JAX server's, under sbs, sbs-la and
    immediate;
  * the dense prefill engines of every server built on one spec share
    its chunk graphs and working cache, with counters of their own.
"""
import dataclasses
import random
import threading

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
from repro_torch.core.types import DispatchCommand, Request
from repro_torch.models import model as TM
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, RealPrefillEngine, _DenseRows,
)
from repro_torch.serving.server import RealSBSServer

MAX_LEN = 96
LOGIT_TOL = 1e-4
ARCHS = ["deepseek-7b", "h2o-danube-3-4b", "mamba2-370m", "jamba-hybrid",
         "granite-moe-1b-a400m"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_PAIRS = {}


def _pair(name):
    """(JAX cfg, JAX params, port cfg, port params) of one reduced model,
    made once; "jamba-hybrid" is reduced jamba with the layer pattern
    (SSM, DENSE) and so no MoE layer."""
    if name not in _PAIRS:
        arch = "jamba-v0.1-52b" if name == "jamba-hybrid" else name
        cfg = get_arch(arch, reduced=True)
        tcfg = t_get_arch(arch, reduced=True)
        if name == "jamba-hybrid":
            cfg = dataclasses.replace(cfg,
                                      layer_pattern=(JLK.SSM, JLK.DENSE))
            tcfg = dataclasses.replace(tcfg,
                                       layer_pattern=(TLK.SSM, TLK.DENSE))
        jp = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        _PAIRS[name] = (cfg, jp, tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _PAIRS[name]


def _valid_equal(row, ref, exact):
    """Two batch-1 dense caches agree on what a step reads: cursor and
    kv_pos exactly, SSM states and conv tails, and the K/V entries
    kv_pos marks written (a reused row keeps its previous tenant's K/V
    elsewhere).  `exact`: bit for bit; else each entry within 2e-5 of
    its largest magnitude: against the JAX package the entries carry
    the two implementations' fp32 rounding through up to 80 tokens of
    chunked prefill, and the hybrid's SSM state after a 30-token chunk
    (padded to the SSD scan's chunk) differs by 1.5e-5 of its largest
    magnitude, its K/V behind it by 6e-6."""
    assert torch.equal(row["cur"], ref["cur"])
    assert torch.equal(row["kv_pos"], ref["kv_pos"])
    written = ref["kv_pos"][0] >= 0
    for name in ("k", "v", "ssm", "conv_x", "conv_bc"):
        if name not in ref:
            continue
        a, b = row[name], ref[name]
        if name in ("k", "v"):
            a, b = a[:, :, written], b[:, :, written]
        if exact:
            assert torch.equal(a, b), name
        else:
            tol = 2e-5 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, name


def _prompts(vocab, lens, seed):
    rng = random.Random(seed)
    return [[rng.randrange(vocab) for _ in range(n)] for n in lens]


# a schedule of (prompt, chunk length) in the order the engine runs them:
# prompts interleave, chunks of 16 and shorter tails; prompt 0 (80
# tokens) wraps h2o-danube's window-64 ring; prompt 2 starts after
# prompt 0 has finished and takes its row
_SCHEDULE = [(0, 16), (1, 16), (0, 16), (1, 13), (0, 32), (0, 16),
             (2, 16), (2, 7), (3, 16), (2, 30), (3, 5)]
_LENS = (80, 29, 53, 21)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_runner_matches_direct_call_and_jax(arch):
    """Chunks through the runner (graphs) and through the eager path on
    the pool's rows equal direct `prefill_chunk` calls on fresh batch-1
    caches bit for bit — logits, cursors, positions, written K/V, SSM
    and conv states — and the JAX `prefill_chunk` within 1e-4 (logits)
    and `_valid_equal`'s tolerance (caches); a released row is reused by
    a later prompt."""
    cfg, jp, tcfg, tp = _pair(arch)
    jchunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
    prompts = _prompts(tcfg.vocab_size, _LENS, seed=1)
    modes = {}
    for graphs in (True, False):
        spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, device="cpu",
                          step_graphs=graphs)
        modes[graphs] = (spec, spec.step_graphs_for(), _DenseRows(spec, 2),
                         spec.request_cache() if graphs else None, {})
    direct = {i: TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
              for i in range(len(prompts))}
    jax_c = {i: JM.init_cache(cfg, 1, MAX_LEN) for i in range(len(prompts))}
    at = {i: 0 for i in range(len(prompts))}
    for p, n in _SCHEDULE:
        ids = prompts[p][at[p]:at[p] + n]
        toks = torch.tensor([ids], dtype=torch.int32)
        lg_d, direct[p] = TM.prefill_chunk(tcfg, tp, toks, direct[p])
        lg_j, jax_c[p] = jchunk(jp, jnp.asarray([ids], jnp.int32), jax_c[p])
        assert np.abs(np.asarray(lg_j) - lg_d.numpy()).max() <= LOGIT_TOL
        for spec, graphs, rows, work, row_of in modes.values():
            if p not in row_of:
                row_of[p] = rows.take()
            b, r = row_of[p]
            lg = spec.dense_prefill(graphs, toks, rows.caches[b], r, at[p],
                                    work)
            assert torch.equal(lg, lg_d)
            _valid_equal(TM.cache_row(rows.caches[b], r), direct[p],
                         exact=True)
        at[p] += n
        if at[p] == len(prompts[p]):
            jc = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jax_c[p]),
                                  device="cpu")
            _valid_equal(direct[p], jc, exact=False)
            for _s, _g, rows, _w, row_of in modes.values():
                rows.release(row_of.pop(p))
    assert at == {i: n for i, n in enumerate(_LENS)}
    spec, graphs, rows, _w, _r = modes[True]
    assert rows.grown == 0 and len(rows.free) == 2
    # one entry per chunk length, none captured on the CPU
    assert sorted(k[1] for k in graphs._entries) == [5, 7, 13, 16, 30, 32]
    assert graphs.captured == 0 and graphs.replays == 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-7b"])
def test_cleared_row_is_a_fresh_row(arch):
    """`cache_clear_row` resets a used row of a batch cache to what
    `init_cache` makes for every entry a step reads (the other rows are
    left), and a prompt prefilled into the cleared row gives the same
    logits, bit for bit, as into a fresh batch-1 cache."""
    _c, _j, tcfg, tp = _pair(arch)
    rng = torch.Generator().manual_seed(3)
    pool = TM.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    for name, t in pool.items():          # a previous tenant's garbage
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=rng))
        else:
            t.copy_(torch.randint(-1, 90, t.shape, generator=rng))
    before = {k: v.clone() for k, v in pool.items()}
    TM.cache_clear_row(pool, 1)
    fresh = TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    _valid_equal(TM.cache_row(pool, 1), fresh, exact=True)
    for name, t in pool.items():
        rows = [0, 2]
        if t.dim() and name in ("k", "v", "ssm", "conv_x", "conv_bc"):
            assert torch.equal(t[:, rows], before[name][:, rows]), name
        else:
            assert torch.equal(t[rows], before[name][rows]), name
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, device="cpu",
                      step_graphs=False)
    ids = _prompts(tcfg.vocab_size, (40,), seed=4)[0]
    at = 0
    for n in (16, 16, 8):
        toks = torch.tensor([ids[at:at + n]], dtype=torch.int32)
        lg = spec.dense_prefill(None, toks, pool, 1, at)
        lg_f, fresh = TM.prefill_chunk(tcfg, tp, toks, fresh)
        assert torch.equal(lg, lg_f)
        at += n
    _valid_equal(TM.cache_row(pool, 1), fresh, exact=True)


class _Loop:
    def __init__(self):
        self.done = threading.Event()

    def post(self, kind, payload):
        self.done.set()


def _prefill(eng, loop, req):
    """Dispatch the whole of `req` to `eng` and run passes until it is
    done; returns the completed requests."""
    eng.enqueue(DispatchCommand(0, {0: [(req, req.input_len)]}), 0.0)
    done = []
    while eng.has_work():
        loop.done.clear()
        assert eng.start_pass(0.0) is not None
        assert loop.done.wait(60)
        done += eng.finish_pass(0.0).completed
    return done


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_published_payload_is_a_copy_and_the_pool_grows(graphs):
    """A finished prompt's payload on the bus shares no storage with the
    engine's pool or working cache, and stays as published after its row
    is reset and reused; two prompts in flight at once on a pool of one
    row grow the pool by one batch cache (counted) instead of waiting."""
    _c, _j, tcfg, tp = _pair("mamba2-370m")
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, device="cpu",
                      prefill_slots=1, step_graphs=graphs)
    bus = KVHandoffBus()
    eng = RealPrefillEngine(0, [0], 16, spec, bus)
    chunks = {}
    inner = eng._run_chunk
    eng._run_chunk = lambda req, tok: (
        chunks.setdefault(req.rid, []).append(tok), inner(req, tok))[1]
    loop = _Loop()
    eng.bind_loop(loop)
    eng.start()
    try:
        p0, p1, p2 = _prompts(tcfg.vocab_size, (40, 24, 30), seed=5)
        reqs = [Request(rid=i, arrival_time=0.0, input_len=len(p),
                        output_len=2, tokens=tuple(p))
                for i, p in enumerate((p0, p1, p2))]
        for r in reqs:
            r.remaining_prefill = 0
        assert [r.rid for r in _prefill(eng, loop, reqs[0])] == [0]
        payload = bus.gen(0).cache
        kept = {k: v.clone() for k, v in payload.items()}
        pool = {t.untyped_storage().data_ptr()
                for c in eng.rows.caches + [eng._work or {}]
                for t in c.values()}
        assert not pool & {t.untyped_storage().data_ptr()
                           for t in payload.values()}
        assert eng.rows.grown == 0 and len(eng.rows.free) == 1
        # two prompts at once: the second takes a row of a new batch cache
        eng.enqueue(DispatchCommand(0, {0: [(reqs[1], 24), (reqs[2], 30)]}),
                    0.0)
        done = []
        while eng.has_work():
            loop.done.clear()
            assert eng.start_pass(0.0) is not None
            assert loop.done.wait(60)
            done += eng.finish_pass(0.0).completed
        assert sorted(r.rid for r in done) == [1, 2]
        assert eng.rows.grown == 1 and len(eng.rows.caches) == 2
        assert len(eng.rows.free) == 2
        for k, v in payload.items():
            assert torch.equal(v, kept[k]), k
        # each payload equals a direct prefill over the chunks it ran
        assert chunks[2][0] < 16            # shared a pass with prompt 1
        for r in reqs:
            ref = TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
            ids, a = list(r.tokens), 0
            for n in chunks[r.rid]:
                lg, ref = TM.prefill_chunk(tcfg, tp, torch.tensor(
                    [ids[a:a + n]], dtype=torch.int32), ref)
                a += n
            _valid_equal(bus.gen(r.rid).cache, ref, exact=True)
            assert bus.gen(r.rid).tokens == [int(lg[0].argmax())]
    finally:
        eng.stop()
        eng.join_worker()


def _pd_scfg():
    return ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=16, t_default=0.05, l_net=0.001,
        max_batch_per_dp=4, block_size=0, n_limit=64)


@pytest.mark.parametrize("scheduler", ["sbs", "sbs-la", "immediate"])
def test_pd_padded_server_graphs_eager_and_jax_agree(scheduler):
    """The same requests behind the JAX server and behind the port's P/D
    server on the padded plane, with step graphs (the dense prefill
    chunks through the runner) and without: the same tokens."""
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    cfg, jp, tcfg, tp = _pair("deepseek-7b")
    scfg = _pd_scfg()
    rng = random.Random(6)
    lens = [rng.randrange(16, 60) for _ in range(5)]
    prompts = _prompts(tcfg.vocab_size, lens, seed=7)
    out = {}
    for name in ("jax", "graphs", "eager"):
        if name == "jax":
            srv = JServer(cfg, jp, JServingConfig(**dataclasses.asdict(scfg)),
                          scheduler=scheduler, max_len=MAX_LEN, max_new=5)
            R = JRequest
        else:
            spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=4,
                              max_new=5, device="cpu",
                              step_graphs=name == "graphs")
            srv = RealSBSServer(tcfg, tp, scfg, scheduler=scheduler,
                                spec=spec, device="cpu")
            R = Request
        reqs = [R(rid=i, arrival_time=0.02 * i, input_len=len(p),
                  output_len=5, tokens=tuple(p))
                for i, p in enumerate(prompts)]
        gens = srv.serve(reqs, timeout=120)
        out[name] = {g.rid: g.tokens for g in gens}
        if name != "jax":
            engines = [*srv.engines, *srv.decode_engines]
            assert all((e.graphs is not None) == (name == "graphs")
                       for e in engines)
            for e in srv.engines:
                assert len(e.rows.free) == e.rows.n * len(e.rows.caches)
    assert sorted(out["jax"]) == list(range(len(prompts)))
    assert out["graphs"] == out["eager"] == out["jax"]


def test_dense_prefill_engines_share_the_specs_chunk_graphs():
    """Every dense prefill engine of a spec, in every server built on
    it, replays the spec's chunk graphs over the spec's working cache
    (`EngineSpec.dense_graphs`): one set of entries, so a chunk length
    is captured once a spec, as the reference compiles a chunk shape
    once; each engine's runner counts its own replays and only the first
    owns the pools.  Two servers on one spec serve the same requests in
    turn, and give the tokens the eager server gives."""
    _c, _j, tcfg, tp = _pair("deepseek-7b")
    scfg = _pd_scfg()
    prompts = _prompts(tcfg.vocab_size, (37, 16, 50, 21), seed=9)

    def serve(srv):
        reqs = [Request(rid=i, arrival_time=0.02 * i, input_len=len(p),
                        output_len=4, tokens=tuple(p))
                for i, p in enumerate(prompts)]
        return {g.rid: g.tokens for g in srv.serve(reqs, timeout=120)}

    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=4, max_new=4,
                      device="cpu")
    servers = [RealSBSServer(tcfg, tp, scfg, scheduler="sbs", spec=spec,
                             device="cpu") for _ in range(2)]
    first = servers[0].engines[0]
    engines = [e for s in servers for e in s.engines]
    assert len(engines) == 4 and len({id(e.graphs) for e in engines}) == 4
    assert all(e.graphs._entries is first.graphs._entries
               and e._work is first._work for e in engines)
    assert [e.graphs._owns_pools for e in engines] == [True] + [False] * 3
    assert list(first.graphs._entries) == [("prefill-dense", 16)]
    eager = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", device="cpu",
                          spec=EngineSpec(tcfg, tp, max_len=MAX_LEN,
                                          max_batch=4, max_new=4,
                                          device="cpu", step_graphs=False))
    want = serve(eager)
    assert sorted(want) == list(range(len(prompts)))
    assert serve(servers[0]) == want
    keys = set(first.graphs._entries)
    assert len(keys) > 1 and all(k[0] == "prefill-dense" and 0 < k[1] <= 16
                                 for k in keys)
    assert serve(servers[1]) == want
    assert set(first.graphs._entries) >= keys
    assert all(e.graphs._entries is first.graphs._entries for e in engines)
    # the CPU captures nothing; each runner counted only its own steps
    assert all(e.graphs.captured == 0 and e.graphs.replays == 0
               for e in engines)
