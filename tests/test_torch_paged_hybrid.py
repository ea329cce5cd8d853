"""PyTorch port: a hybrid's per-slot SSM state beside paged K/V, in fp32
on the CPU, on reduced jamba-v0.1-52b (an SSM_MOE layer, then an
attention layer; capacity factor 8, so no (token, expert) pair drops)
and on the MoE-free hybrid (the layer pattern (SSM, DENSE)), with the
JAX init's weights bridged over:

  * `init_paged_cache`, `paged_cache_join` and `paged_cache_take` equal
    JAX's (`cache_to_numpy`), and a taken slot is a copy;
  * `paged_decode_step` over several steps, with idle rows on -1 tables
    and a late join, equals JAX's (logits within 1e-4, pools and conv
    tails within 1e-5, SSM states within 1e-5 of their largest
    magnitude) and the serial decode's tokens;
  * a row masked out of a step (`paged_decode_masked`, and the merged
    step on four logical shards) keeps its SSM state and conv tails as
    it keeps `cur`, and decodes on as if the step had not happened;
  * the merged cache (`shard_paged_cache`) splits the per-slot entries
    by slot, and the merged decode step equals the unsharded one;
  * the step runner over a paged hybrid cache equals the direct steps
    bit for bit, each step's output state the next one's input, and a
    swapped SSM weight raises;
  * the P/D server on the paged plane, on one device and sharded over
    four logical CPU shards (with and without step graphs), and a
    preempted and re-joined paged row, are token-exact against the JAX
    step oracle on the serve's own chunk boundaries (a hybrid's tokens
    depend on where prefill chunks start: the SSD scan chunks each
    prefill chunk from its start);
  * page-native prefill, page sharing and the unified plane refuse a
    hybrid with ValueError in both packages, as the reference does.
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
from repro.serving.kv_pool import BlockPool, pad_block_table

from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.config.base import LayerKind as TLK
from repro_torch.config.base import ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import DecodeDPState, Request
from repro_torch.distributed.sharding import (
    shard_paged_cache, unshard_paged_cache,
)
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import model as TM
from repro_torch.serving.plane import ASYNC
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, RealDecodeEngine, RealPrefillEngine,
    RealUnifiedEngine,
)
from repro_torch.serving.server import RealSBSServer
from repro_torch.serving.step_graphs import StepGraphs

MAX_LEN = 96
BLOCK = 16
NBT = MAX_LEN // BLOCK
N_NEW = 5
LOGIT_TOL = 1e-4
N_DP = 4
MODELS = ["jamba", "jamba-hybrid"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Model:
    """One reduced hybrid on both sides: JAX cfg and params, the port's
    cfg and bridged params, and the JAX step oracle (jitted)."""

    def __init__(self, name):
        cfg = get_arch("jamba-v0.1-52b", reduced=True)
        tcfg = t_get_arch("jamba-v0.1-52b", reduced=True)
        if name == "jamba-hybrid":
            cfg = dataclasses.replace(cfg, layer_pattern=(JLK.SSM, JLK.DENSE))
            tcfg = dataclasses.replace(tcfg,
                                       layer_pattern=(TLK.SSM, TLK.DENSE))
        self.cfg, self.tcfg = cfg, tcfg
        self.params = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            tcfg, jax.tree.map(np.asarray, self.params), device="cpu")
        self._chunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
        self._decode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
        self._paged = jax.jit(
            lambda p, t, c: JM.paged_decode_step(cfg, p, t, c))

    def prefill(self, ids, chunks=None):
        """(first token, logits, dense batch-1 cache) of the JAX chunked
        prefill over `chunks` (lengths; default 16-token chunks)."""
        chunks = chunks or [16] * (len(ids) // 16) + (
            [len(ids) % 16] if len(ids) % 16 else [])
        cache, at = JM.init_cache(self.cfg, 1, MAX_LEN), 0
        for n in chunks:
            lg, cache = self._chunk(self.params, jnp.asarray(
                [ids[at:at + n]], jnp.int32), cache)
            at += n
        return int(jnp.argmax(lg[0])), cache

    def tokens(self, ids, n, chunks=None):
        """n tokens of the serial path over the prefill `chunks`."""
        t0, cache = self.prefill(ids, chunks)
        toks = [t0]
        for _ in range(n - 1):
            lg, cache = self._decode(self.params,
                                     jnp.asarray([[toks[-1]]], jnp.int32),
                                     cache)
            toks.append(int(jnp.argmax(lg[0])))
        return toks


_MODELS = {}


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    if request.param not in _MODELS:
        _MODELS[request.param] = _Model(request.param)
    return _MODELS[request.param]


def _jamba():
    if "jamba" not in _MODELS:
        _MODELS["jamba"] = _Model("jamba")
    return _MODELS["jamba"]


def _prompts(cfg, lens, seed):
    rng = random.Random(seed)
    return [[rng.randrange(cfg.vocab_size) for _ in range(L)] for L in lens]


def _argmax(lg):
    return [int(x) for x in np.argmax(np.asarray(lg), axis=-1)]


def _assert_paged_close(m, jc, tc, null_block=True):
    """Same cursors, tables and positions; pools and conv tails within
    1e-5 (outside the null block, which takes garbage writes), SSM
    states within 1e-5 of their largest magnitude."""
    j = cache_from_numpy(m.tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert set(j) == set(tc)
    for key in ("cur", "block_tab"):
        assert torch.equal(j[key], tc[key]), key
    lo = 1 if null_block else 0
    assert torch.equal(j["kv_pos"][lo:], tc["kv_pos"][lo:])
    for name in ("k", "v", "conv_x", "conv_bc", "ssm"):
        a, b = j[name], tc[name]
        if name in ("k", "v"):
            a, b = a[:, lo:], b[:, lo:]
        tol = 1e-5 * max(1.0, float(a.abs().max())) if name == "ssm" \
            else 1e-5
        assert float((a - b).abs().max()) <= tol, name


def _table(ids, jax_side=False):
    row = pad_block_table(ids, NBT)
    if jax_side:
        return jnp.asarray(row, jnp.int32)
    return torch.tensor(row, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the cache functions against JAX's
# ---------------------------------------------------------------------------

def test_init_paged_cache_matches_jax(model):
    """K/V pools over the attention stack only, fp32 SSM states and conv
    tails per slot over the SSM stack: JAX's layout, leaf for leaf."""
    jc = jax.tree.map(np.asarray, JM.init_paged_cache(model.cfg, 4, 12,
                                                      MAX_LEN, BLOCK))
    c = TM.init_paged_cache(model.tcfg, 4, 12, MAX_LEN, BLOCK, device="cpu")
    assert c["k"].shape[:3] == (1, 12, BLOCK)
    assert c["ssm"].shape[:2] == (1, 4) and c["ssm"].dtype == torch.float32
    tc = cache_to_numpy(model.tcfg, c)
    assert jax.tree.structure(jc) == jax.tree.structure(tc)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_paged_join_and_take_match_jax(model):
    """A dense prefill joined into slot 1 of a paged cache (pages for K/V,
    the slot's rows for SSM state), then taken back: both equal JAX's;
    the taken cache is a copy; the cleared slot keeps its state (the
    reference drops only the table row)."""
    ids = _prompts(model.cfg, (29,), seed=1)[0]
    _t0, dense = model.prefill(ids)
    blocks = [3, 7, 5]
    jc = JM.init_paged_cache(model.cfg, 3, 10, MAX_LEN, BLOCK)
    jc = JM.paged_cache_join(model.cfg, jc, dense, 1, _table(blocks, True))
    tc = TM.init_paged_cache(model.tcfg, 3, 10, MAX_LEN, BLOCK, device="cpu")
    src = cache_from_numpy(model.tcfg, jax.tree.map(np.asarray, dense),
                           device="cpu")
    tc = TM.paged_cache_join(model.tcfg, tc, src, 1, _table(blocks))
    _assert_paged_close(model, jc, tc, null_block=False)
    assert torch.equal(tc["ssm"][:, 1], src["ssm"][:, 0])
    jt = jax.tree.map(np.asarray, JM.paged_cache_take(model.cfg, jc, 1))
    tt = TM.paged_cache_take(model.tcfg, tc, 1)
    t = cache_to_numpy(model.tcfg, tt)
    assert jax.tree.structure(jt) == jax.tree.structure(t)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(t)):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b).max() <= 1e-5
    snap = {n: x.clone() for n, x in tt.items()}
    for name in ("ssm", "conv_x", "conv_bc", "k"):
        tc[name].add_(1.0)                        # the pools move on
    assert all(torch.equal(snap[n], tt[n]) for n in tt)
    cleared = TM.paged_cache_clear_slot(tc, 1)
    assert (cleared["block_tab"][1] == -1).all()
    assert cleared["ssm"] is tc["ssm"]


def _lockstep(model, decode, c, join, n_steps=N_NEW + 2):
    """Two requests joined into slots 0 and 2 of a 4-slot cache, a third
    joining slot 1 at step 2 (slot 3 idle throughout, -1 table), then
    batched decode with `decode(cache, tokens) -> (logits, cache)`;
    returns (each request's tokens, logits of every step, caches after
    every step)."""
    prompts = _prompts(model.cfg, (23, 37, 11), seed=0)
    hand = [model.prefill(p) for p in prompts]
    pool = BlockPool(16, BLOCK)
    toks, next_tok, slot_of = {}, [0] * 4, {}
    lgs, caches = [], []

    def admit(r, slot, c):
        ids = pool.alloc(pool.blocks_for(len(prompts[r]) + N_NEW - 1))
        c = join(c, hand[r][1], slot, ids)
        toks[slot] = [hand[r][0]]
        next_tok[slot] = hand[r][0]
        slot_of[r] = slot
        return c

    for r, slot in ((0, 0), (1, 2)):
        c = admit(r, slot, c)
    for step in range(n_steps):
        if step == 2:
            c = admit(2, 1, c)
        active = [s for s in toks if len(toks[s]) < N_NEW]
        if not active:
            break
        lg, c = decode(c, next_tok)
        lgs.append((np.asarray(lg), active))
        # the port writes its pools in place: keep a copy of each step's
        caches.append({n: t.clone() for n, t in c.items()}
                      if isinstance(c["cur"], torch.Tensor) else c)
        nxt = _argmax(lg)
        for s in active:
            toks[s].append(nxt[s])
            next_tok[s] = nxt[s]
    return [toks[slot_of[i]] for i in range(3)], prompts, hand, lgs, caches


def _jax_join(model):
    def join(c, dense, slot, ids):
        return JM.paged_cache_join(model.cfg, c, dense, slot,
                                   _table(ids, True))
    return join


def _torch_join(model):
    def join(c, dense, slot, ids):
        src = cache_from_numpy(model.tcfg, jax.tree.map(np.asarray, dense),
                               device="cpu")
        return TM.paged_cache_join(model.tcfg, c, src, slot, _table(ids))
    return join


def test_paged_decode_steps_match_jax(model):
    """Batched paged decode with idle rows (-1 tables) and a late join,
    in lockstep on both frameworks: the same logits on the decoding
    rows, the same caches after every step, the serial tokens."""
    def jdecode(c, toks):
        return model._paged(model.params,
                            jnp.asarray(toks, jnp.int32)[:, None], c)

    def tdecode(c, toks):
        return TM.paged_decode_step(model.tcfg, model.tparams,
                                    torch.tensor(toks)[:, None], c)
    jtok, prompts, hand, jlg, jcs = _lockstep(
        model, jdecode, JM.init_paged_cache(model.cfg, 4, 16, MAX_LEN, BLOCK),
        _jax_join(model))
    ttok, _p, _h, tlg, tcs = _lockstep(
        model, tdecode,
        TM.init_paged_cache(model.tcfg, 4, 16, MAX_LEN, BLOCK, device="cpu"),
        _torch_join(model))
    serial = [model.tokens(p, N_NEW) for p in prompts]
    assert jtok == serial and ttok == serial
    assert len(jlg) == len(tlg) >= N_NEW
    for (a, rows), (b, rows_t) in zip(jlg, tlg):
        assert rows == rows_t
        assert np.abs(a[rows] - b[rows]).max() <= LOGIT_TOL
    for jc, tc in zip(jcs, tcs):
        _assert_paged_close(model, jc, tc)


# ---------------------------------------------------------------------------
# the masked-row trap, the merged cache, the step runner
# ---------------------------------------------------------------------------

def _joined_cache(model, slots=4, rows=(0, 2), shards=1):
    """A paged cache of `slots` slots with prompts joined into `rows`,
    its blocks split into `shards` equal ranges (a slot's pages come from
    its shard's range, as the sharded plane's per-DP pools hand them
    out); returns (cache, {slot: first token}, {slot: prompt})."""
    prompts = _prompts(model.cfg, (23, 37, 30, 17)[:len(rows)], seed=3)
    per = 4 * slots // shards + 1                # blocks of one shard
    c = TM.init_paged_cache(model.tcfg, slots, per * shards, MAX_LEN, BLOCK,
                            device="cpu")
    pools = [BlockPool(per, BLOCK, base=k * per) for k in range(shards)]
    first, by_slot = {}, {}
    for slot, p in zip(rows, prompts):
        t0, dense = model.prefill(p)
        pool = pools[slot // (slots // shards)]
        ids = pool.alloc(pool.blocks_for(len(p) + N_NEW))
        c = _torch_join(model)(c, dense, slot, ids)
        first[slot], by_slot[slot] = t0, p
    return c, first, by_slot


def test_masked_row_keeps_its_ssm_state(model):
    """`paged_decode_masked` with row 2 masked out: row 2's cursor, SSM
    state and conv tails are what they were (the rows it masked in
    stepped), and decoding row 2 afterwards gives the serial tokens, as
    if the masked step had fed it nothing."""
    c, first, prompts = _joined_cache(model)
    mask = torch.tensor([True, False, False, False])
    toks = torch.tensor([[first[0]], [0], [first[2]], [0]])
    _lg, out = TM.paged_decode_masked(model.tcfg, model.tparams, toks, c,
                                      mask)
    for name in ("ssm", "conv_x", "conv_bc"):
        assert torch.equal(out[name][:, 2], c[name][:, 2]), name
        assert not torch.equal(out[name][:, 0], c[name][:, 0]), name
    assert out["cur"].tolist() == [24, 0, 37, 0]
    got = [first[2]]
    for _ in range(N_NEW - 1):
        nt = torch.zeros(4, 1, dtype=torch.long)
        nt[2, 0] = got[-1]
        lg, out = TM.paged_decode_step(model.tcfg, model.tparams, nt, out)
        got.append(_argmax(lg)[2])
    assert got == model.tokens(prompts[2], N_NEW)


def test_merged_cache_carries_slot_state(model):
    """`shard_paged_cache` puts each slot's SSM rows on its shard and
    `unshard_paged_cache` undoes it; the merged decode step (plain and
    masked) equals the unsharded step on the same cache: logits within
    1e-5, the same cache, a masked-out row's state kept."""
    mesh = make_engine_mesh(N_DP, devices=["cpu"] * N_DP)
    c, first, _p = _joined_cache(model, slots=8, rows=(0, 3, 5, 6),
                                  shards=N_DP)
    merged = shard_paged_cache(c, mesh)
    assert all(s["ssm"].shape[1] == 2 for s in merged["shards"])
    assert torch.equal(merged["shards"][2]["ssm"][:, 1], c["ssm"][:, 5])
    back = unshard_paged_cache(merged, "cpu")
    assert all(torch.equal(back[n], c[n]) for n in c)
    toks = torch.zeros(8, 1, dtype=torch.long)
    for s, t in first.items():
        toks[s, 0] = t
    mask = torch.tensor([True, False, False, True, False, False, True,
                         False])
    for m in (None, mask):
        ref_c = {n: t.clone() for n, t in c.items()}
        mer = shard_paged_cache(ref_c, mesh)
        if m is None:
            lg1, c1 = TM.paged_decode_step(model.tcfg, model.tparams, toks,
                                           ref_c)
            lg2, m2 = TM.paged_decode_step(model.tcfg, model.tparams, toks,
                                           mer)
        else:
            lg1, c1 = TM.paged_decode_masked(model.tcfg, model.tparams, toks,
                                             ref_c, m)
            lg2, m2 = TM.paged_decode_masked(model.tcfg, model.tparams, toks,
                                             mer, m)
            assert torch.equal(c1["ssm"][:, 5], c["ssm"][:, 5])
        assert float((lg1 - lg2).abs().max()) <= 1e-5
        u = unshard_paged_cache(m2, "cpu")
        for n in ("cur", "block_tab"):
            assert torch.equal(u[n], c1[n]), n
        for n in ("ssm", "conv_x", "conv_bc"):
            assert float((u[n] - c1[n]).abs().max()) <= 1e-5, n
            if m is not None:
                assert torch.equal(u[n][:, 5], c[n][:, 5]), n


def test_step_runner_on_a_paged_hybrid_cache(model):
    """The step runner over a paged hybrid cache (its SSM stacks copied
    into static buffers before each step, cloned out after) equals the
    direct steps bit for bit over several steps, each step reading the
    state the last one returned; the pre-step cache is left as it was;
    a swapped SSM weight raises."""
    c, first, _p = _joined_cache(model)
    params = model.tparams
    g = StepGraphs(params, torch.device("cpu"), threading.RLock())

    def fn(cache, token):
        return TM.paged_decode_step(model.tcfg, params, token, cache)
    direct = {n: t.clone() for n, t in c.items()}
    run = c
    toks = [first.get(s, 0) for s in range(4)]
    for _ in range(3):
        t = torch.tensor(toks)[:, None]
        before = {n: x.clone() for n, x in run.items()}
        lg_r, new_run = g.run(("decode", 0), fn, run, token=t)
        for n in ("ssm", "conv_x", "conv_bc", "cur"):
            assert torch.equal(run[n], before[n]), n      # snapshot intact
        lg_d, direct = fn(direct, t)
        assert torch.equal(lg_r, lg_d)
        for n in direct:
            assert torch.equal(new_run[n], direct[n]), n
        run = new_run
        toks = _argmax(lg_d)
    layer = next(i for i, p in enumerate(params["layers"]) if "mamba" in p)
    mp = params["layers"][layer]["mamba"]
    name = next(iter(mp))
    old = mp[name]
    mp[name] = old.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            g.run(("decode", 0), fn, run, token=torch.tensor(toks)[:, None])
    finally:
        mp[name] = old


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------

def _requests(cfg, n=4, out_len=5, seed=5, lens=(16, 48)):
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        L = rng.randrange(*lens)
        reqs.append(Request(
            rid=i, arrival_time=i * 0.02, input_len=L, output_len=out_len,
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    return reqs


def _record_chunks(srv):
    """Prefill chunk lengths per request, as the port's engines ran them."""
    chunks = {}
    for eng in srv.engines:
        inner = eng._run_chunk
        eng._run_chunk = (lambda req, tok, _f=inner: (
            chunks.setdefault(req.rid, []).append(tok), _f(req, tok))[1])
    return chunks


def _pd_scfg(n_dp=2, **kw):
    return ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=n_dp,
        chunk_size=32, t_default=0.05, l_net=0.001, max_batch_per_dp=2,
        block_size=kw.pop("block_size", BLOCK), **kw)


def _step(eng, dps):
    done = threading.Event()
    eng._post = lambda kind, payload: done.set()
    assert eng.start_step([dps], 0.0) is ASYNC
    assert done.wait(60)
    return eng.finish_step(0.0, [dps])


def _check_serve(model, srv, reqs):
    """Every request finishes with the JAX step oracle's tokens over the
    chunks the serve ran; the decode pools and slots drain."""
    chunks = _record_chunks(srv)
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [r.rid for r in reqs]
    for g, r in zip(gens, reqs):
        assert g.tokens == model.tokens(list(r.tokens), r.output_len,
                                        chunks=chunks[r.rid]), r.rid
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            st.pool.check()
            assert st.pool.used_count == 0 and not st.occupied()
    return chunks


@pytest.mark.parametrize("scheduler", ["sbs-la", "immediate"])
def test_pd_paged_hybrid_server_matches_jax_oracle(model, scheduler):
    """P/D on the paged plane: dense prefill (SSD scan and the attention
    layer's contiguous K/V), the handoff joined into pages and slot rows
    (`paged_cache_join`), batched paged decode with step graphs (the
    default; on the CPU the runner's buffer handling around direct
    calls)."""
    srv = RealSBSServer(model.tcfg, model.tparams, _pd_scfg(),
                        scheduler=scheduler, max_len=MAX_LEN, max_new=N_NEW,
                        device="cpu")
    assert srv.spec.paged and srv.spec.step_graphs
    assert not srv.spec.prefix_sharable
    assert "ssm" in srv.spec.paged_cache()
    _check_serve(model, srv, _requests(model.tcfg))


def test_paged_hybrid_preempt_readmit_token_exact():
    """A paged jamba row is preempted (`paged_cache_take`: its pages and
    its slot's SSM state parked on the bus as a dense batch-1 cache, its
    pages and slot freed), re-joined through `paged_cache_join`, and
    finishes with the serial tokens; so does the row beside it."""
    model = _jamba()
    spec = EngineSpec(model.tcfg, model.tparams, max_len=MAX_LEN,
                      max_batch=2, max_new=6, block_size=BLOCK,
                      device="cpu")
    bus = KVHandoffBus()
    eng = RealDecodeEngine(0, [0], spec, bus)
    rng = random.Random(7)
    reqs = [Request(rid=i, arrival_time=0.0, input_len=L, output_len=6,
                    tokens=tuple(rng.randrange(model.tcfg.vocab_size)
                                 for _ in range(L)),
                    priority=2 - 2 * i)
            for i, L in enumerate((24, 37))]
    want = {r.rid: model.tokens(list(r.tokens), r.output_len) for r in reqs}
    dps = DecodeDPState(dp_id=0, instance_id=0, block_size=BLOCK)
    for r in reqs:
        t0, dense = model.prefill(list(r.tokens))
        bus.publish(r.rid, cache_from_numpy(
            model.tcfg, jax.tree.map(np.asarray, dense), device="cpu"), t0)
        r.generated = 1                      # the prefill-emitted token
        dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
        eng.admit(0, r)
    eng.start()
    try:
        finished = list(_step(eng, dps))      # joins both, one step
        st = eng._dp[0]
        used = st.pool.used_count
        victim = eng.preempt(0)
        assert victim is reqs[0] and st.pool.used_count < used
        parked = bus.gen(0).cache
        assert int(parked["cur"][0]) == 25
        assert parked["ssm"].shape[1] == 1 and parked["conv_x"].shape[1] == 1
        assert parked["k"].shape[2] == MAX_LEN
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
    st.pool.check()
    assert st.pool.used_count == 0 and not st.occupied()


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_sharded_pd_hybrid_server_matches_jax_oracle(graphs):
    """Reduced jamba on the sharded P/D plane over four logical CPU
    shards (1 decode instance × 4 DP merged, EP over the 4 experts):
    token-exact against the step oracle on the serve's chunks, with and
    without step graphs; every step that decoded covered the merged
    slots and made the EP exchanges of the SSM_MOE layer; the merged
    cache drains.  The dense chunk runs on the lead device outside the
    mesh context (as the reference's `jit_prefill_chunk`), so its MoE is
    the single-program one over the split expert weights: no chunk
    length has to divide over the devices."""
    model = _jamba()
    mesh = make_engine_mesh(N_DP, devices=["cpu"] * N_DP)
    scfg = _pd_scfg(n_dp=N_DP, block_size=8)
    spec = EngineSpec(model.tcfg, model.tparams, max_len=64,
                      max_batch=scfg.max_batch_per_dp, max_new=N_NEW,
                      block_size=8, decode_slots=scfg.resolved_decode_slots,
                      mesh=mesh, step_graphs=graphs)
    srv = RealSBSServer(model.tcfg, model.tparams, scfg, scheduler="sbs",
                        max_len=64, max_new=N_NEW, spec=spec, mesh=mesh)
    assert "ssm" in srv.decode_engines[0]._group.cache["shards"][0]
    reqs = _requests(model.tcfg, n=6, lens=(12, 40))
    _check_serve(model, srv, reqs)
    eng = srv.decode_engines[0]
    rows = len(eng._group.slots)
    assert eng.step_samples and all(r == rows
                                    for _d, _a, r in eng.step_samples)
    for (_d, active, _r), (ex, nbytes, _s) in zip(eng.step_samples,
                                                  eng.ep_samples):
        if active:
            assert ex == 2 and nbytes > 0
    if graphs:
        assert eng.graphs.stats()["graphs"] == 0       # nothing captured
        assert eng.graphs._entries                     # the runner ran


# ---------------------------------------------------------------------------
# what a hybrid is refused, in both packages
# ---------------------------------------------------------------------------

def _jax_server_raises(model, **kw):
    from repro.serving.server import RealSBSServer as JServer
    base = dict(num_prefill_instances=1, prefill_dp_per_instance=1,
                num_decode_instances=1, decode_dp_per_instance=2,
                max_batch_per_dp=2, block_size=BLOCK)
    base.update(kw.pop("scfg", {}))
    with pytest.raises(ValueError):
        JServer(model.cfg, model.params, JServingConfig(**base),
                max_len=MAX_LEN, **kw)
    with pytest.raises(ValueError):
        RealSBSServer(model.tcfg, model.tparams, ServingConfig(**base),
                      max_len=MAX_LEN, device="cpu", **kw)


@pytest.mark.parametrize("plane", ["page-native", "unified"])
def test_hybrid_refusals_in_both_packages(model, plane):
    """Page-native prefill (with page sharing) and the unified plane
    refuse a hybrid with ValueError, the servers and the engines, as
    the reference does; so does `paged_prefill_step` itself."""
    from repro.serving import real_engine as JRE
    spec = EngineSpec(model.tcfg, model.tparams, max_len=MAX_LEN,
                      max_batch=2, block_size=BLOCK, device="cpu")
    jspec = JRE.EngineSpec(model.cfg, model.params, max_len=MAX_LEN,
                           max_batch=2, block_size=BLOCK)
    if plane == "page-native":
        _jax_server_raises(model, prefix_cache=True)
        for RE, sp in ((JRE, jspec), (None, spec)):
            cls = RealPrefillEngine if RE is None else RE.RealPrefillEngine
            bus = KVHandoffBus() if RE is None else RE.KVHandoffBus()
            with pytest.raises(ValueError):
                cls(0, [0], 32, sp, bus, page_native=True)
        c = TM.init_paged_cache(model.tcfg, 2, 8, MAX_LEN, BLOCK,
                                device="cpu")
        with pytest.raises(ValueError):
            TM.paged_prefill_step(model.tcfg, model.tparams,
                                  torch.zeros(1, 4, dtype=torch.long), c, 0)
        with pytest.raises(ValueError):
            JM.paged_prefill_step(
                model.cfg, model.params, jnp.zeros((1, 4), jnp.int32),
                JM.init_paged_cache(model.cfg, 2, 8, MAX_LEN, BLOCK), 0)
    else:
        _jax_server_raises(model, scfg=dict(mixed_batch=True))
        for RE, sp in ((JRE, jspec), (None, spec)):
            cls = RealUnifiedEngine if RE is None else RE.RealUnifiedEngine
            bus = KVHandoffBus() if RE is None else RE.KVHandoffBus()
            with pytest.raises(ValueError):
                cls(0, [0], sp, bus)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 6h, rehearsed at the reduced size
# ---------------------------------------------------------------------------

def _chip_smoke():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    return chip_smoke, [paged_decode_attention, paged_prefill_attention,
                        flash_prefill, decode_attention, ssd_chunk]


def test_chip_smoke_hybrid_phase_rehearsed():
    """chip_smoke.py's hybrid phase (the paged P/D serve with its logits
    chain: served = the eager replay of the served chunks and expert
    sets, bit for bit, then that replay in fp32 against the plain fp32
    forward; its graphs-vs-eager bit A/B, the sharded P/D serve with 2
    exchanges an MoE layer a merged step) on reduced jamba in fp32; on
    the CPU the wrappers take their plain versions, so no launch is
    counted."""
    chip_smoke, counters = _chip_smoke()
    model = _jamba()
    rep = chip_smoke.serve_hybrid_phase(
        counters, "cpu", cfg=model.tcfg, params=model.tparams, n_requests=4,
        lens=(128, 400), outs=(4, 8))
    pd, sh = rep["pd"], rep["sharded"]
    assert pd["plane"] == "P/D, paged decode"
    assert pd["logits_rel_err"] <= 1e-4 and sh["logits_rel_err"] <= 1e-4
    for r in (pd, sh):
        assert r["served_equals_eager_replay"]
        assert r["logits_checked_by"] == "replay"
        assert r["fp32_replay_rel_err"] <= 1e-4
    assert pd["bits"]["same_tokens"] and pd["bits"]["same_first_logits"]
    assert sh["ep_exchanges_per_decode_step"] == 2
    assert set(pd["launches"].values()) == set(sh["launches"].values()) \
        == {0}


def test_chip_smoke_hybrid_check_chain_in_bf16_rehearsed():
    """The hybrid check's chain as phase 6h runs it, on a bf16 serve of
    reduced jamba (the JAX weights cast to bf16, the fp32 leaves kept):
    the P/D paged serve's first-token logits equal the eager replay of
    its served chunks and expert sets bit for bit (`exact_replay`), and
    after `widen_params` that replay in fp32 agrees with the plain fp32
    forward over the same chunks and expert sets within 1e-4."""
    from repro_torch.bridge import _FP32_LEAVES
    chip_smoke, counters = _chip_smoke()
    model = _jamba()

    def bf16(node, name=""):
        if isinstance(node, dict):
            return {k: bf16(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [bf16(v) for v in node]
        return node if name in _FP32_LEAVES else node.to(torch.bfloat16)
    params = bf16(model.tparams)
    assert params["embed"].dtype == torch.bfloat16
    cases = []
    rep = chip_smoke.serve_pd(
        model.tcfg, params, "cpu", counters, tag="[hybrid pd serve]",
        launched=chip_smoke.HYBRID_KERNELS, block_size=chip_smoke.BLOCK,
        routes=True, exact_replay=cases, n_requests=4, lens=(128, 400),
        outs=(4, 8), profile=False)
    assert rep["logits_checked_by"] == "replay" and rep["dtype"] == "bfloat16"
    assert len(cases) == 4 and all(len(c[1]) >= 1 for c in cases)
    chip_smoke.widen_params(params)
    assert params["embed"].dtype == torch.float32
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    worst = chip_smoke.check_fp32_replay(model.tcfg, params, cases,
                                         chip_smoke.MAX_LEN, "cpu",
                                         "[hybrid pd serve]")
    assert worst <= 1e-4


def test_hybrid_chunking_check_rehearsed(tmp_path):
    """scripts/hybrid_chunking_check.py on reduced jamba on the CPU, in
    fp32: over the 256-token chunking and two random ones of each of the
    8 prompts, the port's eager `prefill_chunk` and chip_smoke's plain
    forward over the same boundaries and expert sets agree within 1e-4
    of the largest logit, and every row is written out."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "chunking.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    run = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts",
                                      "hybrid_chunking_check.py"),
         "--reduced", "--device", "cpu", "--splits", "2", "--dtypes",
         "float32", "--out", str(out)], capture_output=True, text=True,
        env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    rows = json.loads(out.read_text())["dtypes"]["float32"]
    assert len(rows) == 8 * 3
    assert max(r["rel"] for r in rows) <= 1e-4
