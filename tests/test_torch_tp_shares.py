"""PyTorch port: tensor parallelism that holds only its shares, on
logical CPU shards of `make_engine_mesh(2, 2)` (two DP units of two
model ranks; internvl2-1b also on a (1, 4) mesh), in fp32, with the JAX
package's weights bridged over (`params_from_numpy`):

  * the dense prefill chunk on a DP's model ranks (`prefill_chunk` over a
    row split over them, `split_dense_cache`) equals the unsharded
    `prefill_chunk` on the same row over two chunks, within 1e-5 of the
    largest: logits, each rank's K/V share and a hybrid's SSM state and
    conv tail shares; its collectives are the ones its layers call for
    (heads split, the row-parallel form, split shared experts, an MoE
    once from rank 0's rows, SSM layers by heads), on reduced
    granite-moe-1b-a400m, deepseek-7b, deepseek-7b with 3 heads
    (row-parallel), granite with one KV head ("granite-kv1": its query
    heads divide the ranks, its KV head does not), minicpm3-4b,
    deepseek-v3-671b (shared experts), jamba-v0.1-52b and the MoE-free
    hybrid;
  * reduced whisper-large-v3's merged decode step on the (2, 2) mesh,
    its cross-attention split by heads over each slot's encoder K/V
    split the same way, against the JAX paged decode step over N_STEPS
    greedy steps;
  * the P/D server on the (2, 2) mesh, its dense prefill rows split over
    DP 0's ranks (and, with `prefix_cache=True`, its page-native pool),
    token-exact against the JAX single-device server on reduced
    deepseek-v3-671b and granite-kv1;
  * no whole replica: per-device weight storage (counted by storage)
    equals the count `tp_axis` gives on every architecture, no rank
    holds a leaf that `tp_axis` splits whole or as a view, no rank piece
    shares storage with the caller's tree, and `params_on` refuses a TP
    tree;
  * chip_smoke.py's new legs of phase 6k rehearsed at the reduced size:
    the dense chunk's counts, the `[tp weights]` check, the internvl2-1b
    (1, 4) and whisper (2, 2) step checks.
"""
import dataclasses
import os
import random
import sys

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
from repro_torch.config.base import ParallelConfig, ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import Request
from repro_torch.distributed import transfer as TT
from repro_torch.distributed.sharding import (
    cache_tp_axis, is_merged, param_leaves, params_on, place_params,
    rank_share, shard_paged_cache, tp_axis, tp_weight_report,
    unshard_paged_cache,
)
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import model as TM
from repro_torch.serving.kv_pool import pad_block_table
from repro_torch.serving.server import RealSBSServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64
BLOCK = 8
N_DP, M = 2, 2
TOL = 1e-5
ARCHS = ["granite-moe-1b-a400m", "deepseek-7b", "deepseek-7b-heads3",
         "granite-kv1", "minicpm3-4b", "deepseek-v3-671b", "jamba-v0.1-52b",
         "jamba-hybrid"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_PAIRS = {}


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced
    `arch`: "deepseek-7b-heads3" is deepseek-7b with 3 heads of 64 (they
    do not divide the 2 ranks: the row-parallel form), "granite-kv1"
    granite-moe-1b-a400m with 1 KV head (its 4 query heads divide, its
    KV head does not: the row-parallel form, w_q too), "jamba-hybrid"
    jamba with the layer pattern (SSM, DENSE)."""
    if arch not in _PAIRS:
        base = {"deepseek-7b-heads3": "deepseek-7b",
                "granite-kv1": "granite-moe-1b-a400m",
                "jamba-hybrid": "jamba-v0.1-52b"}.get(arch, arch)
        cfg = get_arch(base, reduced=True)
        tcfg = t_get_arch(base, reduced=True)
        kw = {"deepseek-7b-heads3": dict(num_heads=3, num_kv_heads=3,
                                         head_dim=64),
              "granite-kv1": dict(num_kv_heads=1)}.get(arch, {})
        cfg = dataclasses.replace(cfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
        if arch == "jamba-hybrid":
            cfg = dataclasses.replace(cfg, layer_pattern=(JLK.SSM, JLK.DENSE))
            tcfg = dataclasses.replace(tcfg,
                                       layer_pattern=(TLK.SSM, TLK.DENSE))
        jp = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        _PAIRS[arch] = (cfg, jp, tcfg, tp)
    return _PAIRS[arch]


def _mesh(data=N_DP, model=M):
    return make_engine_mesh(data, model, devices=["cpu"] * (data * model))


def _par(tcfg, mesh):
    E = tcfg.moe.num_experts if tcfg.moe is not None else 0
    if E and E % mesh.size == 0:
        return ParallelConfig(expert_axes=("data", "model"))
    return ParallelConfig()


def _rel(a, b):
    a = torch.as_tensor(np.array(a, np.float32))
    b = torch.as_tensor(np.array(b, np.float32))
    assert a.shape == b.shape
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _chunk_calls(tcfg, tp, Mr=M):
    """The collectives of a dense chunk on a DP's Mr ranks: the
    embedding's (vocabulary slices all-reduced, d_model slices
    all-gathered), per attention layer an all-reduce (split heads: the
    partial outputs; the row-parallel form: the partial q|k|v, then its
    output's d_model slices all-gathered), two per SSM layer (the gated
    norm's squares, out_proj), one per split dense FFN, per MoE layer a
    broadcast of rank 0's routed rows (and an all-reduce of split shared
    experts), then the logits' gather (vocabulary slices) or reduce
    (d_model slices)."""
    V = tcfg.vocab_size
    calls = {}

    def add(kind, n=1):
        calls[kind] = calls.get(kind, 0) + n
    add("all_reduce" if V % Mr == 0 else "all_gather")
    for p in tp["layers"]:
        if "mamba" in p:
            add("all_reduce", 2)
        else:
            add("all_reduce")
            if "w_q" in p["attn"] and not (tcfg.num_heads % Mr == 0 and
                                           tcfg.num_kv_heads % Mr == 0):
                add("all_gather")
        if "moe" in p:
            add("broadcast")
            if "shared_gate" in p["moe"]:
                add("all_reduce")
        elif "mlp" in p:
            add("all_reduce")
    add("gather" if V % Mr == 0 else "reduce")
    return calls


# ---------------------------------------------------------------------------
# the dense prefill chunk on a DP's model ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_chunk_on_ranks_equals_unsharded(arch):
    _cfg, _jp, tcfg, tp = _pair(arch)
    mesh = _mesh()
    placed = place_params(tcfg, tp, mesh, _par(tcfg, mesh))
    whole = TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    split = TM.split_dense_cache(tcfg, 1, MAX_LEN, torch.float32,
                                 mesh.devices[:M])
    assert split["model"] == M and len(split["shards"]) == M
    g = torch.Generator().manual_seed(3)
    for n in (11, 5):          # the second chunk continues the first's
        toks = torch.randint(0, tcfg.vocab_size, (1, n), generator=g)
        lg_1, whole = TM.prefill_chunk(tcfg, tp, toks, whole)
        with TT.count_collectives() as st:
            lg_s, split = TM.prefill_chunk(tcfg, placed, toks, split)
        assert st.calls == _chunk_calls(tcfg, tp), st.calls
        assert _rel(lg_s, lg_1) <= TOL
        for m, c in enumerate(split["shards"]):
            assert set(c) == set(whole)
            for name, t in whole.items():
                want = rank_share(t, cache_tp_axis(tcfg, name, M), m, M)
                assert c[name].shape == want.shape, name
                if t.is_floating_point():
                    assert float((c[name] - want).abs().max()) <= TOL * max(
                        float(t.abs().max()), 1e-30), (name, m)
                else:
                    assert torch.equal(c[name], want), (name, m)


# ---------------------------------------------------------------------------
# whisper: the split cross-attention against the JAX paged step
# ---------------------------------------------------------------------------

W_SLOTS, W_STEPS = 4, 5
W_LENS, W_SLOT_OF = (5, 9, 13), (2, 0, 3)       # slot 1 stays idle


def test_whisper_split_cross_attention_step_vs_jax():
    cfg, jp, tcfg, tp = _pair("whisper-large-v3")
    nbt = MAX_LEN // BLOCK
    nblocks = W_SLOTS * nbt
    rng = np.random.default_rng(11)
    frames = (rng.normal(size=(len(W_LENS), cfg.encoder_seq_len,
                               cfg.d_model)) * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(len(W_LENS), max(W_LENS)))
    jpre = jax.jit(lambda p, t, e: JM.prefill(cfg, p, t, embeds=e,
                                              max_len=MAX_LEN))
    jc = JM.init_paged_cache(cfg, W_SLOTS, nblocks, MAX_LEN, BLOCK)
    firsts = np.zeros((W_SLOTS, 1), np.int32)
    for r, (n, slot) in enumerate(zip(W_LENS, W_SLOT_OF)):
        tab = pad_block_table(list(range(1 + slot * nbt, (slot + 1) * nbt)),
                              nbt)
        jl, jd = jpre(jp, jnp.asarray(toks[r:r + 1, :n], jnp.int32),
                      jnp.asarray(frames[r:r + 1]))
        firsts[slot, 0] = int(np.argmax(np.asarray(jl)[0]))
        jc = JM.paged_cache_join(cfg, jc, jd, slot, jnp.asarray(tab,
                                                                jnp.int32))
    tc = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    mesh = _mesh()
    merged = shard_paged_cache(tc, mesh, tcfg)
    for c in merged["shards"]:                   # each rank its heads
        assert c["enc_k"].shape[-2] == tcfg.num_kv_heads // M
    placed = place_params(tcfg, tp, mesh, ParallelConfig())
    for m in range(M):
        xa = placed.ranks[(torch.device("cpu"), m)]["layers"][0]["xattn"]
        assert xa["w_q"].shape[1] == tcfg.num_heads // M
        assert xa["w_o"].shape[0] == tcfg.num_heads // M
    jdec = jax.jit(lambda p, t, c: JM.paged_decode_step(cfg, p, t, c))
    tok = firsts
    # per step: the embedding (vocabulary slices), each layer's
    # attention, cross-attention and FFN partials, the logits' gather
    want = {"all_reduce": 1 + 3 * tcfg.num_layers, "gather": 1}
    for _ in range(W_STEPS):
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        with TT.count_collectives() as st:
            tl, merged = TM.paged_decode_step(tcfg, placed,
                                              torch.tensor(tok), merged)
        assert st.calls == want
        assert _rel(tl, np.asarray(jl)) <= TOL
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(nxt, tl.argmax(-1).numpy())
        tok = nxt[:, None]
    back = unshard_paged_cache(merged, "cpu", tcfg)
    ref = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    B = nblocks // N_DP
    live = torch.arange(nblocks) % B != 0
    for name in ("k", "v"):
        assert _rel(back[name][:, live], ref[name][:, live]) <= TOL, name
    for name in ("enc_k", "enc_v", "cur"):
        assert torch.equal(back[name], ref[name]), name


# ---------------------------------------------------------------------------
# servers: the dense (and page-native) P/D path on the ranks
# ---------------------------------------------------------------------------

def _scfg():
    return ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1,
                         decode_dp_per_instance=N_DP, chunk_size=32,
                         t_default=0.05, l_net=0.001, max_batch_per_dp=2,
                         block_size=BLOCK)


def _reqs(vocab, R=Request, prefix=0):
    rng = random.Random(7)
    head = [rng.randrange(vocab) for _ in range(prefix)]
    return [R(rid=i, input_len=prefix + 16, output_len=5,
              arrival_time=0.02 * i,
              tokens=head + [rng.randrange(vocab) for _ in range(16)])
            for i in range(6)]


@pytest.mark.parametrize("arch,prefix", [("deepseek-v3-671b", False),
                                         ("granite-kv1", False),
                                         ("granite-kv1", True)],
                         ids=["deepseek-v3-dense", "kv1-dense",
                              "kv1-page-native"])
def test_tp_pd_server_on_ranks_token_exact_vs_jax(arch, prefix):
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    cfg, jp, tcfg, tp = _pair(arch)
    scfg = _scfg()
    n_pre = 12 if prefix else 0
    srv = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", max_len=MAX_LEN,
                        max_new=5, prefix_cache=prefix, mesh=_mesh())
    eng = srv.engines[0]
    pool = eng.cache if prefix else eng.rows.caches[0]
    # the prefill engine's rows live split over DP 0's ranks
    assert is_merged(pool) and len(pool["shards"]) == M
    assert [c["cur"].device for c in pool["shards"]] == list(
        srv.spec.mesh.devices[:M])
    got = {g.rid: g.tokens for g in srv.serve(_reqs(tcfg.vocab_size,
                                                     prefix=n_pre),
                                              timeout=120)}
    srv_j = JServer(cfg, jp, JServingConfig(**dataclasses.asdict(scfg)),
                    scheduler="sbs", max_len=MAX_LEN, max_new=5,
                    prefix_cache=prefix)
    want = {g.rid: g.tokens
            for g in srv_j.serve(_reqs(cfg.vocab_size, JRequest,
                                       prefix=n_pre), timeout=120)}
    assert set(got) == set(range(6))
    assert got == want
    for st in srv.decode_engines[0]._dp.values():
        st.pool.check()
        if st.binder is not None:
            st.binder.ensure_free(st.pool.num_blocks - 1)
        assert st.pool.used_count == 0 and not st.occupied()


# ---------------------------------------------------------------------------
# no whole replica
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [(a, (N_DP, M)) for a in ARCHS] + [
    ("whisper-large-v3", (N_DP, M)), ("internvl2-1b", (N_DP, M)),
    ("internvl2-1b", (1, 4))])
def test_no_whole_replica_storage_equals_tp_axis_count(arch, shape):
    _cfg, _jp, tcfg, tp = _pair(arch)
    mesh = _mesh(*shape)
    par = _par(tcfg, mesh)
    placed = place_params(tcfg, tp, mesh, par)
    rep = tp_weight_report(tcfg, tp, placed, mesh, par)
    assert rep["whole"] == []
    assert rep["held"] == rep["expected"]
    assert placed.replicas == {}
    with pytest.raises(ValueError, match="no whole replica"):
        params_on(placed, "cpu")
    caller = {t.untyped_storage().data_ptr() for t in param_leaves(tp)}
    Mr = shape[1]
    n_split = 0
    for (_dev, m), tree in placed.ranks.items():
        def walk(node, path):
            nonlocal n_split
            if isinstance(node, dict):
                for k, v in node.items():
                    if k != "replicas":
                        walk(v, path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))
            elif isinstance(node, torch.Tensor) and tp_axis(
                    tcfg, path, node.shape, Mr) is not None:
                n_split += 1
                assert node.untyped_storage().data_ptr() not in caller, path
        walk(tree, ())
    assert n_split > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's new legs of phase 6k, rehearsed
# ---------------------------------------------------------------------------

def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_tp_share_step_checks_rehearsed():
    """Phase 6k's internvl2-1b (1, 4) step check (the row-parallel form:
    its 4 heads over 2 KV heads do not split 4 ways) and whisper (2, 2)
    step check (split cross-attention over each slot's encoder K/V), at
    the reduced size: TP logits against the unsharded paged step's,
    collectives as predicted, the `[tp weights]` check passing."""
    cs = _smoke()
    _c1, _j1, icfg, ip = _pair("internvl2-1b")
    _c2, _j2, wcfg, wp = _pair("whisper-large-v3")
    out = cs.tp_share_checks("cpu", internvl=(icfg, ip), whisper=(wcfg, wp),
                             lens=(5, 13))
    for leg, cfg, shape in (("internvl", icfg, (1, 4)),
                            ("whisper", wcfg, (2, 2))):
        rep = out[leg]
        assert rep["logits_rel_err"] <= 1e-4
        assert rep["tp_calls"] == rep["tp_calls_expected"]
        assert rep["tp_calls"] == cs.expected_tp_calls(cfg, shape[1],
                                                       rep["rows"] // shape[0])
        assert rep["weights"]["whole"] == []
        assert rep["weights"]["held"] == rep["weights"]["expected"]
    # the row-parallel form: an all-gather of each attention's output
    # (and of the embedding where the vocabulary does not split 4 ways)
    assert out["internvl"]["tp_calls"]["all_gather"] == (
        icfg.num_layers + (icfg.vocab_size % 4 != 0))
    want = cs.expected_tp_calls(t_get_arch("internvl2-1b"), 4, 4)
    assert want == {"all_gather": 25, "all_reduce": 48, "reduce": 1}
    want = cs.expected_tp_calls(t_get_arch("whisper-large-v3"), 2, 2)
    assert want == {"all_reduce": 97, "gather": 1}


def test_chip_smoke_dense_chunk_counts_rehearsed():
    """The dense chunk's predicted collectives for phase 6k's full-width
    serves, and the counts a TP P/D serve records for its chunks (its
    dense prefill on DP 0's ranks) at the reduced size."""
    cs = _smoke()
    import dataclasses as dc
    granite = t_get_arch("granite-moe-1b-a400m")
    assert cs.expected_tp_chunk_calls(granite, 2) == {
        "all_gather": 1, "all_reduce": 24, "broadcast": 24, "reduce": 1}
    jamba = dc.replace(t_get_arch("jamba-v0.1-52b"), num_layers=8)
    assert cs.expected_tp_chunk_calls(jamba, 2) == {
        "all_reduce": 20, "broadcast": 4, "gather": 1}
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention]
    rep = cs.serve_sharded(tcfg, tp, "cpu", counters, False,
                           n_requests=4, lens=(16, 40), outs=(3, 5),
                           mesh=cs.tp_mesh("cpu"), tag="[tp pd rehearsal]")
    chunk = rep["dense_chunk"]
    assert chunk["chunks"] > 0
    assert chunk["tp_calls"] == [cs.expected_tp_chunk_calls(tcfg, M)]
    assert rep["weights"]["whole"] == []
    assert rep["weights"]["held"] == rep["weights"]["expected"]
