"""PyTorch port: the sharded DP+EP serving plane (`EngineSpec(mesh=)`,
the merged decode cache, `RealSBSServer(mesh=)`) on a logical 4-shard
CPU mesh (`make_engine_mesh(4, devices=["cpu"] * 4)`), in fp32:

  * servers token-exact against the port's single-device server and
    against the JAX single-device `RealSBSServer` on the reference's
    sharded-plane traffic (`tests/test_sharded_plane.py`: reduced
    granite-moe-1b-a400m, 6 prompts of 16 tokens, 5 new, P/D 1×1 → 1×4
    DP and unified mixed); reduced deepseek-v3-671b (MLA + EP) P/D and
    a shared-prefix P/D deployment (`prefix_cache=True`: page-native
    prefill, PageHandoff joins into the merged cache, copy-on-write)
    against the port's single-device server;
  * structure: every step covers the merged slot axis and carries EP
    exchanges; the DPs' block pools issue disjoint global ids; the
    merged decode step equals the unsharded step on the same cache at a
    non-binding capacity factor; each page surgery on a DP's view of
    the merged cache equals the same surgery on the unsharded cache;
  * what a sharded deployment refuses: tensor parallelism inside a DP,
    a mesh whose data size differs from the decode DP count, a padded
    plane (a mesh spec builds with step graphs);
  * chip_smoke.py's sharded phase (the EP layer at granite's full MoE
    width against its plain version, the checked sharded P/D and
    unified serves) rehearsed on reduced granite-moe-1b-a400m.

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
from repro_torch.distributed import annotate
from repro_torch.distributed.sharding import (
    is_merged, shard_paged_cache, unshard_paged_cache,
)
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


def _scfg(mixed=False, **kw):
    extra = {"mixed_batch": True, "mixed_chunk": 32} if mixed else {}
    return ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1,
                         decode_dp_per_instance=N_DP, chunk_size=32,
                         t_default=0.05, l_net=0.001, max_batch_per_dp=2,
                         block_size=8, **extra, **kw)


def _reqs(vocab, R=Request):
    """The reference's sharded-plane traffic."""
    rng = random.Random(7)
    return [R(rid=i, input_len=16, output_len=5, arrival_time=0.02 * i,
              tokens=[rng.randrange(vocab) for _ in range(16)])
            for i in range(6)]


def _serve(srv, reqs):
    return {g.rid: g.tokens for g in srv.serve(reqs, timeout=120)}


def _check_structure(srv):
    eng = srv.decode_engines[0]
    rows = len(eng._group.slots)
    assert rows == N_DP * srv.spec.paged_slots
    assert eng.step_samples and len(eng.ep_samples) == len(eng.step_samples)
    assert all(r == rows for _d, _a, r in eng.step_samples)
    # every step that decoded rows carried the EP exchanges of every MoE
    # layer (dispatch and combine)
    n_moe = sum("moe" in p for p in srv.spec.params["layers"])
    for (_d, active, _r), (ex, nbytes, _s) in zip(eng.step_samples,
                                                  eng.ep_samples):
        if active:
            assert ex >= 2 * n_moe and nbytes > 0
    for st in eng._dp.values():
        st.pool.check()
        assert st.pool.used_count == 0 and not st.occupied()


@pytest.mark.parametrize("mixed", [False, True], ids=["pd", "unified"])
def test_sharded_granite_token_exact_vs_single_and_jax(mixed):
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    cfg, jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    scfg = _scfg(mixed)
    srv_s = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", max_len=MAX_LEN,
                          max_new=5, mesh=_mesh())
    assert srv_s.spec.sharded and srv_s.spec.device == torch.device("cpu")
    t_s = _serve(srv_s, _reqs(tcfg.vocab_size))
    srv_1 = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", max_len=MAX_LEN,
                          max_new=5, device="cpu")
    t_1 = _serve(srv_1, _reqs(tcfg.vocab_size))
    srv_j = JServer(cfg, jp, JServingConfig(**dataclasses.asdict(scfg)),
                    scheduler="sbs", max_len=MAX_LEN, max_new=5)
    t_j = _serve(srv_j, _reqs(cfg.vocab_size, JRequest))
    assert set(t_s) == set(range(6))
    assert t_s == t_1 == t_j
    _check_structure(srv_s)
    eng = srv_s.decode_engines[0]
    if mixed:
        assert eng.mixed_steps > 0
        assert sum(e[0] for e in eng.ep_samples) > 0
    else:
        assert all(ex > 0 for ex, _b, _s in eng.ep_samples)


def test_sharded_deepseek_v3_pd_token_exact_vs_single():
    _cfg, _jp, tcfg, tp = _pair("deepseek-v3-671b")
    scfg = _scfg()
    srv_s = RealSBSServer(tcfg, tp, scfg, scheduler="sbs-la",
                          max_len=MAX_LEN, max_new=5, mesh=_mesh())
    t_s = _serve(srv_s, _reqs(tcfg.vocab_size))
    srv_1 = RealSBSServer(tcfg, tp, scfg, scheduler="sbs-la",
                          max_len=MAX_LEN, max_new=5, device="cpu")
    t_1 = _serve(srv_1, _reqs(tcfg.vocab_size))
    assert set(t_s) == set(range(6)) and t_s == t_1
    _check_structure(srv_s)
    assert all(ex > 0 for ex, _b, _s in srv_s.decode_engines[0].ep_samples)


def test_sharded_prefix_cache_pd_token_exact_vs_single():
    """Shared-prefix prompts through page-native prefill: PageHandoff
    joins adopt pages into the merged cache (global block ids through
    each DP's view), decode binders share them and copy the tail block
    on write."""
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    rng = random.Random(5)
    prefix = [rng.randrange(tcfg.vocab_size) for _ in range(20)]
    prompts = [prefix + [rng.randrange(tcfg.vocab_size)
                         for _ in range(5 + i)] for i in range(8)]

    def reqs():
        return [Request(rid=i, input_len=len(p), output_len=5,
                        arrival_time=0.05 * i, tokens=tuple(p))
                for i, p in enumerate(prompts)]
    out = {}
    for name, mesh in (("sharded", _mesh()), ("single", None)):
        srv = RealSBSServer(tcfg, tp, _scfg(), scheduler="immediate",
                            max_len=MAX_LEN, max_new=5, prefix_cache=True,
                            device="cpu", mesh=mesh)
        out[name] = _serve(srv, reqs())
        stats = srv.prefix_stats()
        assert stats["decode_blocks_shared"] > 0
        assert stats["decode_cow_copies"] > 0
    assert set(out["sharded"]) == set(range(8))
    assert out["sharded"] == out["single"]


def test_block_pools_issue_disjoint_global_ids():
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    srv = RealSBSServer(tcfg, tp, _scfg(), max_len=MAX_LEN, max_new=5,
                        mesh=_mesh())
    eng = srv.decode_engines[0]
    B = srv.spec.paged_pool_blocks
    seen = set()
    for k, st in enumerate(eng._dp.values()):
        assert st.pool.base == k * B
        assert (st.lo, st.hi) == (k * srv.spec.paged_slots,
                                  (k + 1) * srv.spec.paged_slots)
        ids = st.pool.alloc(st.pool.free_count)
        assert all(k * B < i < (k + 1) * B for i in ids)
        assert not seen & set(ids)
        seen.update(ids)
        st.pool.free(ids)
        # a DP's view reads through to the one merged cache
        assert st.cache["home"] == k and is_merged(st.cache)
        assert st.cache["shards"] is eng._group.cache["shards"]


def _global_cache(tcfg, n_slots, n_blocks, seed):
    """A merged-geometry paged cache in global ids with random K/V, every
    DP's rows holding a random prefix through its own blocks."""
    g = torch.Generator().manual_seed(seed)
    c = TM.init_paged_cache(tcfg, n_slots, n_blocks, MAX_LEN, 8,
                            device="cpu")
    c["k"].normal_(generator=g)
    c["v"].normal_(generator=g)
    S, B = n_slots // N_DP, n_blocks // N_DP
    nbt = c["block_tab"].shape[1]
    cur = torch.zeros(n_slots, dtype=torch.int32)
    for s in range(n_slots):
        k = s // S
        if s % S == S - 1:
            continue                            # an idle row
        L = int(torch.randint(1, 3 * 8, (), generator=g))
        free = [k * B + 1 + i for i in range(B - 1)]
        blocks = [free[(s % S) * 3 + j] for j in range(-(-L // 8))]
        c["block_tab"][s] = torch.tensor(pad_block_table(blocks, nbt))
        for t in range(L):
            c["kv_pos"][blocks[t // 8], t % 8] = t
        cur[s] = L
    c["cur"] = cur
    return c


def test_merged_decode_step_equals_unsharded_step():
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=8,
                      mesh=_mesh(), step_graphs=False)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=3)
    merged = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    tok = torch.randint(0, tcfg.vocab_size, (N_DP * S, 1),
                        generator=torch.Generator().manual_seed(4))
    mask = torch.arange(N_DP * S) % 3 != 0
    with TEP.count_exchanges() as st:
        lg_s, out_s = spec.masked_decode_fn(merged, tok, mask)
    assert st.exchanges == 2 * tcfg.num_layers
    lg_1, out_1 = TM.paged_decode_masked(tcfg, tp, tok, glob, mask)
    assert torch.allclose(lg_s, lg_1, atol=1e-5, rtol=0)
    back = unshard_paged_cache(out_s, "cpu")
    for name in ("cur", "block_tab"):
        assert torch.equal(back[name], out_1[name]), name
    # garbage rows write into their shard's null block (global k·B), the
    # unsharded step into block 0: compare every other block
    live = torch.arange(N_DP * B) % B != 0
    assert torch.equal(back["kv_pos"][live], out_1["kv_pos"][live])
    for name in ("k", "v"):
        assert torch.allclose(back[name][:, live], out_1[name][:, live],
                              atol=1e-5, rtol=0)
    # without the mesh context the merged step keeps the single-program
    # semantics over all rows: same logits, no exchange
    with TEP.count_exchanges() as st:
        lg_p, _ = TM.paged_decode_step(
            tcfg, spec.params, tok, spec.shard_cache(
                {k: v.clone() for k, v in glob.items()}))
    lg_q, _ = TM.paged_decode_step(tcfg, tp, tok, dict(glob))
    assert st.exchanges == 0 and annotate.active() is None
    assert torch.allclose(lg_p, lg_q, atol=1e-5, rtol=0)


def test_page_surgery_on_a_dp_view_equals_unsharded():
    """Joins, takes, clears, adoption, block copies, row installs and
    table edits through DP k's view of the merged cache (global slot and
    block ids) leave the same cache as on the unsharded one."""
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=8,
                      mesh=_mesh(), step_graphs=False)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=5)
    merged = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    k = 2
    view = dict(merged, home=k)
    slot, other = k * S + S - 1, k * S
    blocks = torch.tensor(pad_block_table([k * B + B - 3, k * B + B - 2],
                                          spec.nbt), dtype=torch.int32)
    src = TM.paged_cache_take(tcfg, glob, other)
    ops = [
        lambda c: TM.paged_cache_join(tcfg, c, src, slot, blocks),
        lambda c: TM.paged_copy_block(tcfg, c, k * B + B - 3, k * B + B - 1),
        lambda c: TM.paged_set_table(c, slot, 1, k * B + B - 1),
        lambda c: TM.paged_clear_rows(c, blocks[:1]),
        lambda c: TM.paged_install_row(c, slot, blocks, 5),
        lambda c: TM.paged_adopt_blocks(
            tcfg, c, TM.paged_gather_blocks(tcfg, glob, glob["block_tab"][
                other]), slot, blocks, torch.arange(spec.nbt) < 1,
            torch.arange(spec.nbt) == 1, 7),
        lambda c: TM.paged_cache_clear_slot(c, other),
    ]
    live = torch.arange(N_DP * B) % B != 0      # not a null block
    for i, op in enumerate(ops):
        view, glob = op(view), op(glob)
        back = unshard_paged_cache(view, "cpu")
        for name in ("cur", "block_tab"):
            assert torch.equal(back[name], glob[name]), (i, name)
        assert torch.equal(back["kv_pos"][live], glob["kv_pos"][live]), i
        for name in ("k", "v"):
            assert torch.equal(back[name][:, live], glob[name][:, live]), \
                (i, name)
    got = TM.paged_cache_take(tcfg, view, slot)
    want = TM.paged_cache_take(tcfg, glob, slot)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with pytest.raises(ValueError):
        shard_paged_cache(glob, make_engine_mesh(3, devices=["cpu"] * 3))


def test_sharded_deployments_refuse():
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    # a mesh spec builds with step graphs (its default); a mesh with
    # tensor parallelism inside each DP builds a spec of its data size
    assert EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=8,
                      mesh=_mesh()).step_graphs
    tp_mesh = make_engine_mesh(4, model=2, devices=["cpu"] * 8)
    assert tp_mesh.shape == {"data": 4, "model": 2}
    tp_spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2,
                         block_size=8, mesh=tp_mesh, step_graphs=False)
    assert tp_spec.n_dp == 4 and tp_spec.axis_map["model"] == "model"
    assert tp_spec.merged_paged_cache()["model"] == 2
    with pytest.raises(ValueError, match="paged-only"):
        EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=0,
                   mesh=_mesh(), step_graphs=False)
    with pytest.raises(ValueError, match="data=4"):
        RealSBSServer(tcfg, tp, dataclasses.replace(
            _scfg(), decode_dp_per_instance=2), max_len=MAX_LEN, max_new=5,
            mesh=_mesh())
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2, block_size=8,
                      mesh=_mesh(), step_graphs=False)
    # EP over the whole mesh: 4 experts over ("data", "model") = 4 ranks
    assert spec.parallel.expert_axes == ("data", "model")
    assert spec.axis_map == {"tokens": ("data",),
                             "experts": ("data", "model")}
    moe = spec.params["layers"][0]["moe"]
    assert moe["w_gate"].G == 4 and moe["w_gate"].E_per == 1


@pytest.mark.parametrize("mixed", [False, True], ids=["pd", "unified"])
def test_chip_smoke_sharded_serve_on_cpu(mixed):
    """The smoke's sharded serve with its checks (every request, the
    merged caches drain, exchanges in every merged decode step, the
    first-token logits against the plain forward over the served expert
    sets) at a reduced size; on the CPU the wrappers take their plain
    versions, so no launch is counted."""
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
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention]
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    rep = chip_smoke.serve_sharded(tcfg, tp, "cpu", counters, mixed,
                                   n_requests=4, lens=(128, 400),
                                   outs=(4, 8))
    assert rep["logits_rel_err"] <= chip_smoke.LOGITS_REL_TOL
    assert rep["merged_rows"] == N_DP * 2 * chip_smoke.MAX_BATCH
    assert rep["ep_exchanges_per_decode_step"] >= 2 * tcfg.num_layers
    assert set(rep["launches"].values()) == {0}
    if not mixed:
        ep = chip_smoke.check_ep_layer("cpu")
        assert set(ep["shapes"]) == {N_DP * 2 * chip_smoke.MAX_BATCH,
                                     chip_smoke.PD_CHUNK}
        assert all(f["exchanges"] == 2 for f in ep["shapes"].values())
