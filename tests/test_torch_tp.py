"""PyTorch port: tensor parallelism (TP) inside a DP unit on the sharded
serving plane (`make_engine_mesh(2, 2)`: two DP units of two model ranks
each), on logical CPU shards, in fp32, on reduced granite-moe-1b-a400m
(GQA, MoE, tied embeddings), deepseek-7b (MHA, dense FFN, untied
`lm_head`), minicpm3-4b (MLA), deepseek-v3-671b (MLA and MoE),
jamba-v0.1-52b (attention, MoE and SSM layers) and the MoE-free hybrid
(its pattern cut to (SSM, DENSE)):

  * placement: every leaf splits where the port's `param_pspecs` (the
    reference's, `tests/test_torch_launch.py`) puts "model", the MoE's
    shared experts, whisper's cross-attention and the row-parallel
    attention of the heads-not-dividing variant included, but where
    `tp_axis`'s note says the serving plane differs (an SSM layer's
    per-head vectors and gated-norm weight with its heads, and its [z|x]
    projection z and x each by heads), and the ranks hold exactly those
    pieces; the merged paged cache splits KV heads where
    `paged_cache_pspecs` puts them on "model", a hybrid's SSM state and
    x conv tail by heads, and whisper's per-slot encoder K/V by heads;
  * the TP merged decode step (plain and masked) and the TP prefill
    chunk equal the unsharded steps (logits, written K/V and the new SSM
    states within 1e-5 of their largest), every model rank of a DP
    holds the same hidden states bit for bit after each layer (an SSM
    layer's too: its gated norm all-reduces its sums of squares), and
    the collectives a step makes are the ones its layers call for; a
    heads-not-dividing variant runs the row-parallel form;
  * the page surgery through a DP's view of a TP merged cache equals
    the same surgery on the unsharded cache (the SSM state of a slot
    split and joined over the ranks);
  * the step runner over the TP merged step equals the direct step bit
    for bit and counts the collectives of each replay;
  * `RealSBSServer(mesh=make_engine_mesh(2, 2, devices=["cpu"] * 4))`
    token-exact against the JAX single-device server: reduced granite
    P/D and unified, reduced deepseek-7b P/D with `prefix_cache=True`,
    the heads-not-dividing variant P/D, minicpm3-4b and deepseek-v3 P/D
    and unified; the hybrids P/D against the JAX step oracle over the
    serve's own prefill chunks (an SSM's tokens depend on them);
  * MLA and SSM layers place, build a spec and run on a (2, 2) mesh;
    pure mamba2 is never paged, so it stays off the sharded plane;
  * chip_smoke.py's phase 6k (TP serves and the deepseek-7b TP step
    check, the minicpm3-4b and jamba legs) rehearsed at the reduced
    size.

JAX weights are bridged over (`params_from_numpy`).
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

from repro_torch.bridge import params_from_numpy
from repro_torch.config.base import LayerKind as TLK
from repro_torch.config.base import ParallelConfig, ServingConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.core.types import Request
from repro_torch.distributed import transfer as TT
from repro_torch.distributed.sharding import (
    SSM_STACKS, attn_heads_split, kv_split, paged_cache_pspecs, param_pspecs,
    place_params, shard_paged_cache, ssm_split, tp_axis, unshard_paged_cache,
)
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import model as TM
from repro_torch.serving.kv_pool import pad_block_table
from repro_torch.serving.real_engine import EngineSpec
from repro_torch.serving.server import RealSBSServer
from repro_torch.serving.step_graphs import StepGraphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64
BLOCK = 8
N_DP, M = 2, 2
TOL = 1e-5
ARCHS = ["granite-moe-1b-a400m", "deepseek-7b", "deepseek-7b-heads3",
         "minicpm3-4b", "deepseek-v3-671b", "jamba-v0.1-52b", "jamba-hybrid"]
HYBRIDS = ("jamba-v0.1-52b", "jamba-hybrid")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_PAIRS = {}


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params).  "deepseek-7b-heads3"
    is reduced deepseek-7b with 3 heads of 64: its heads do not divide
    the 2 model ranks, so its attention runs replicated; "jamba-hybrid"
    is reduced jamba with the layer pattern (SSM, DENSE)."""
    if arch not in _PAIRS:
        base = arch.replace("-heads3", "")
        base = "jamba-v0.1-52b" if arch == "jamba-hybrid" else base
        cfg = get_arch(base, reduced=True)
        tcfg = t_get_arch(base, reduced=True)
        if arch.endswith("-heads3"):
            kw = dict(num_heads=3, num_kv_heads=3, head_dim=64)
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


def _mesh():
    return make_engine_mesh(N_DP, M, devices=["cpu"] * (N_DP * M))


def _par(tcfg):
    E = tcfg.moe.num_experts if tcfg.moe is not None else 0
    if E and E % (N_DP * M) == 0:
        return ParallelConfig(expert_axes=("data", "model"))
    return ParallelConfig()


# ---------------------------------------------------------------------------
# placement against the production rules (`param_pspecs`)
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))


# (leaf, where `param_pspecs` puts "model", where the serving plane
# splits it instead: `tp_axis`'s documented differences)
_SERVING_SPLITS = {"A_log": 0, "D_skip": 0, "dt_bias": 0, "norm": 0}
# the placement check's architectures: the file's, and whisper (its
# cross-attention and encoder K/V; the engines do not serve it)
PLACED = ARCHS + ["whisper-large-v3"]


def _serving_axis(path, want):
    """Where the serving plane splits the leaf at `path`, given
    `param_pspecs`' model dims `want` (see `tp_axis`)."""
    if "mamba" in path and path[-1] in _SERVING_SPLITS:
        assert want == [], path                 # GSPMD: replicated
        return _SERVING_SPLITS[path[-1]]
    return want[0] if want else None


def _node(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@pytest.mark.parametrize("arch", PLACED)
def test_placement_matches_reference_pspecs(arch):
    _cfg, _jp, tcfg, tp = _pair(arch)
    mesh, par = _mesh(), _par(tcfg)
    specs = param_pspecs(tcfg, mesh, par, tp)
    placed = place_params(tcfg, tp, mesh, par)
    checked = 0
    for path, t in _leaves(tp):
        spec = _node(specs, path)
        if path[-1] in ("w_gate", "w_up", "w_down") and t.dim() == 3:
            # experts: split over the expert axes, nothing on "model"
            assert spec[0] in (("data", "model"), "model"), (path, spec)
            if path[0] == "layers":
                shards = placed["layers"][int(path[1])]["moe"][path[-1]]
                assert shards.G == (4 if spec[0] == ("data", "model")
                                    else 2)
            checked += 1
            continue
        want = [i for i, a in enumerate(spec) if a == "model"]
        ax = tp_axis(tcfg, path, t.shape, M)
        assert ax == _serving_axis(path, want), (path, spec, ax)
        # and the ranks hold exactly that piece (the serving plane does
        # not run DeepSeek-V3's multi-token-prediction head or whisper's
        # encoder: not placed)
        placed_leaf = path[0] not in ("mtp", "encoder", "enc_ln_f")
        for m in range(M if placed_leaf else 0):
            node = _node(placed.ranks[(torch.device("cpu"), m)], path)
            if "moe" in path:
                continue
            if path[-1] == "w_zx" and ax is not None:
                di = t.shape[1] // 2
                z, x = t[:, :di].chunk(M, 1)[m], t[:, di:].chunk(M, 1)[m]
                piece = torch.cat([z, x], 1)
            else:
                piece = t if ax is None else t.chunk(M, ax)[m]
            assert torch.equal(node, piece), (path, m)
        checked += 1
    assert checked == len(list(_leaves(tp)))
    # the merged paged cache: slots and blocks on "data", KV heads on
    # "model" where the production rules put them there, a hybrid's SSM
    # state and x conv tail by heads, an encoder-decoder's encoder K/V
    # by heads
    glob = TM.init_paged_cache(tcfg, 4, 8, MAX_LEN, BLOCK, device="cpu")
    cspecs = paged_cache_pspecs(tcfg, mesh, par, glob)
    assert cspecs["k"][1] == "data" and cspecs["cur"] == ("data",)
    assert (len(glob["k"].shape) == 5
            and cspecs["k"][3] == "model") == kv_split(tcfg, M)
    merged = shard_paged_cache(glob, mesh, tcfg)
    split = ssm_split(tcfg, M)
    for c in merged["shards"]:
        K = glob["k"].shape[-2]
        assert c["k"].shape[-2] == (K // M if kv_split(tcfg, M) else K)
        assert c["cur"].shape[0] == 2 and c["kv_pos"].shape[0] == 4
        for name in SSM_STACKS:
            if name not in glob:
                continue
            want = list(glob[name].shape)
            want[1] = 2                          # the DP's 2 slots
            if split and name == "ssm":
                want[2] //= M                    # heads
            if split and name == "conv_x":
                want[-1] //= M                   # x channels
            assert list(c[name].shape) == want, name
        for name in ("enc_k", "enc_v"):
            if name in glob:
                want = list(glob[name].shape)
                want[1], want[-2] = 2, want[-2] // M
                assert list(c[name].shape) == want, name


# ---------------------------------------------------------------------------
# model-level steps
# ---------------------------------------------------------------------------

def _global_cache(tcfg, n_slots, n_blocks, seed):
    """A merged-geometry paged cache in global ids with random K/V (and a
    hybrid's random SSM states and conv tails), every DP's rows holding a
    random prefix through its own blocks."""
    g = torch.Generator().manual_seed(seed)
    c = TM.init_paged_cache(tcfg, n_slots, n_blocks, MAX_LEN, BLOCK,
                            device="cpu")
    for name in ("k", "v") + SSM_STACKS:
        if name in c:
            c[name].normal_(generator=g)
    S, B = n_slots // N_DP, n_blocks // N_DP
    nbt = c["block_tab"].shape[1]
    cur = torch.zeros(n_slots, dtype=torch.int32)
    for s in range(n_slots):
        k = s // S
        if s % S == S - 1:
            continue                            # an idle row
        L = int(torch.randint(1, 3 * BLOCK, (), generator=g))
        free = [k * B + 1 + i for i in range(B - 1)]
        blocks = [free[(s % S) * 3 + j] for j in range(-(-L // BLOCK))]
        c["block_tab"][s] = torch.tensor(pad_block_table(blocks, nbt))
        for t in range(L):
            c["kv_pos"][blocks[t // BLOCK], t % BLOCK] = t
        cur[s] = L
    c["cur"] = cur
    return c


def _spec(arch, **kw):
    _cfg, _jp, tcfg, tp = _pair(arch)
    return EngineSpec(tcfg, tp, max_len=MAX_LEN, max_batch=2,
                      block_size=BLOCK, mesh=_mesh(), step_graphs=False,
                      **kw)


def _expected_calls(tcfg, tp, S):
    """The TP collectives of one merged decode step: the embedding's
    (vocabulary slices all-reduced, d_model slices all-gathered), one
    all-reduce after each split attention (GQA or MLA), each split
    cross-attention, each split dense FFN and each MoE layer's split
    shared experts, two after each split SSM mixer (its gated norm's
    sums of squares, its out_proj), an all-reduce of the row-parallel
    attention's q|k|v and an all-gather of its output, an all-gather of
    each MoE layer's rows (S rows a DP split over the ranks), the
    logits' gather (vocabulary slices)."""
    assert tcfg.vocab_size % M == 0 and S % M == 0
    heads, ssm = attn_heads_split(tcfg, M), ssm_split(tcfg, M)
    rows = tcfg.attention.name != "MLA" and not heads    # row-parallel
    reduces = 1 + sum((2 * ssm if "mamba" in p else heads or rows)
                      + ("mlp" in p)
                      + ("xattn" in p) + ("shared_gate" in p.get("moe", {}))
                      for p in tp["layers"])
    gathers = sum(("moe" in p) + (rows and "attn" in p)
                  for p in tp["layers"])
    calls = {"all_reduce": reduces, "all_gather": gathers, "gather": 1}
    return {k: n for k, n in calls.items() if n}


def _hidden_recorder(monkeypatch):
    """Record the hidden states `mlp_shards` returns after every layer."""
    seen = []
    inner = TM.mlp_shards

    def rec(ps, xs, cfg, groups=None):
        out = inner(ps, xs, cfg, groups)
        seen.append((groups, [x.clone() for x in out]))
        return out
    monkeypatch.setattr(TM, "mlp_shards", rec)
    return seen


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_merged_step_equals_unsharded(arch, masked, monkeypatch):
    _cfg, _jp, tcfg, tp = _pair(arch)
    spec = _spec(arch)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=3)
    merged = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    assert merged["model"] == M and len(merged["shards"]) == N_DP * M
    tok = torch.randint(0, tcfg.vocab_size, (N_DP * S, 1),
                        generator=torch.Generator().manual_seed(4))
    mask = torch.arange(N_DP * S) % 3 != 0 if masked else None
    seen = _hidden_recorder(monkeypatch)
    with TT.count_collectives() as st:
        if masked:
            lg_s, out_s = spec.masked_decode_fn(merged, tok, mask)
        else:
            lg_s, out_s = spec.decode_fn(merged, tok)
    assert st.calls == _expected_calls(tcfg, tp, S)
    assert st.bytes > 0
    # every model rank of a DP holds the same hidden states, bit for bit
    assert len(seen) == tcfg.num_layers
    for groups, xs in seen:
        for g in groups:
            for i in g[1:]:
                assert torch.equal(xs[i], xs[g[0]])
    if masked:
        lg_1, out_1 = TM.paged_decode_masked(tcfg, tp, tok, glob, mask)
    else:
        lg_1, out_1 = TM.paged_decode_step(tcfg, tp, tok, glob)
    assert lg_s.shape == lg_1.shape
    assert float((lg_s - lg_1).abs().max()) <= TOL * float(
        lg_1.abs().max())
    back = unshard_paged_cache(out_s, "cpu", tcfg)
    for name in ("cur", "block_tab"):
        assert torch.equal(back[name], out_1[name]), name
    live = torch.arange(N_DP * B) % B != 0
    assert torch.equal(back["kv_pos"][live], out_1["kv_pos"][live])
    for name in ("k", "v"):
        d = (back[name][:, live] - out_1[name][:, live]).abs().max()
        assert float(d) <= TOL * float(out_1[name].abs().max()), name
    for name in SSM_STACKS:                # a hybrid's new states
        if name in out_1:
            d = (back[name] - out_1[name]).abs().max()
            assert float(d) <= TOL * float(out_1[name].abs().max()), name
            if masked:                     # masked rows keep theirs
                assert torch.equal(back[name][:, ~mask], glob[name][:, ~mask])


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in HYBRIDS])
def test_tp_prefill_chunk_equals_unsharded(arch):
    _cfg, _jp, tcfg, tp = _pair(arch)
    spec = _spec(arch)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=6)
    fresh = {k: v.clone() for k, v in glob.items()}
    merged = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    slot = S + 1                                 # DP 1
    toks = torch.randint(0, tcfg.vocab_size, (1, 5),
                         generator=torch.Generator().manual_seed(2))
    with TT.count_collectives() as st:
        lg_s, out_s = spec.paged_prefill(None, toks, merged, slot)
    assert st.calls.get("all_reduce", 0) >= tcfg.num_layers
    lg_1, out_1 = TM.paged_prefill_step(tcfg, tp, toks, glob, slot)
    assert float((lg_s - lg_1).abs().max()) <= TOL * float(
        lg_1.abs().max())
    back = unshard_paged_cache(out_s, "cpu", tcfg)
    assert torch.equal(back["cur"], out_1["cur"])
    # past the slot's blocks the chunk writes into the null block: its
    # DP's (global k·B) here, block 0 there
    live = torch.arange(N_DP * B) % B != 0
    assert torch.equal(back["kv_pos"][live], out_1["kv_pos"][live])
    for name in ("k", "v"):
        d = (back[name][:, live] - out_1[name][:, live]).abs().max()
        assert float(d) <= TOL * float(out_1[name].abs().max()), name
    # the graph runner over the DP's view: the same step, bit for bit
    runner = StepGraphs(spec.params, spec.device, spec.step_lock,
                        devices=spec.mesh.distinct)
    merged2 = spec.shard_cache(fresh)
    lg_g, out_g = spec.paged_prefill(runner, toks, merged2, slot)
    assert torch.equal(lg_g, lg_s)
    for a, b in zip(out_g["shards"], out_s["shards"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_tp_step_runner_equals_direct_step_and_counts_collectives():
    spec = _spec("granite-moe-1b-a400m")
    _cfg, _jp, tcfg, tp = _pair("granite-moe-1b-a400m")
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=8)
    cache = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    ref = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    runner = StepGraphs(spec.params, spec.device, spec.step_lock,
                        devices=spec.mesh.distinct)
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        rows = torch.randint(0, tcfg.vocab_size, (N_DP * S, 1), generator=g)
        toks = [rows[i // M * S:(i // M + 1) * S] for i in range(N_DP * M)]
        with TT.count_collectives() as st:
            lg, cache = runner.run(("decode", "merged"), spec.decode_fn,
                                   cache, token=toks)
        lg_d, ref = spec.decode_fn(ref, toks)
        assert torch.equal(lg, lg_d)
        for a, b in zip(cache["shards"], ref["shards"]):
            for name in a:
                assert torch.equal(a[name], b[name]), name
        assert st.calls == _expected_calls(tcfg, tp, S)


@pytest.mark.parametrize("arch", ["deepseek-7b", "minicpm3-4b",
                                  "jamba-v0.1-52b"])
def test_page_surgery_on_a_tp_dp_view_equals_unsharded(arch):
    """Joins, takes, clears, adoption, block copies, row installs and
    table edits through DP k's view of a TP merged cache act on both of
    its model ranks and leave the same cache as on the unsharded one
    (KV heads split, an MLA latent whole on both ranks, a hybrid slot's
    SSM state split by heads)."""
    _cfg, _jp, tcfg, tp = _pair(arch)
    spec = _spec(arch)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = _global_cache(tcfg, N_DP * S, N_DP * B, seed=5)
    merged = spec.shard_cache({k: v.clone() for k, v in glob.items()})
    k = 1
    view = dict(merged, home=k)
    slot, other = k * S + S - 1, k * S
    nbt = MAX_LEN // BLOCK
    blocks = torch.tensor(pad_block_table([k * B + B - 3, k * B + B - 2],
                                          nbt), dtype=torch.int32)
    src = TM.paged_cache_take(tcfg, glob, other)
    ops = [
        lambda c: TM.paged_cache_join(tcfg, c, src, slot, blocks),
        lambda c: TM.paged_copy_block(tcfg, c, k * B + B - 3, k * B + B - 1),
        lambda c: TM.paged_set_table(c, slot, 1, k * B + B - 1),
        lambda c: TM.paged_clear_rows(c, blocks[:1]),
        lambda c: TM.paged_install_row(c, slot, blocks, 5),
        lambda c: TM.paged_adopt_blocks(
            tcfg, c, TM.paged_gather_blocks(tcfg, glob, glob["block_tab"][
                other]), slot, blocks, torch.arange(nbt) < 1,
            torch.arange(nbt) == 1, 7),
        lambda c: TM.paged_cache_clear_slot(c, other),
    ]
    live = torch.arange(N_DP * B) % B != 0
    for i, op in enumerate(ops):
        view, glob = op(view), op(glob)
        back = unshard_paged_cache(view, "cpu", tcfg)
        for name in ("cur", "block_tab"):
            assert torch.equal(back[name], glob[name]), (i, name)
        assert torch.equal(back["kv_pos"][live], glob["kv_pos"][live]), i
        for name in ("k", "v"):
            assert torch.equal(back[name][:, live], glob[name][:, live]), \
                (i, name)
        for name in SSM_STACKS:
            if name in glob:
                assert torch.equal(back[name], glob[name]), (i, name)
        # the model ranks of each DP agree on everything they replicate
        whole = ("cur", "block_tab", "kv_pos") + (
            () if kv_split(tcfg, M) else ("k", "v")) + tuple(
            n for n in ("conv_bc",) if n in glob)
        for d in range(N_DP):
            a, b = view["shards"][d * M], view["shards"][d * M + 1]
            for name in whole:
                assert torch.equal(a[name], b[name]), (i, name)
    got = TM.paged_cache_take(tcfg, view, slot)
    want = TM.paged_cache_take(tcfg, glob, slot)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------

def _scfg(mixed=False):
    extra = {"mixed_batch": True, "mixed_chunk": 32} if mixed else {}
    return ServingConfig(num_prefill_instances=1, prefill_dp_per_instance=1,
                         num_decode_instances=1,
                         decode_dp_per_instance=N_DP, chunk_size=32,
                         t_default=0.05, l_net=0.001, max_batch_per_dp=2,
                         block_size=BLOCK, **extra)


def _reqs(vocab, R=Request, prefix=0):
    rng = random.Random(7)
    head = [rng.randrange(vocab) for _ in range(prefix)]
    return [R(rid=i, input_len=prefix + 16, output_len=5,
              arrival_time=0.02 * i,
              tokens=head + [rng.randrange(vocab) for _ in range(16)])
            for i in range(6)]


def _serve(srv, reqs):
    return {g.rid: g.tokens for g in srv.serve(reqs, timeout=120)}


SERVES = [("granite-moe-1b-a400m", False, False),
          ("granite-moe-1b-a400m", True, False),
          ("deepseek-7b", False, True),
          ("deepseek-7b-heads3", False, False),
          ("minicpm3-4b", False, False),
          ("minicpm3-4b", True, False),
          ("deepseek-v3-671b", False, False),
          ("deepseek-v3-671b", True, False)]


@pytest.mark.parametrize("arch,mixed,prefix", SERVES,
                         ids=["granite-pd", "granite-unified",
                              "deepseek-pd-prefix", "heads3-pd",
                              "minicpm3-pd", "minicpm3-unified",
                              "deepseek-v3-pd", "deepseek-v3-unified"])
def test_tp_server_token_exact_vs_jax(arch, mixed, prefix):
    from repro.core.types import Request as JRequest
    from repro.serving.server import RealSBSServer as JServer
    cfg, jp, tcfg, tp = _pair(arch)
    scfg = _scfg(mixed)
    n_pre = 12 if prefix else 0
    srv = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", max_len=MAX_LEN,
                        max_new=5, prefix_cache=prefix,
                        mesh=_mesh())
    assert srv.spec.sharded and srv.spec.n_dp == N_DP
    got = _serve(srv, _reqs(tcfg.vocab_size, prefix=n_pre))
    srv_j = JServer(cfg, jp, JServingConfig(**dataclasses.asdict(scfg)),
                    scheduler="sbs", max_len=MAX_LEN, max_new=5,
                    prefix_cache=prefix)
    want = _serve(srv_j, _reqs(cfg.vocab_size, JRequest, prefix=n_pre))
    assert set(got) == set(range(6))
    assert got == want
    eng = srv.decode_engines[0]
    assert len(eng.tp_samples) == len(eng.step_samples)
    split = attn_heads_split(tcfg, M)
    for (_d, active, _r), (calls, _b) in zip(eng.step_samples,
                                             eng.tp_samples):
        if active:
            assert calls.get("all_reduce", 0) >= (
                1 + tcfg.num_layers * split)
    for st in eng._dp.values():
        st.pool.check()
        if st.binder is not None:
            st.binder.ensure_free(st.pool.num_blocks - 1)   # evict all
        assert st.pool.used_count == 0 and not st.occupied()
    if prefix:
        stats = srv.prefix_stats()
        assert stats["decode_blocks_shared"] > 0


def _oracle_tokens(cfg, jp, ids, n, chunks):
    """n tokens of the JAX serial path (dense `prefill_chunk` over the
    serve's `chunks`, then `decode_step`): a hybrid's tokens depend on
    where its prefill chunks start."""
    chunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
    step = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    cache, at = JM.init_cache(cfg, 1, MAX_LEN), 0
    for c in chunks:
        lg, cache = chunk(jp, jnp.asarray([ids[at:at + c]], jnp.int32),
                          cache)
        at += c
    toks = [int(jnp.argmax(lg[0]))]
    for _ in range(n - 1):
        lg, cache = step(jp, jnp.asarray([[toks[-1]]], jnp.int32), cache)
        toks.append(int(jnp.argmax(lg[0])))
    return toks


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
@pytest.mark.parametrize("arch", HYBRIDS)
def test_tp_hybrid_server_matches_jax_oracle(arch, graphs):
    """Reduced jamba and the MoE-free hybrid on the sharded P/D plane of a
    (2, 2) mesh: each SSM layer's heads split over the two ranks of each
    DP (its per-slot state and x conv tail too), token-exact against
    the JAX step oracle over the serve's own chunks, with and without
    the step runner; every decode step makes the predicted collectives
    and the merged cache drains."""
    cfg, jp, tcfg, tp = _pair(arch)
    scfg = _scfg()
    mesh = _mesh()
    spec = EngineSpec(tcfg, tp, max_len=MAX_LEN,
                      max_batch=scfg.max_batch_per_dp, max_new=5,
                      block_size=BLOCK,
                      decode_slots=scfg.resolved_decode_slots, mesh=mesh,
                      step_graphs=graphs)
    srv = RealSBSServer(tcfg, tp, scfg, scheduler="sbs", max_len=MAX_LEN,
                        max_new=5, spec=spec, mesh=mesh)
    shard = srv.decode_engines[0]._group.cache["shards"][0]
    assert shard["ssm"].shape[2] == TM.ssm_dims(tcfg.d_model,
                                                tcfg.ssm)[1] // M
    chunks = {}
    for eng in srv.engines:
        inner = eng._run_chunk
        eng._run_chunk = (lambda req, tok, _f=inner: (
            chunks.setdefault(req.rid, []).append(tok), _f(req, tok))[1])
    reqs = _reqs(tcfg.vocab_size)
    gens = srv.serve(reqs, timeout=120)
    assert sorted(g.rid for g in gens) == [r.rid for r in reqs]
    for g, r in zip(gens, reqs):
        assert g.tokens == _oracle_tokens(cfg, jp, list(r.tokens),
                                          r.output_len, chunks[r.rid]), r.rid
    eng = srv.decode_engines[0]
    want = _expected_calls(tcfg, tp, spec.paged_slots)
    for (_d, active, _r), (calls, _b) in zip(eng.step_samples,
                                             eng.tp_samples):
        if active:
            assert calls == want
    for st in eng._dp.values():
        st.pool.check()
        assert st.pool.used_count == 0 and not st.occupied()


# ---------------------------------------------------------------------------
# MLA and SSM layers under TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-370m",
                                  "jamba-v0.1-52b"])
def test_tp_places_mla_and_ssm_layers(arch):
    """MLA and SSM layers place on a (2, 2) mesh: an MLA layer's w_uq,
    w_uk, w_uv by head and w_o by row, its down-projections whole; an
    SSM layer's heads (z and x of w_zx each by heads, w_dt, the x conv,
    the per-head vectors, the norm weight, out_proj's rows), B/C whole.
    A spec on that mesh builds where the model pages (pure mamba2 is
    never paged in either package, so it stays off the sharded plane)."""
    tcfg = t_get_arch(arch, reduced=True)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    placed = place_params(tcfg, params, _mesh(), ParallelConfig())
    for m in range(M):
        for p, r in zip(params["layers"],
                        placed.ranks[(torch.device("cpu"), m)]["layers"]):
            if "attn" in p and "w_uq" in p["attn"]:
                a, ra = p["attn"], r["attn"]
                H = tcfg.num_heads
                for name in ("w_uq", "w_uk", "w_uv"):
                    assert torch.equal(ra[name], a[name].chunk(M, 1)[m])
                    assert ra[name].shape[1] == H // M
                assert torch.equal(ra["w_o"], a["w_o"].chunk(M, 0)[m])
                for name in ("w_dq", "w_dkv", "w_kr", "kv_norm"):
                    assert ra[name] is a[name] or torch.equal(ra[name],
                                                              a[name])
            if "mamba" in p:
                mp, rm = p["mamba"], r["mamba"]
                di, nh, _ = TM.ssm_dims(tcfg.d_model, tcfg.ssm)
                n = di // M
                assert torch.equal(rm["w_zx"][:, :n],
                                   mp["w_zx"][:, m * n:(m + 1) * n])
                assert torch.equal(rm["w_zx"][:, n:],
                                   mp["w_zx"][:, di + m * n:di + (m + 1) * n])
                for name, ax in (("w_dt", 1), ("conv_wx", 1), ("A_log", 0),
                                 ("norm", 0), ("out_proj", 0)):
                    assert torch.equal(rm[name], mp[name].chunk(M, ax)[m])
                assert rm["w_dt"].shape[1] == nh // M
                for name in ("w_bc", "conv_wbc", "conv_bbc"):
                    assert torch.equal(rm[name], mp[name])
    if arch == "mamba2-370m":
        with pytest.raises(ValueError, match="no attention cache to page"):
            TM.paged_layout(tcfg, MAX_LEN, BLOCK)
        return
    spec = EngineSpec(tcfg, params, max_len=MAX_LEN, max_batch=2,
                      block_size=BLOCK, mesh=_mesh(), step_graphs=False)
    cache = spec.merged_paged_cache()
    assert cache["model"] == M and len(cache["shards"]) == N_DP * M


def test_collectives_sum_in_one_order_on_every_rank():
    g = torch.Generator().manual_seed(1)
    parts = [torch.randn(3, 5, generator=g) * 10 ** i for i in range(4)]
    groups = [[0, 1], [2, 3]]
    with TT.count_collectives() as st:
        red = TT.all_reduce(parts, groups)
        gat = TT.all_gather(parts, groups, dim=0)
    for grp in groups:
        want = (parts[grp[0]].float() + parts[grp[1]]).to(parts[0].dtype)
        for i in grp:
            assert torch.equal(red[i], want)
            assert torch.equal(gat[i], torch.cat([parts[j] for j in grp]))
    assert st.calls == {"all_reduce": 1, "all_gather": 1}
    assert st.bytes == 2 * 4 * 3 * 5 * 4
    TT.add_collectives({"gather": 2}, 8)
    with TT.count_collectives() as st:
        TT.add_collectives({"gather": 2}, 8)
    assert st.calls == {"gather": 2} and st.bytes == 8


def test_chip_smoke_tp_phase_rehearsed():
    """Phase 6k at a reduced size on the CPU: granite-moe-1b-a400m at
    full width and 2 of 24 layers behind the (2, 2) TP server (P/D, step
    graphs: every merged decode step's collectives as predicted, logits
    against the plain forward over the served expert sets) and its bit
    A/B, then the step check on reduced deepseek-7b (TP logits against
    the unsharded step's).  On the CPU the wrappers take their plain
    versions, so no launch is counted."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention]
    _cfg, _jp, tcfg, tp = _pair("deepseek-7b")
    rep = chip_smoke.serve_tp_phase(counters, "cpu", n_layers=2,
                                    step_cfg=tcfg, step_params=tp,
                                    n_requests=4, lens=(64, 200),
                                    outs=(3, 5))
    pd = rep["pd"]
    assert pd["model_ranks"] == M
    assert pd["logits_rel_err"] <= chip_smoke.LOGITS_REL_TOL
    assert pd["tp_calls_expected"] == {"all_gather": 3, "all_reduce": 2,
                                       "reduce": 1}
    assert pd["tp_calls_per_decode_step"] == {
        k: float(v) for k, v in pd["tp_calls_expected"].items()}
    assert pd["ep_exchanges_per_decode_step"] == 2 * 2
    assert set(pd["launches"].values()) == {0}
    assert rep["bits"]["same_tokens"] and rep["bits"]["same_first_logits"]
    step = rep["step"]
    assert step["logits_rel_err"] <= 1e-4
    assert step["tp_calls"] == step["tp_calls_expected"] == {
        "all_reduce": 1 + 2 * tcfg.num_layers, "gather": 1}


def test_chip_smoke_tp_mla_ssm_legs_rehearsed():
    """Phase 6k's MLA and SSM legs at the reduced size on the CPU:
    minicpm3-4b behind the (2, 2) TP server (P/D, every merged decode
    step's collectives as predicted, logits against the non-absorbed
    plain forward) with its bit A/B, jamba behind it (served logits
    equal the eager replay bit for bit) with #4 at a rank's share of
    the SSM heads, and both step checks (TP logits against the
    unsharded step's).  On the CPU the wrappers take their plain
    versions, so no launch is counted."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention, ssd_chunk]
    _c1, _j1, mcfg, mp = _pair("minicpm3-4b")
    _c2, _j2, hcfg, hp = _pair("jamba-v0.1-52b")
    rep = chip_smoke.serve_tp_mla_ssm(
        counters, "cpu", mla_cfg=mcfg, mla_params=mp, hybrid_cfg=hcfg,
        hybrid_params=hp, n_requests=4, lens=(64, 200), outs=(3, 5))
    for leg, cfg, tp in (("mla", mcfg, mp), ("hybrid", hcfg, hp)):
        r = rep[leg]
        assert r["model_ranks"] == M
        want = _expected_calls(cfg, tp, r["merged_rows"] // N_DP)
        assert r["tp_calls_expected"] == want
        assert r["tp_calls_per_decode_step"] == {
            k: float(v) for k, v in want.items()}
        assert set(r["launches"].values()) == {0}
        assert r["step"]["logits_rel_err"] <= 1e-4
        assert r["step"]["tp_calls"] == r["step"]["tp_calls_expected"]
    assert rep["mla"]["logits_rel_err"] <= chip_smoke.LOGITS_REL_TOL
    assert rep["mla"]["bits"]["same_tokens"]
    assert rep["mla"]["bits"]["same_first_logits"]
    assert rep["hybrid"]["logits_checked_by"] == "replay"
    assert rep["hybrid"]["ssd_rank_shape"]["max_rel_err"] <= 1e-4
    assert rep["hybrid"]["step_bf16"]["tp_calls"] == rep["hybrid"]["step"][
        "tp_calls"]
    assert rep["hybrid"]["ep_exchanges_per_decode_step"] == 2
