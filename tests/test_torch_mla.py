"""PyTorch port: multi-head latent attention (MLA) against the JAX
package on the same numpy inputs and the JAX init's weights, in fp32 on
the CPU:

  * `mla_scores_decode` (fp32 scores, the kv_pos validity mask, rows
    with no valid key zeroed);
  * the absorbed-form `mla_decode` and `mla_extend` over dense latent
    caches and `mla_decode_paged` / `mla_extend_paged` over latent pools
    (reduced minicpm3-4b, reduced deepseek-v3-671b, and minicpm3 without
    query compression), outputs and the caches they write;
  * the params and latent-cache bridge round trips (the MTP head stays
    out), and the paged step family with its page surgery on latent
    pools (`paged_prefill_step`, `paged_decode_step`,
    `paged_copy_block`, `paged_gather_blocks`, `paged_adopt_blocks`,
    `paged_cache_take`/`join`) against the JAX functions.

Tolerance: 1e-5 of the largest element (sums taken in another order by
XLA and by PyTorch); positions, tables and the bridge exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM

from repro_torch.bridge import (
    cache_from_numpy, cache_to_numpy, params_from_numpy,
)
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

TOL = 1e-5
CASES = ["minicpm3-4b", "deepseek-v3-671b", "minicpm3-4b-no-q-lora"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(case):
    arch = case.replace("-no-q-lora", "")
    cfg, tcfg = get_arch(arch, reduced=True), t_get_arch(arch, reduced=True)
    if case.endswith("no-q-lora"):
        cfg = dataclasses.replace(
            cfg, mla=dataclasses.replace(cfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(
            tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    return cfg, tcfg


@pytest.fixture(scope="module")
def models():
    """{case: (JAX cfg, port cfg, JAX params, numpy params, port
    params)}."""
    out = {}
    for case in CASES:
        cfg, tcfg = _cfgs(case)
        jp = jax.jit(JM.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        npp = jax.tree.map(np.asarray, jp)
        out[case] = (cfg, tcfg, jp, npp,
                     params_from_numpy(tcfg, npp, device="cpu"))
    return out


def _rel(j, t):
    a = np.asarray(j, np.float32)
    b = t.detach().float().numpy()
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _attn(models, case):
    """The attention params of the last layer (an MoE layer of
    deepseek-v3), JAX (arrays) and port."""
    cfg, tcfg, _jp, _npp, tp = models[case]
    p = tp["layers"][-1]["attn"]
    return cfg, tcfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()}, p


def _dense_cache(cfg, rng, B, S, filled):
    """Latent cache rows with `filled[b]` valid positions (0..n-1), -1
    after, and random garbage everywhere."""
    m = cfg.mla
    ckv = rng.normal(size=(B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, S, m.qk_rope_head_dim)).astype(np.float32)
    kv_pos = np.full((B, S), -1, np.int32)
    for b, n in enumerate(filled):
        kv_pos[b, :n] = np.arange(n)
    return ckv, kr, kv_pos


def test_mla_scores_decode_matches_jax():
    rng = np.random.default_rng(0)
    B, H, S, r, dr = 3, 4, 40, 16, 8
    ql = rng.normal(size=(B, H, r)).astype(np.float32)
    qr = rng.normal(size=(B, H, dr)).astype(np.float32)
    c = rng.normal(size=(B, S, r)).astype(np.float32)
    kr = rng.normal(size=(B, S, dr)).astype(np.float32)
    kv_pos = rng.integers(-1, 30, size=(B, S)).astype(np.int32)
    kv_pos[2] = -1                          # a row with no valid key
    pos = np.array([29, 5, 7], np.int32)
    jp, jv = JA.mla_scores_decode(*(jnp.asarray(a) for a in
                                    (ql, qr, c, kr, kv_pos, pos)))
    tp, tv = TA.mla_scores_decode(*(torch.tensor(a) for a in
                                    (ql, qr, c, kr, kv_pos, pos)))
    assert tp.dtype == torch.float32
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert float(np.abs(np.asarray(jp) - tp.numpy()).max()) <= TOL
    assert bool((tp[2] == 0).all())


@pytest.mark.parametrize("case", CASES)
def test_mla_decode_matches_jax(models, case):
    cfg, tcfg, jattn, tattn = _attn(models, case)
    rng = np.random.default_rng(1)
    B, S = 3, 48
    ckv, kr, kv_pos = _dense_cache(cfg, rng, B, S, (10, 47, 0))
    pos = np.array([10, 47, 0], np.int32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jout, (jc, jk, jpos) = JB.mla_decode(
        jattn, jnp.asarray(x), cfg, jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kv_pos), jnp.asarray(pos))
    tc, tk, tpos = (torch.tensor(a) for a in (ckv, kr, kv_pos))
    tout = TB.mla_decode(tattn, torch.tensor(x), tcfg, tc, tk, tpos,
                         torch.tensor(pos))
    assert _rel(jout, tout) <= TOL
    assert _rel(jc, tc) <= TOL and _rel(jk, tk) <= TOL
    assert np.array_equal(np.asarray(jpos), tpos.numpy())


@pytest.mark.parametrize("case", CASES)
def test_mla_extend_matches_jax(models, case):
    cfg, tcfg, jattn, tattn = _attn(models, case)
    rng = np.random.default_rng(2)
    B, S, Sc = 2, 64, 12
    ckv, kr, kv_pos = _dense_cache(cfg, rng, B, S, (20, 0))
    positions = np.stack([20 + np.arange(Sc), np.arange(Sc)]).astype(np.int32)
    x = rng.normal(size=(B, Sc, cfg.d_model)).astype(np.float32)
    jout, (jc, jk, jpos) = JB.mla_extend(
        jattn, jnp.asarray(x), cfg, jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kv_pos), jnp.asarray(positions))
    tc, tk, tpos = (torch.tensor(a) for a in (ckv, kr, kv_pos))
    tout = TB.mla_extend(tattn, torch.tensor(x), tcfg, tc, tk, tpos,
                         torch.tensor(positions))
    assert _rel(jout, tout) <= TOL
    assert _rel(jc, tc) <= TOL and _rel(jk, tk) <= TOL
    assert np.array_equal(np.asarray(jpos), tpos.numpy())


def _pools(cfg, rng, N, bs):
    m = cfg.mla
    ckv = rng.normal(size=(N, bs, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(N, bs, m.qk_rope_head_dim)).astype(np.float32)
    kv_pos = rng.integers(0, 64, size=(N, bs)).astype(np.int32)  # garbage
    return ckv, kr, kv_pos


def _paged_rows(kv_pos, tab, lens, bs):
    """Write positions 0..len-1 of each row into its table's pages."""
    for b, n in enumerate(lens):
        for p in range(n):
            kv_pos[tab[b, p // bs], p % bs] = p
        for j in range((n + bs - 1) // bs, tab.shape[1]):
            if tab[b, j] >= 0:
                kv_pos[tab[b, j]] = -1


@pytest.mark.parametrize("case", CASES)
def test_mla_decode_paged_matches_jax(models, case):
    cfg, tcfg, jattn, tattn = _attn(models, case)
    rng = np.random.default_rng(3)
    N, bs = 12, 8
    ckv, kr, kv_pos = _pools(cfg, rng, N, bs)
    # row 0: 3 pages; row 1: 1 page, a partial tail; row 2: all -1 (an
    # idle row writing into the null block 0)
    tab = np.array([[3, 7, 1, -1], [5, -1, -1, -1], [-1, -1, -1, -1]],
                   np.int32)
    _paged_rows(kv_pos, tab, (20, 3, 0), bs)
    pos = np.array([20, 3, 0], np.int32)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    jout, (jc, jk, jpos) = JB.mla_decode_paged(
        jattn, jnp.asarray(x), cfg, jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kv_pos), jnp.asarray(tab), jnp.asarray(pos))
    tc, tk, tpos = (torch.tensor(a) for a in (ckv, kr, kv_pos))
    tout = TB.mla_decode_paged(tattn, torch.tensor(x), tcfg, tc, tk, tpos,
                               torch.tensor(tab), torch.tensor(pos))
    assert _rel(jout, tout) <= TOL
    assert _rel(jc, tc) <= TOL and _rel(jk, tk) <= TOL
    assert np.array_equal(np.asarray(jpos), tpos.numpy())


@pytest.mark.parametrize("case", CASES)
def test_mla_extend_paged_matches_jax(models, case):
    cfg, tcfg, jattn, tattn = _attn(models, case)
    rng = np.random.default_rng(4)
    N, bs, Sc = 12, 8, 13
    ckv, kr, kv_pos = _pools(cfg, rng, N, bs)
    # a chunk that starts mid-page over 11 tokens of history (a shared
    # prefix page and a partial one)
    tab = np.array([[4, 9, 2, 6, -1]], np.int32)
    _paged_rows(kv_pos, tab, (11,), bs)
    positions = (11 + np.arange(Sc, dtype=np.int32))[None]
    x = rng.normal(size=(1, Sc, cfg.d_model)).astype(np.float32)
    jout, (jc, jk, jpos) = JB.mla_extend_paged(
        jattn, jnp.asarray(x), cfg, jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kv_pos), jnp.asarray(tab), jnp.asarray(positions))
    tc, tk, tpos = (torch.tensor(a) for a in (ckv, kr, kv_pos))
    tout = TB.mla_extend_paged(tattn, torch.tensor(x), tcfg, tc, tk, tpos,
                               torch.tensor(tab), torch.tensor(positions))
    assert _rel(jout, tout) <= TOL
    assert _rel(jc, tc) <= TOL and _rel(jk, tk) <= TOL
    assert np.array_equal(np.asarray(jpos), tpos.numpy())


def test_params_bridge_is_exact_and_leaves_out_mtp(models):
    """Every port leaf equals its JAX leaf (the layer's row of its group
    stack) bit for bit; deepseek-v3's MTP head, which the training loss
    reads, is carried over as one block (not a stack), bit for bit too.
    (The name is kept from when the bridge left the head out.)"""
    cfg, tcfg, _jp, npp, tp = models["deepseek-v3-671b"]
    assert "mtp" in npp and "mtp" in tp
    mtp = dict(jax.tree_util.tree_leaves_with_path(npp["mtp"]))
    mine = jax.tree_util.tree_leaves_with_path(tp["mtp"])
    assert len(mtp) == len(mine) and set(tp["mtp"]) == set(npp["mtp"])
    for path, t in mine:
        assert np.array_equal(mtp[path], t.numpy()), path
    groups = [("prefix", 0), ("p0", 0)]
    assert len(tp["layers"]) == len(groups) == cfg.num_layers
    for layer, (key, i) in zip(tp["layers"], groups):
        src = npp[key] if key == "prefix" else npp["blocks"][key]
        flat = dict(jax.tree_util.tree_leaves_with_path(src))
        mine = jax.tree_util.tree_leaves_with_path(layer)
        assert len(flat) == len(mine)
        for path, t in mine:
            assert np.array_equal(flat[path][i], t.numpy()), path
    assert set(tp["layers"][1]) == {"ln1", "attn", "ln2", "moe"}
    assert set(tp["layers"][0]) == {"ln1", "attn", "ln2", "mlp"}


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_latent_cache_bridge_roundtrip(arch, paged):
    cfg, tcfg = get_arch(arch, reduced=True), t_get_arch(arch, reduced=True)
    jc = jax.tree.map(np.asarray, JM.init_paged_cache(cfg, 3, 7, 32, 8)
                      if paged else JM.init_cache(cfg, 2, 32))
    rng = np.random.default_rng(5)
    jc = jax.tree.map(lambda a: (rng.normal(size=a.shape).astype(a.dtype)
                                 if a.dtype == np.float32 else
                                 rng.integers(-1, 32, size=a.shape
                                              ).astype(a.dtype)), jc)
    tc = cache_from_numpy(tcfg, jc, device="cpu")
    m = tcfg.mla
    lead = (cfg.num_layers, 7, 8) if paged else (cfg.num_layers, 2, 32)
    assert tc["k"].shape == lead + (m.kv_lora_rank,)
    assert tc["v"].shape == lead + (m.qk_rope_head_dim,)
    init = (TM.init_paged_cache(tcfg, 3, 7, 32, 8, device="cpu") if paged
            else TM.init_cache(tcfg, 2, 32, device="cpu"))
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in tc.items()}
    back = cache_to_numpy(tcfg, tc)
    ja = jax.tree_util.tree_leaves_with_path(jc)
    tb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(ja) == len(tb)
    for path, a in ja:
        assert np.array_equal(a, tb[path]), path


def _same(jtree, ttree, tol=TOL):
    """A JAX cache (or payload) against the port's, through the bridge:
    floats within `tol` of the largest, integers exactly."""
    ja = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    tb = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert len(ja) == len(tb)
    for path, a in ja:
        b = tb[path]
        assert a.shape == b.shape, path
        if a.dtype == np.int32:
            assert np.array_equal(a, b), path
        else:
            assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1.0), \
                path


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b"])
def test_paged_steps_and_page_surgery_match_jax(models, arch):
    """Two prefill chunks of slot 0 straight into latent pages, a decode
    step of both slots (slot 1 idle on the null block), copy-on-write of
    a page, the handoff payload gathered and adopted into a second cache
    (one page shared, not copied; one growth page cleared), and the
    dense take/join of the slot: the JAX functions and the port's agree
    on logits, pools and positions at every step."""
    cfg, tcfg, jp, _npp, tp = models[arch]
    N, bs, L = 10, 8, 48
    rng = np.random.default_rng(6)
    jc = JM.init_paged_cache(cfg, 2, N, L, bs)
    tc = TM.init_paged_cache(tcfg, 2, N, L, bs, device="cpu")
    tab = np.array([[2, 5, 7, 1, -1, -1], [-1] * 6], np.int32)
    jc = dict(jc, block_tab=jnp.asarray(tab))
    tc["block_tab"] = torch.tensor(tab)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 19)).astype(np.int32)
    for lo, hi in ((0, 11), (11, 19)):
        jl, jc = JM.paged_prefill_step(cfg, jp, jnp.asarray(toks[:, lo:hi]),
                                       jc, 0)
        tl, tc = TM.paged_prefill_step(tcfg, tp, torch.tensor(
            toks[:, lo:hi]), tc, 0)
        assert _rel(jl, tl) <= TOL
    _same(jc, cache_to_numpy(tcfg, tc))
    nxt = np.array([[int(np.argmax(np.asarray(jl)[0]))], [3]], np.int32)
    jl, jc = JM.paged_decode_step(cfg, jp, jnp.asarray(nxt), jc)
    tl, tc = TM.paged_decode_step(tcfg, tp, torch.tensor(nxt), tc)
    assert _rel(jl, tl) <= TOL
    _same(jc, cache_to_numpy(tcfg, tc))
    jc = JM.paged_copy_block(cfg, jc, 7, 4)
    tc = TM.paged_copy_block(tcfg, tc, 7, 4)
    _same(jc, cache_to_numpy(tcfg, tc))
    ids = np.array([2, 5, 4, -1, -1, -1], np.int32)
    jpay = JM.paged_gather_blocks(cfg, jc, jnp.asarray(ids))
    tpay = TM.paged_gather_blocks(tcfg, tc, torch.tensor(ids))
    _same(jpay, cache_to_numpy(tcfg, tpay))
    # adopt into a fresh cache: page 3 resident (shared, untouched),
    # pages 6 and 8 copied, page 9 a cleared growth page
    jd = JM.init_paged_cache(cfg, 2, N, L, bs)
    td = TM.init_paged_cache(tcfg, 2, N, L, bs, device="cpu")
    row = np.array([3, 6, 8, 9, -1, -1], np.int32)
    copy = np.array([0, 1, 1, 0, 0, 0], bool)
    clear = np.array([0, 0, 0, 1, 0, 0], bool)
    jd = JM.paged_adopt_blocks(cfg, jd, jpay, 1, jnp.asarray(row),
                               jnp.asarray(copy), jnp.asarray(clear), 20)
    td = TM.paged_adopt_blocks(tcfg, td, tpay, 1, torch.tensor(row),
                               torch.tensor(copy), torch.tensor(clear),
                               torch.tensor(20, dtype=torch.int32))
    _same(jd, cache_to_numpy(tcfg, td))
    jt = JM.paged_cache_take(cfg, jc, 0)
    tt = TM.paged_cache_take(tcfg, tc, 0)
    _same(jt, cache_to_numpy(tcfg, tt))
    row = jnp.asarray(np.array([9, 8, 6, 3, -1, -1], np.int32))
    jd = JM.paged_cache_join(cfg, jd, jt, 0, row)
    td = TM.paged_cache_join(tcfg, td, tt, 0, torch.tensor(np.asarray(row)))
    _same(jd, cache_to_numpy(tcfg, td))
