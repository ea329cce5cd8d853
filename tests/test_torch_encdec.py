"""PyTorch port: the encoder-decoder (whisper-large-v3) and vision-prefill
(internvl2-1b) pieces of the full-sequence path, held against the JAX
package on the same numpy inputs at the reduced sizes, in fp32: the
sinusoidal position embedding, the bidirectional encoder attention and
cross-attention (from the encoder's output, from cached K/V, and in its
decode form, one query over every encoder position), the encoder, the
cross-attention arms of `block_decode`/`block_extend`, the bridge and
the cache's encoder K/V stacks (round trips, joins and takes), the
port's own init of both models, the split of `require_supported` (every
registered architecture at model level; the serving engines refuse
these two with the reason), and `examples/quickstart_torch.py` on the
CPU.

Tolerances: 1e-5 for sub-layer outputs and cache entries, LOGIT_TOL
(1e-4) for logits, exact for bridged weights and round trips.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch, list_archs
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch.bridge import (
    cache_from_numpy, cache_to_numpy, params_from_numpy,
)
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LOGIT_TOL = 1e-4
ENCDEC = ("whisper-large-v3", "internvl2-1b")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    cfg = get_arch(arch, reduced=True)
    tcfg = t_get_arch(arch, reduced=True)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _close(j, t, tol=TOL):
    a = np.asarray(j, np.float32)
    b = t.detach().float().numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def _layer(jparams, l=0):
    """Layer l of the JAX decoder stack (pattern slot p0)."""
    return jax.tree.map(lambda a: a[l], jparams["blocks"]["p0"])


def _normal(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_sinusoid_pos_embedding_matches_jax():
    """JAX's table within 1e-5 at the reduced sizes; at whisper's 1500
    frames within 2e-4: the fp32 angle is position × frequency, and one
    ulp of a frequency (XLA's and PyTorch's exp differ in it) is 1.2e-4
    of the angle at position 1500, for both tables alike against float64
    sines of the same angles."""
    for S, D, tol in ((64, 256, TOL), (7, 6, TOL), (1500, 1280, 2e-4)):
        _close(JL.sinusoid_pos_embedding(S, D),
               TL.sinusoid_pos_embedding(S, D), tol)


def test_encoder_attention_and_cross_attention_match_jax():
    """The encoder's self-attention (not causal, no RoPE), cross-attention
    projected from the encoder's output and read from cached K/V, and
    its decode form (one query over every encoder position), each equal
    to JAX's, the K/V handed back included."""
    cfg, jparams, tcfg, tparams = _pair("whisper-large-v3")
    rng = np.random.default_rng(0)
    B, S, Se = 2, 9, cfg.encoder_seq_len
    D = cfg.d_model
    x = _normal(rng, B, S, D)
    enc = _normal(rng, B, Se, D)
    pos = np.broadcast_to(np.arange(Se, dtype=np.int32), (B, Se))
    jp = _layer(jparams)
    tp = tparams["layers"][0]
    jo, (jk, jv) = jax.jit(JB.attn_full, static_argnums=2,
                           static_argnames=("causal", "use_rope"))(
        jp["attn"], jnp.asarray(enc), cfg, jnp.asarray(pos), causal=False,
        use_rope=False)
    to, (tk, tv) = TB.attn_full(tp["attn"], torch.tensor(enc), tcfg,
                                torch.tensor(pos), causal=False,
                                use_rope=False)
    _close(jo, to)
    _close(jk, tk)
    _close(jv, tv)
    jx = jax.jit(JB.cross_attn_full, static_argnums=3)
    jo, (jk, jv) = jx(jp["xattn"], jnp.asarray(x), jnp.asarray(enc), cfg)
    to, (tk, tv) = TB.cross_attn_full(tp["xattn"], torch.tensor(x),
                                      torch.tensor(enc), tcfg)
    _close(jo, to)
    _close(jk, tk)
    _close(jv, tv)
    ek, ev = _normal(rng, *tk.shape), _normal(rng, *tv.shape)
    for q in (x, x[:, :1]):                     # chunk, then decode form
        jo, _ = jax.jit(JB.cross_attn_full, static_argnums=3)(
            jp["xattn"], jnp.asarray(q), None, cfg,
            enc_kv=(jnp.asarray(ek), jnp.asarray(ev)))
        to, (rk, rv) = TB.cross_attn_full(
            tp["xattn"], torch.tensor(q), None, tcfg,
            enc_kv=(torch.tensor(ek), torch.tensor(ev)))
        _close(jo, to)
        assert np.array_equal(rk.numpy(), ek) and np.array_equal(rv.numpy(),
                                                                 ev)


def test_run_encoder_matches_jax():
    cfg, jparams, tcfg, tparams = _pair("whisper-large-v3")
    frames = _normal(np.random.default_rng(1), 2, cfg.encoder_seq_len,
                     cfg.d_model, scale=0.1)
    je = jax.jit(JM._run_encoder, static_argnums=0)(cfg, jparams,
                                                     jnp.asarray(frames))
    te = TM._run_encoder(tcfg, tparams, torch.tensor(frames))
    _close(je, te)


@pytest.mark.parametrize("step", ["decode", "extend"])
def test_block_cross_attention_arm_matches_jax(step):
    """A whisper decoder layer's `block_decode`/`block_extend` over an
    entry of ((k, v), (enc_k, enc_v)): JAX's output and K/V writes, the
    encoder K/V read and left as they were."""
    cfg, jparams, tcfg, tparams = _pair("whisper-large-v3")
    rng = np.random.default_rng(2)
    B, S, Se = 2, 32, cfg.encoder_seq_len
    K, hd, D = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    kc, vc = _normal(rng, B, S, K, hd), _normal(rng, B, S, K, hd)
    ek, ev = _normal(rng, B, Se, K, hd), _normal(rng, B, Se, K, hd)
    cur = np.array([11, 4], np.int32)
    kvp = np.where(np.arange(S)[None] < cur[:, None], np.arange(S), -1
                   ).astype(np.int32)
    Sq = 1 if step == "decode" else 5
    where = cur if step == "decode" else (
        cur[:, None] + np.arange(Sq)).astype(np.int32)
    x = _normal(rng, B, Sq, D)
    jfn = JB.block_decode if step == "decode" else JB.block_extend
    jx_, jentry, jkvp = jax.jit(jfn, static_argnums=(2, 3))(
        _layer(jparams), jnp.asarray(x), cfg.layer_kinds()[0], cfg,
        ((jnp.asarray(kc), jnp.asarray(vc)),
         (jnp.asarray(ek), jnp.asarray(ev))),
        jnp.asarray(kvp), jnp.asarray(where))
    t = [torch.tensor(a) for a in (kc, vc, ek, ev, kvp)]
    tfn = TB.block_decode if step == "decode" else TB.block_extend
    tx, tentry = tfn(tparams["layers"][0], torch.tensor(x),
                     tcfg.layer_kinds()[0], tcfg,
                     ((t[0], t[1]), (t[2], t[3])), t[4], torch.tensor(where))
    _close(jx_, tx)
    (jk, jv), (jek, jev) = jentry
    _close(jk, t[0])
    _close(jv, t[1])
    _close(jkvp, t[4])
    assert tentry[0] is t[0] and tentry[1] is t[1]
    assert np.array_equal(t[2].numpy(), ek) and np.array_equal(t[3].numpy(),
                                                               ev)


@pytest.mark.parametrize("arch", ENCDEC)
def test_params_bridge_carries_encoder_and_cross_attention(arch):
    """The JAX params reach the port leaf for leaf: whisper's encoder
    stack (a list of layer dicts), `enc_ln_f` and every decoder layer's
    `ln_x`/`xattn`; internvl2-1b's decoder."""
    cfg, jparams, tcfg, tparams = _pair(arch)
    jp = jax.tree.map(np.asarray, jparams)
    if cfg.is_encoder_decoder:
        assert len(tparams["encoder"]) == cfg.num_encoder_layers
        for i, layer in enumerate(tparams["encoder"]):
            ref = jax.tree.map(lambda a, i=i: a[i], jp["encoder"])
            for (path, a), (_p, b) in zip(
                    jax.tree_util.tree_leaves_with_path(ref),
                    jax.tree_util.tree_leaves_with_path(layer)):
                assert np.array_equal(a, b.numpy()), path
        assert np.array_equal(jp["enc_ln_f"], tparams["enc_ln_f"].numpy())
        for l, layer in enumerate(tparams["layers"]):
            for name in ("ln_x", "xattn"):
                ref = jax.tree.map(lambda a, l=l: a[l],
                                   jp["blocks"]["p0"][name])
                got = jax.tree.map(lambda t: t.numpy(), layer[name])
                for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
                    assert np.array_equal(a, b)
    else:
        assert "encoder" not in tparams
        assert all("xattn" not in p for p in tparams["layers"])


@pytest.mark.parametrize("arch", ENCDEC)
def test_init_params_matches_jax_shapes_and_scales(arch):
    """The port's own init makes the JAX init's leaves (shapes, dtypes,
    scales; other random numbers), the encoder and cross-attention
    included."""
    _cfg, _jp, tcfg, ref = _pair(arch)
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_t) == len(flat_r)
    for path, t in flat_t:
        r = flat_r[path]
        assert t.shape == r.shape and t.dtype == r.dtype, path
        st, sr = float(t.float().std()), float(r.float().std())
        assert abs(st - sr) <= 0.1 * max(sr, 1e-6) or st == sr == 0, path


def test_cache_bridge_roundtrip_carries_encoder_kv():
    """A dense whisper cache crosses the bridge both ways unchanged, its
    (kv, enc_kv) entries included; the port's zero cache is JAX's."""
    cfg, _jp, tcfg, _tp = _pair("whisper-large-v3")
    jc = jax.tree.map(np.array, JM.init_cache(cfg, 3, 32))
    rng = np.random.default_rng(3)
    jc["blocks"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jc["blocks"])
    jc["kv_pos"] = rng.integers(-1, 30, size=jc["kv_pos"].shape
                                ).astype(np.int32)
    jc["cur"][:] = [3, 30, 0]
    tc = cache_from_numpy(tcfg, jc, device="cpu")
    L, Se = cfg.num_layers, cfg.encoder_seq_len
    assert tc["enc_k"].shape == (L, 3, Se, cfg.num_kv_heads,
                                 cfg.resolved_head_dim)
    back = cache_to_numpy(tcfg, tc)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    z = jax.tree.map(np.asarray, JM.init_cache(cfg, 3, 32))
    t = TM.init_cache(tcfg, 3, 32, device="cpu")
    for a, b in zip(jax.tree.leaves(z),
                    jax.tree.leaves(cache_to_numpy(tcfg, t))):
        assert np.array_equal(a, b)


def test_cache_join_take_row_carry_encoder_kv():
    """Two batch-1 whisper prefills joined into rows of a batch cache
    carry their encoder K/V (JAX's `cache_join` alike); the batch then
    decodes each row as its own serial decode; `cache_take` returns a
    row's encoder K/V, `cache_row` views them, `cache_clear_row` zeroes
    them."""
    cfg, jparams, tcfg, tparams = _pair("whisper-large-v3")
    rng = np.random.default_rng(4)
    frames = _normal(rng, 2, cfg.encoder_seq_len, cfg.d_model, scale=0.1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    jpre = jax.jit(lambda p, t, e: JM.prefill(cfg, p, t, embeds=e,
                                              max_len=32))
    jdec = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    jdst = JM.init_cache(cfg, 3, 32)
    tdst = TM.init_cache(tcfg, 3, 32, device="cpu")
    first = []
    for r, slot in ((0, 2), (1, 0)):
        jl, jc = jpre(jparams, jnp.asarray(toks[r:r + 1, :6 + 3 * r]),
                      jnp.asarray(frames[r:r + 1]))
        tl, tc = TM.prefill(tcfg, tparams, torch.tensor(toks[r:r + 1,
                                                             :6 + 3 * r]),
                            embeds=torch.tensor(frames[r:r + 1]), max_len=32)
        _close(jl, tl, LOGIT_TOL)
        first.append(int(np.argmax(np.asarray(jl)[0])))
        jdst = JM.cache_join(jdst, jc, slot)
        tdst = TM.cache_join(tdst, tc, slot)
        assert torch.equal(TM.cache_take(tdst, slot)["enc_k"], tc["enc_k"])
        assert TM.cache_row(tdst, slot)["enc_v"].data_ptr() == \
            tdst["enc_v"][:, slot].data_ptr()
    tok = np.array([[first[1]], [0], [first[0]]], np.int32)
    for _ in range(4):
        jl, jdst = jdec(jparams, jnp.asarray(tok), jdst)
        tl, tdst = TM.decode_step(tcfg, tparams, torch.tensor(tok), tdst)
        _close(jl, tl, LOGIT_TOL)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    j = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jdst), device="cpu")
    for name in ("enc_k", "enc_v", "k", "v"):
        _close(j[name], tdst[name])
    TM.cache_clear_row(tdst, 2)
    assert not tdst["enc_k"][:, 2].any() and tdst["enc_k"][:, 0].any()


@pytest.mark.parametrize("arch", list_archs())
def test_model_level_functions_take_every_arch(arch):
    """`require_supported` refuses no registered architecture: the port's
    init, dense cache and bridge take each; the paged cache takes an
    encoder-decoder model, with per-slot encoder K/V beside the pages."""
    cfg = t_get_arch(arch, reduced=True)
    TM.require_supported(cfg)
    params = TM.init_params(cfg, seed=0, device="cpu")
    cache = TM.init_cache(cfg, 2, 32, device="cpu")
    assert ("enc_k" in cache) == cfg.is_encoder_decoder
    assert ("encoder" in params) == cfg.is_encoder_decoder
    if cfg.is_encoder_decoder:
        assert TM.paged_layout(cfg, 32, 8) == (4, 8)
        paged = TM.init_paged_cache(cfg, 3, 5, 32, 8, device="cpu")
        assert paged["enc_k"].shape == (cfg.num_layers, 3,
                                        cfg.encoder_seq_len,
                                        cfg.num_kv_heads,
                                        cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", ENCDEC)
def test_serving_engines_refuse_with_the_reason(arch):
    """The engines (`EngineSpec`, so `RealSBSServer`) keep refusing
    encoder-decoder and patch-embedding models: their requests carry no
    frame or patch embeddings to the prefill."""
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    _cfg, _jp, tcfg, tparams = _pair(arch)
    with pytest.raises(NotImplementedError,
                       match="no frame or patch embeddings"):
        EngineSpec(tcfg, tparams, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="no frame or patch embeddings"):
        RealSBSServer(tcfg, tparams, device="cpu")


def test_vlm_patch_prefix_prefill_then_chunk_matches_full_forward():
    """internvl2-1b: `prefill` over the patch prefix and a prompt, then
    `prefill_chunk` and `decode_step`, give the port's own full forward's
    logits over the same tokens (the reference's own check,
    `tests/test_models_consistency.py:39`), with `cur` counting the
    patch prefix."""
    _cfg, _jp, tcfg, tparams = _pair("internvl2-1b")
    rng = np.random.default_rng(6)
    P = tcfg.num_patch_tokens
    emb = torch.tensor(_normal(rng, 2, P, tcfg.d_model, scale=0.1))
    toks = torch.tensor(rng.integers(0, tcfg.vocab_size, size=(2, 16)))
    x, _c, _a, _e = TM.forward_full(tcfg, tparams, toks, embeds=emb)
    full = TM.logits_from_hidden(tcfg, tparams, x)
    lg, cache = TM.prefill(tcfg, tparams, toks[:, :4], embeds=emb,
                           max_len=64)
    assert cache["cur"].tolist() == [P + 4, P + 4]
    _close(full[:, P + 3].numpy(), lg, 2e-3)
    lg, cache = TM.prefill_chunk(tcfg, tparams, toks[:, 4:12], cache)
    _close(full[:, P + 11].numpy(), lg, 2e-3)
    for t in range(12, 16):
        lg, cache = TM.decode_step(tcfg, tparams, toks[:, t:t + 1], cache)
        _close(full[:, P + t].numpy(), lg, 2e-3)


def test_quickstart_torch_runs_on_cpu():
    """`examples/quickstart_torch.py --device cpu`: the scheduler core,
    prefill -> chunk -> decode on reduced deepseek-v3-671b,
    whisper-large-v3 and internvl2-1b, and the cluster simulation, with
    no JAX imported."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in ("== 1. SBS core ==", "deepseek-v3-671b[reduced]",
                 "whisper-large-v3[reduced]", "internvl2-1b[reduced]",
                 "== 3. cluster sim", "jax imported: False"):
        assert line in out.stdout, line


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 4b and 6i, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _counters():
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    return [paged_decode_attention, paged_prefill_attention, flash_prefill,
            decode_attention, ssd_chunk]


def test_chip_smoke_encdec_phase_rehearsed():
    """Phase 6i at the reduced configs on the CPU: prefill, the chunk and
    the decode steps of reduced whisper-large-v3 and internvl2-1b agree
    with chip_smoke's plain forward (fp32, so far inside its bf16
    tolerance); on the CPU the wrappers take their plain versions, so no
    launch is counted, while the path's expected calls are reported."""
    cs = _chip_smoke()
    rep = cs.serve_encdec_phase(_counters(), "cpu", reduced=True)
    assert set(rep) == {"whisper-large-v3", "internvl2-1b"}
    for arch, r in rep.items():
        assert r["logits_rel_err_prefill"] <= 1e-4, arch
        assert r["logits_rel_err_chunk"] <= 1e-4, arch
        assert set(r["launches"].values()) == {0}, arch
    w = rep["whisper-large-v3"]["expected"]
    assert w["flash_prefill_noncausal"] == 2 + 2 * (2 + cs.ENCDEC_STEPS)
    assert w["flash_prefill_noncausal_decode"] == 2 * cs.ENCDEC_STEPS
    assert w["flash_prefill_noncausal_chunk"] == 2
    assert rep["whisper-large-v3"]["noncausal_per_decode_step"] == 0
    assert rep["internvl2-1b"]["expected"]["flash_prefill_noncausal"] == 0


def test_chip_smoke_full_kernel_phase_rehearsed(monkeypatch):
    """Phase 4b on the CPU (the wrappers take their plain versions), with
    the encoder's 1500 frames cut to 96 and a host timer: every case runs
    and the kernel line's figures are there."""
    import time
    cs = _chip_smoke()

    def host_time(fn, n, iters=20):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i % n)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        return ms, ms
    monkeypatch.setattr(cs, "WHISPER_FRAMES", 96)
    monkeypatch.setattr(cs, "time_ms", host_time)
    out = cs.check_flash_full("cpu")
    assert len(out["errs"]) == 10 and len(out["errs_g7"]) == 2
    assert len(out["errs_dense_g7"]) == 2
    # bf16 first (the plain version in bf16 against fp32: rounding), then
    # fp32, where both sides are the same plain version
    fp32 = out["errs"][5:] + out["errs_g7"][1:] + out["errs_dense_g7"][1:]
    assert max(r for _a, r in fp32) == 0.0
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        assert key in out
    # the cross-attention rows (the decode step's and the chunk's): their
    # errors (bf16 and fp32) and figures, bound by K/V's bytes; each timed
    # shape's plan is the one its call passed to the kernel, so none for
    # the plain version here
    for sq in (1, 16):
        r = out["cross"][sq]
        assert len(r["errs"]) == 2 and r["bound_by"] == "bytes"
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "shape"):
            assert key in r
        assert r["plan"] is None
    assert out["plan"] is None
