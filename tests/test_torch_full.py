"""PyTorch port: the full-sequence serving path (`forward_full`,
`prefill`, then `prefill_chunk` and `decode_step` from `prefill`'s
cache) held against the JAX package on the same (bridged) weights and
the same numpy inputs, for every registered architecture at its reduced
size, in fp32.

The JAX side runs jitted on the CPU, as its own tests run it.  The
twins of `tests/test_models_consistency.py` (the SWA ring that wraps,
rows of different lengths, packed segments) hold the port both against
the JAX functions and, as the reference's own tests do, against its own
full forward (within their TOL, 2e-3).  One case runs past the
reference's FLASH_THRESHOLD (2048), where its attention switches to
`flash_attention_xla`; the port runs kernel #2's contiguous entry (its
plain version on the CPU) at every length.

Tolerances: logits and hidden states within LOGIT_TOL = 1e-4 (fp32
through two layers, sums in another order), as
`tests/test_torch_model.py`; greedy tokens exact; cache entries within
1e-5 (SSM states within 1e-5 of their largest magnitude), positions
and cursors exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch, list_archs
from repro.models import model as JM

from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import model as TM

ARCHS = list_archs()
LOGIT_TOL = 1e-4
REF_TOL = 2e-3            # tests/test_models_consistency.py's TOL
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _pair(arch, **changes):
    """(JAX cfg, JAX params, port cfg, port params) of a reduced arch,
    with `changes` applied to both configs."""
    cfg = dataclasses.replace(get_arch(arch, reduced=True), **changes)
    tcfg = dataclasses.replace(t_get_arch(arch, reduced=True), **changes)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _embeds(cfg, B, seed):
    """Stub frame (encoder-decoder) or patch (VLM) embeddings, or None."""
    rng = np.random.default_rng(seed)
    n = (cfg.encoder_seq_len if cfg.is_encoder_decoder
         else cfg.num_patch_tokens)
    if not n:
        return None
    return (rng.normal(size=(B, n, cfg.d_model)) * 0.1).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


def _close(j, t, tol=LOGIT_TOL):
    d = np.abs(np.asarray(j, np.float32) - t.detach().float().numpy())
    assert d.max() <= tol, d.max()


def _assert_cache_match(tcfg, jc, tc, rel=()):
    """Same cursors and positions; every K/V row, conv tail and encoder
    K/V within 1e-5, SSM states within 1e-5 of their largest magnitude,
    the entries named in `rel` within 1e-4 of theirs."""
    j = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert set(j) == set(tc)
    for name in ("cur", "kv_pos"):
        assert torch.equal(j[name], tc[name].to(torch.int32)), name
    for name in set(tc) - {"cur", "kv_pos"}:
        ref = j[name]
        assert ref.shape == tc[name].shape, name
        tol = 1e-5
        if name == "ssm" or name in rel:
            tol = (1e-4 if name in rel else 1e-5) * max(
                1.0, float(ref.abs().max()))
        assert float((tc[name] - ref).abs().max()) <= tol, name


@functools.lru_cache(maxsize=None)
class _Jax:
    """The JAX full-sequence family of one config, jitted (one instance
    per config and cache length)."""

    def __init__(self, cfg, max_len=MAX_LEN):
        self.forward = jax.jit(
            lambda p, t, e, pos, seg: JM.forward_full(
                cfg, p, t, positions=pos, seg=seg, embeds=e))
        self.prefill = jax.jit(
            lambda p, t, e, n: JM.prefill(cfg, p, t, embeds=e, lengths=n,
                                          max_len=max_len))
        self.chunk = jax.jit(lambda p, t, c: JM.prefill_chunk(cfg, p, t, c))
        self.decode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))


def _full_logits(cfg, params, tokens, **kw):
    """Every position's logits of the port's forward."""
    x, _c, _a, _e = TM.forward_full(cfg, params, tokens, **kw)
    return TM.logits_from_hidden(cfg, params, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_matches_jax(arch):
    """Hidden states at every position, the last token's logits and the
    MoE aux loss of `forward_full` equal JAX's, a VLM's patch prefix and
    an encoder-decoder's encoder included."""
    cfg, jparams, tcfg, tparams = _pair(arch)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    emb = _embeds(cfg, B, 2)
    jx, _c, jaux, jenc = _Jax(cfg).forward(jparams, jnp.asarray(tokens),
                                           _j(emb), None, None)
    tx, _c, taux, tenc = TM.forward_full(tcfg, tparams, torch.tensor(tokens),
                                         embeds=_t(emb))
    n_pre = 0 if cfg.is_encoder_decoder else cfg.num_patch_tokens
    assert tx.shape == jx.shape == (B, S + n_pre, cfg.d_model)
    _close(jx, tx)
    _close(JM.logits_from_hidden(cfg, jparams, jx[:, -1]),
           TM.logits_from_hidden(tcfg, tparams, tx[:, -1]))
    _close(jaux, taux)
    assert (jenc is None) == (tenc is None)
    if tenc is not None:
        _close(jenc, tenc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_decode_token_exact(arch):
    """`prefill` of two rows of different lengths, then a 4-token
    `prefill_chunk` and 8 greedy `decode_step`s from its cache, in
    lockstep with JAX: the cache after `prefill` equal (the encoder K/V
    of every decoder layer, SSM states and conv tails included), each
    step's logits within LOGIT_TOL and the same greedy tokens."""
    cfg, jparams, tcfg, tparams = _pair(arch)
    jx = _Jax(cfg)
    B, S0 = 2, 10
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S0 + 4)).astype(
        np.int32)
    emb = _embeds(cfg, B, 4)
    lengths = np.array([S0 - 3, S0], np.int32)
    jl, jc = jx.prefill(jparams, jnp.asarray(tokens[:, :S0]), _j(emb),
                        jnp.asarray(lengths))
    tl, tc = TM.prefill(tcfg, tparams, torch.tensor(tokens[:, :S0]),
                        embeds=_t(emb), lengths=torch.tensor(lengths),
                        max_len=MAX_LEN)
    _close(jl, tl)
    _assert_cache_match(tcfg, jc, tc)
    jl, jc = jx.chunk(jparams, jnp.asarray(tokens[:, S0:]), jc)
    tl, tc = TM.prefill_chunk(tcfg, tparams, torch.tensor(tokens[:, S0:]), tc)
    _close(jl, tl)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(8):
        jl, jc = jx.decode(jparams, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.tensor(tok), tc)
        _close(jl, tl)
        assert np.array_equal(np.argmax(np.asarray(jl), -1),
                              tl.numpy().argmax(-1))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    _assert_cache_match(tcfg, jc, tc)


def test_swa_ring_buffer_wraps_correctly():
    """tests/test_models_consistency.py:60 on the port: a prefill longer
    than the window (8) places the ring as the reference's, and decode
    wraps it; every step matches JAX within LOGIT_TOL and the port's own
    full forward within the reference's TOL."""
    cfg, jparams, tcfg, tparams = _pair("h2o-danube-3-4b", sliding_window=8)
    jx = _Jax(cfg)
    B, S, S0 = 2, 40, 13
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    full = _full_logits(tcfg, tparams, torch.tensor(tokens))
    jl, jc = jx.prefill(jparams, jnp.asarray(tokens[:, :S0]), None,
                        jnp.full((B,), S0, jnp.int32))
    tl, tc = TM.prefill(tcfg, tparams, torch.tensor(tokens[:, :S0]),
                        max_len=MAX_LEN)
    assert tc["kv_pos"].shape == (B, 8)
    _assert_cache_match(tcfg, jc, tc)
    _close(jl, tl)
    _close(full[:, S0 - 1], tl, REF_TOL)
    for t in range(S0, S):
        jl, jc = jx.decode(jparams, jnp.asarray(tokens[:, t:t + 1]), jc)
        tl, tc = TM.decode_step(tcfg, tparams,
                                torch.tensor(tokens[:, t:t + 1]), tc)
        _close(jl, tl)
        _close(full[:, t], tl, REF_TOL)
    _assert_cache_match(tcfg, jc, tc)


def test_variable_length_prefill_rows():
    """tests/test_models_consistency.py:77 on the port: each row's logits
    are its own last valid position's, and decode continues each row at
    its own position; JAX's logits and cache alike."""
    cfg, jparams, tcfg, tparams = _pair("deepseek-7b")
    jx = _Jax(cfg, max_len=32)
    B, S = 2, 12
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    full = _full_logits(tcfg, tparams, torch.tensor(tokens))
    lengths = np.array([5, 12], np.int32)
    jl, jc = jx.prefill(jparams, jnp.asarray(tokens), None,
                        jnp.asarray(lengths))
    tl, tc = TM.prefill(tcfg, tparams, torch.tensor(tokens),
                        lengths=torch.tensor(lengths), max_len=32)
    _close(jl, tl)
    _assert_cache_match(tcfg, jc, tc)
    _close(full[0, 4], tl[0], REF_TOL)
    _close(full[1, 11], tl[1], REF_TOL)
    nxt = np.stack([tokens[0, 5:6], tokens[1, 11:12]])
    jl, jc = jx.decode(jparams, jnp.asarray(nxt), jc)
    tl, tc = TM.decode_step(tcfg, tparams, torch.tensor(nxt), tc)
    _close(jl, tl)
    _close(full[0, 5], tl[0], REF_TOL)
    _assert_cache_match(tcfg, jc, tc)


def test_packed_segments_are_isolated():
    """tests/test_models_consistency.py:96 on the port: two documents
    packed into one row (segment ids, positions restarting) give the
    logits of each run alone, and JAX's packed logits."""
    cfg, jparams, tcfg, tparams = _pair("deepseek-7b")
    rng = np.random.default_rng(2)
    d1 = rng.integers(0, cfg.vocab_size, size=(1, 7)).astype(np.int32)
    d2 = rng.integers(0, cfg.vocab_size, size=(1, 5)).astype(np.int32)
    packed = np.concatenate([d1, d2], axis=1)
    seg = np.asarray([[0] * 7 + [1] * 5], np.int32)
    pos = np.asarray([list(range(7)) + list(range(5))], np.int32)
    jx, _c, _a, _e = _Jax(cfg).forward(jparams, jnp.asarray(packed), None,
                                       jnp.asarray(pos), jnp.asarray(seg))
    lp = _full_logits(tcfg, tparams, torch.tensor(packed),
                      positions=torch.tensor(pos), seg=torch.tensor(seg))
    _close(JM.logits_from_hidden(cfg, jparams, jx), lp)
    l1 = _full_logits(tcfg, tparams, torch.tensor(d1))
    l2 = _full_logits(tcfg, tparams, torch.tensor(d2))
    _close(l1, lp[:, :7], REF_TOL)
    _close(l2, lp[:, 7:], REF_TOL)


def test_packed_segments_with_padding_and_patch_prefix():
    """Segment -1 (padding) rows attend to nothing and leave the others
    alone; a VLM's patch prefix takes the first text token's segment
    (`repro/models/model.py:755-758`): the port equals JAX."""
    for arch in ("deepseek-7b", "internvl2-1b"):
        cfg, jparams, tcfg, tparams = _pair(arch)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(
            np.int32)
        seg = np.asarray([[0] * 5 + [1] * 5 + [-1] * 2,
                          [1] * 9 + [-1] * 3], np.int32)
        emb = _embeds(cfg, 2, 6)
        n = 0 if emb is None else emb.shape[1]
        pos = np.broadcast_to(np.arange(12 + n, dtype=np.int32), (2, 12 + n))
        jx, _c, _a, _e = _Jax(cfg).forward(jparams, jnp.asarray(tokens),
                                           _j(emb), jnp.asarray(pos),
                                           jnp.asarray(seg))
        tx, _c, _a, _e = TM.forward_full(tcfg, tparams, torch.tensor(tokens),
                                         positions=torch.tensor(pos),
                                         seg=torch.tensor(seg),
                                         embeds=_t(emb))
        _close(jx, tx)


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-v3-671b"])
def test_past_flash_threshold_matches_jax(arch):
    """S = 2304 > FLASH_THRESHOLD (2048) on reduced deepseek-7b (GQA) and
    deepseek-v3 (MLA): the reference's `flash_attention_xla` branch is
    the oracle of the port's kernel #2 path (its plain version here) and
    of `mla_full`'s blockwise plain attention; hidden states and the last
    token's logits within LOGIT_TOL, the cache after `prefill` equal, its
    K/V rows within 1e-4 of their largest magnitude (about 5): at
    positions past 2000 the fp32 sine and cosine of the RoPE angle differ
    between XLA and PyTorch in the last bits (2.3e-4 in layer 0's K,
    whose input took no attention, against 1.4e-6 in its V; 3.3e-5 in
    layer 1's V, which reads layer 0's attention)."""
    cfg, jparams, tcfg, tparams = _pair(arch)
    S = 2304
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, size=(1, S)).astype(np.int32)
    jfwd = _Jax(cfg, max_len=S + 16)
    jl, jc = jfwd.prefill(jparams, jnp.asarray(tokens), None,
                          jnp.asarray([S], jnp.int32))
    jx, _c, _a, _e = jfwd.forward(jparams, jnp.asarray(tokens), None, None,
                                  None)
    tx, _c, _a, _e = TM.forward_full(tcfg, tparams, torch.tensor(tokens))
    _close(jx, tx)
    tl, tc = TM.prefill(tcfg, tparams, torch.tensor(tokens), max_len=S + 16)
    _close(jl, tl)
    _assert_cache_match(tcfg, jc, tc, rel=("k", "v"))
