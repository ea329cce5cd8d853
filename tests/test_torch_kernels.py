"""PyTorch port: the plain versions of the CUDA kernels, held against the
JAX oracles (`kernels/*/ref.py`) and the Pallas kernels in interpret
mode, on the shape sweeps of tests/test_kernels.py (dense decode also on
a wrapped sliding-window ring); the paged flash prefill entry held
against `attn_extend_paged`; and the wrappers' argument checks.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances as tests/test_kernels.py: 1e-5 in fp32, 2e-2 in bf16 (the two
frameworks round bf16 intermediates at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.kernels.decode_attention.ops import (
    decode_attention as pallas_decode,
    paged_decode_attention as pallas_paged_decode,
)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as _dense_decode_ref,
    paged_decode_attention_ref as _decode_ref,
)
from repro.kernels.flash_prefill.ops import flash_prefill as pallas_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as _flash_ref
from repro.models import blocks as JB
from repro.models.model import init_params as j_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_prefill import (
    flash_prefill, flash_prefill_plain, paged_prefill_attention,
)
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.models import blocks as TB

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
# the JAX oracles, jitted: one compile per shape instead of one per op
paged_decode_attention_ref = jax.jit(_decode_ref, static_argnames="window")
decode_attention_ref = jax.jit(_dense_decode_ref, static_argnames="window")
flash_prefill_ref = jax.jit(_flash_ref, static_argnames=("causal", "window"))
jax_attn_extend_paged = jax.jit(JB.attn_extend_paged, static_argnums=2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(x, dtype):
    """The same numpy values as a JAX and a torch array of `dtype`."""
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.tensor(x)
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.tensor(x).to(TDT[dtype]))


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32)
                        - t.float().numpy()).max())


# ---------------------------------------------------------------------------
# (b) paged decode attention, sweep of tests/test_kernels.py:116
# ---------------------------------------------------------------------------

def _decode_sweep_inputs(B, N, bs, nbt, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32) * 0.5
    k_pool = rng.normal(size=(N, bs, K, hd)).astype(np.float32) * 0.5
    v_pool = rng.normal(size=(N, bs, K, hd)).astype(np.float32) * 0.5
    free = list(range(1, N))
    rng.shuffle(free)
    tabs = []
    for b in range(B):
        n_real = int(rng.integers(0, nbt + 1)) if b else nbt
        tabs.append([free.pop() for _ in range(n_real)]
                    + [-1] * (nbt - n_real))
    # valid positions everywhere, the null block included: the table
    # masking must hide it
    kv_pos_pool = np.broadcast_to(np.arange(bs, dtype=np.int32)[None],
                                  (N, bs)).copy()
    pos = np.full((B,), bs - 1, np.int32)
    return q, k_pool, v_pool, kv_pos_pool, np.asarray(tabs, np.int32), pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,bs,nbt,H,K,hd", [
    (3, 16, 16, 4, 4, 2, 32),
    (2, 20, 32, 3, 8, 4, 16),
    (1, 6, 64, 2, 2, 1, 64),
])
def test_paged_decode_plain_matches_ref_and_pallas(dtype, B, N, bs, nbt, H,
                                                   K, hd):
    args = _decode_sweep_inputs(B, N, bs, nbt, H, K, hd)
    j = [_pair(a, dtype)[0] for a in args]
    t = [_pair(a, dtype)[1] for a in args]
    out = paged_decode_attention(*t)          # CPU: the plain version
    assert out.shape == (B, H, hd) and out.dtype == TDT[dtype]
    assert _err(paged_decode_attention_ref(*j), out) < TOLS[dtype]
    assert _err(pallas_paged_decode(*j, interpret=True), out) < TOLS[dtype]


def test_paged_decode_plain_masks_unset_rows_and_window():
    """An all -1 row gives 0; the window masks old keys like the ref."""
    args = list(_decode_sweep_inputs(3, 16, 16, 4, 4, 2, 32, seed=1))
    args[4][2] = -1
    args[5] = np.array([40, 63, 20], np.int32)
    args[3] = np.tile(np.arange(64, dtype=np.int32).reshape(4, 16), (4, 1))
    j = [jnp.asarray(a) for a in args]
    t = [torch.tensor(a) for a in args]
    for window in (0, 8):
        out = paged_decode_attention_plain(*t, window=window)
        assert _err(paged_decode_attention_ref(*j, window=window), out) < 1e-5
        assert float(out[2].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (b') dense decode attention, sweep of tests/test_kernels.py:79-110
# ---------------------------------------------------------------------------

def _dense_decode_inputs(B, S, H, K, hd, pos, window=0, seed=0):
    """Caches as the engine keeps them: position p sits at index p % S
    (a ring once pos >= S), entries older than the window or never
    written are -1 or stale; pos[b] < 0 marks a row with no valid key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32) * 0.5
    kc = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    vc = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    kv_pos = np.full((B, S), -1, np.int32)
    for b, p in enumerate(pos):
        for t in range(max(p + 1 - S, 0), p + 1):
            kv_pos[b, t % S] = t
    return q, kc, vc, kv_pos, np.asarray(pos, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,bk", [
    (2, 128, 8, 2, 64, 32),
    (3, 64, 4, 4, 32, 64),
    (1, 256, 16, 1, 16, 128),
])
def test_dense_decode_plain_matches_ref_and_pallas(dtype, B, S, H, K, hd,
                                                   bk):
    pos = [min(5 + 61 * b, S - 1) for b in range(B)]
    args = _dense_decode_inputs(B, S, H, K, hd, pos)
    j = [_pair(a, dtype)[0] for a in args]
    t = [_pair(a, dtype)[1] for a in args]
    out = decode_attention(*t)                # CPU: the plain version
    assert out.shape == (B, H, hd) and out.dtype == TDT[dtype]
    assert _err(decode_attention_ref(*j), out) < TOLS[dtype]
    assert _err(pallas_decode(*j, block_kv=bk, interpret=True), out) \
        < TOLS[dtype]


@pytest.mark.parametrize("window", [0, 16, 64])
def test_dense_decode_plain_wrapped_ring(window):
    """A sliding-window ring of S = 64 entries wrapped several times
    (entries out of position order), a fresh row and a row with no valid
    key (all -1, which must give 0)."""
    B, S, H, K, hd = 4, 64, 8, 2, 32
    q, kc, vc, kv_pos, pos = _dense_decode_inputs(
        B, S, H, K, hd, [150, 63, 7, 90], seed=4)
    kv_pos[3] = -1
    j = [jnp.asarray(a) for a in (q, kc, vc, kv_pos, pos)]
    t = [torch.tensor(a) for a in (q, kc, vc, kv_pos, pos)]
    out = decode_attention_plain(*t, window=window)
    assert _err(decode_attention_ref(*j, window=window), out) < 1e-5
    assert _err(pallas_decode(*j, window=window, block_kv=32,
                              interpret=True), out) < 1e-5
    assert float(out[3].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (c) flash prefill, sweep of tests/test_kernels.py:33-37
# ---------------------------------------------------------------------------

def _flash_inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,bq,bk", [
    (1, 64, 2, 2, 32, 32, 32),
    (2, 64, 4, 2, 32, 16, 64),
    (1, 128, 8, 1, 16, 64, 32),
])
def test_flash_prefill_plain_matches_ref_and_pallas(dtype, B, S, H, K, hd,
                                                    bq, bk):
    q, k, v = _flash_inputs(B, S, H, K, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    seg = np.zeros((B, S), np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jp, tp = _pair(pos, dtype)
    js, ts = _pair(seg, dtype)
    out = flash_prefill(tq, tk, tv, tp, tp, ts, ts)
    assert out.shape == (B, S, H, hd) and out.dtype == TDT[dtype]
    assert _err(flash_prefill_ref(jq, jk, jv, jp, jp, js, js), out) \
        < TOLS[dtype]
    assert _err(pallas_flash(jq, jk, jv, jp, jp, js, js, block_q=bq,
                             block_kv=bk, interpret=True), out) < TOLS[dtype]


@pytest.mark.parametrize("window", [0, 8])
def test_flash_prefill_plain_packed_varlen(window):
    """Segments + padding in one chunk (the paper's C_chunk), with and
    without a window; padding rows are 0."""
    B, S, H, K, hd = 2, 64, 4, 2, 32
    q, k, v = _flash_inputs(B, S, H, K, hd, seed=3)
    pos = np.tile(np.concatenate([np.arange(24), np.arange(30),
                                  np.zeros(10)]).astype(np.int32), (B, 1))
    seg = np.tile(np.concatenate([np.zeros(24), np.ones(30),
                                  -np.ones(10)]).astype(np.int32), (B, 1))
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos, seg, seg)]
    t = [torch.tensor(a) for a in (q, k, v, pos, pos, seg, seg)]
    out = flash_prefill_plain(*t, window=window)
    assert _err(flash_prefill_ref(*j, window=window), out) < 1e-5
    assert _err(pallas_flash(*j, window=window, block_q=32, block_kv=32,
                             interpret=True), out) < 1e-5
    assert float(out[:, 54:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (c) the paged entry against attn_extend_paged
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_params():
    cfg = get_arch("deepseek-7b", reduced=True)
    params = jax.jit(j_init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    return cfg, params, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _paged_pool(cfg, N, bs, nbt, rows, seed):
    """Pools with earlier context written for every row: `rows` =
    [(pos0, Sc)]; row b's first pages are shared with row 0's."""
    rng = np.random.default_rng(seed)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kp = rng.normal(size=(N, bs, K, hd)).astype(np.float32) * 0.5
    vp = rng.normal(size=(N, bs, K, hd)).astype(np.float32) * 0.5
    kvp = np.full((N, bs), -1, np.int32)
    kvp[0] = rng.integers(0, 8, size=bs)            # null-block garbage
    free = list(rng.permutation(np.arange(1, N)))
    shared = [free.pop() for _ in range(rows[0][0] // bs)]
    tab = np.full((len(rows), nbt), -1, np.int32)
    for b, (p0, sc) in enumerate(rows):
        n_sh = min(len(shared), p0 // bs)
        n_all = (p0 + sc - 1) // bs + 1
        ids = shared[:n_sh] + [free.pop() for _ in range(n_all - n_sh)]
        tab[b, :n_all] = ids
        for j, phys in enumerate(ids):
            r = np.arange(bs) + j * bs
            kvp[phys] = np.where(r < p0, r, kvp[phys])
    return kp, vp, kvp, tab


@pytest.mark.parametrize("rows", [
    [(21, 16)],                 # a chunk that starts mid-page
    [(32, 19), (16, 11)],       # shared prefix pages, two rows
    [(0, 24)],                  # the first chunk of a prompt
])
def test_attn_extend_paged_matches_jax(dense_params, rows):
    cfg, jparams, tcfg, tparams = dense_params
    N, bs, nbt = 12, 8, 8
    kp, vp, kvp, tab = _paged_pool(cfg, N, bs, nbt, rows, seed=len(rows))
    Sc = max(sc for _p, sc in rows)
    positions = np.stack([np.minimum(p0 + np.arange(Sc), p0 + sc - 1)
                          for p0, sc in rows]).astype(np.int32)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(len(rows), Sc, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["p0"]["attn"])
    jo, (jk, jv, jkvp) = jax_attn_extend_paged(
        jp, jnp.asarray(x), cfg, *(jnp.asarray(a) for a in (kp, vp, kvp,
                                                             tab, positions)))
    t = [torch.tensor(a) for a in (kp, vp, kvp, tab, positions)]
    to = TB.attn_extend_paged(tparams["layers"][0]["attn"], torch.tensor(x),
                              tcfg, *t)
    assert _err(jo, to) < 1e-4
    # the chunk's K/V and positions were written in place, as JAX's
    for j, tt in ((jk, t[0]), (jv, t[1]), (jkvp, t[2])):
        assert _err(np.asarray(j)[1:], tt[1:]) < 1e-5   # null block: garbage


def test_paged_prefill_plain_matches_gather_reference():
    """The plain paged entry == flash_prefill_ref over the gathered view."""
    rng = np.random.default_rng(9)
    N, bs, nbt, H, K, hd = 10, 4, 6, 4, 2, 16
    kp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    kvp = np.tile(np.arange(24, dtype=np.int32).reshape(6, 4), (2, 1))[:N]
    tab = np.array([[1, 2, 3, 4, -1, -1]], np.int32)
    positions = np.arange(9, 15, dtype=np.int32)[None]
    q = rng.normal(size=(1, 6, H, hd)).astype(np.float32)
    out = paged_prefill_attention(*(torch.tensor(a) for a in
                                    (q, kp, vp, kvp, tab, positions)))
    g = np.maximum(tab, 0)
    kg = kp[g].reshape(1, nbt * bs, K, hd)
    vg = vp[g].reshape(1, nbt * bs, K, hd)
    kvg = np.where(tab[..., None] < 0, -1, kvp[g]).reshape(1, nbt * bs)
    seg_q = np.zeros((1, 6), np.int32)
    seg_k = np.zeros((1, nbt * bs), np.int32)
    ref = flash_prefill_ref(*(jnp.asarray(a) for a in
                              (q, kg, vg, positions, kvg, seg_q, seg_k)))
    assert _err(ref, out) < 1e-5


# ---------------------------------------------------------------------------
# wrappers: argument checks (the CUDA path's front door)
# ---------------------------------------------------------------------------

def _decode_args(hd=64, H=4, K=4, tab_dtype=torch.int32):
    q = torch.zeros(2, H, hd)
    pool = torch.zeros(5, 16, K, hd)
    return (q, pool, pool.clone(), torch.zeros(5, 16, dtype=torch.int32),
            torch.zeros(2, 3, dtype=tab_dtype),
            torch.zeros(2, dtype=torch.int32))


def test_decode_check_args_accepts_supported():
    dec_ops.check_args(*_decode_args())
    dec_ops.check_args(*_decode_args(hd=128, H=32, K=4))


@pytest.mark.parametrize("bad", [
    dict(hd=16), dict(H=12, K=1), dict(H=6, K=4),
    dict(tab_dtype=torch.int64)])
def test_decode_check_args_rejects_unsupported(bad):
    with pytest.raises(ValueError):
        dec_ops.check_args(*_decode_args(**bad))


def test_prefill_check_args():
    q = torch.zeros(1, 8, 4, 64)
    pool = torch.zeros(5, 16, 4, 64)
    i32 = dict(dtype=torch.int32)
    fp_ops.check_paged_args(q, pool, pool, torch.zeros(5, 16, **i32),
                            torch.zeros(1, 3, **i32), torch.zeros(1, 8, **i32))
    with pytest.raises(ValueError):                 # positions shape
        fp_ops.check_paged_args(q, pool, pool, torch.zeros(5, 16, **i32),
                                torch.zeros(1, 3, **i32),
                                torch.zeros(1, 7, **i32))
    with pytest.raises(ValueError):                 # not contiguous
        fp_ops.check_paged_args(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), pool, pool,
                                torch.zeros(5, 16, **i32),
                                torch.zeros(1, 3, **i32),
                                torch.zeros(1, 8, **i32))
    kv = torch.zeros(1, 10, 4, 64)
    pos = torch.zeros(1, 8, **i32)
    kpos = torch.zeros(1, 10, **i32)
    fp_ops.check_flash_args(q, kv, kv, pos, kpos, pos, kpos)
    with pytest.raises(ValueError):                 # kv_seg shape
        fp_ops.check_flash_args(q, kv, kv, pos, kpos, pos, pos)


@pytest.mark.parametrize("sm_count", [132, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("B,K,nbt", [
    (8, 32, 68),        # the mixed serve's decode step (one DP unit)
    (1, 32, 68), (4, 8, 68), (1, 1, 68), (16, 32, 2048), (2, 4, 7),
    (3, 5, 1), (64, 32, 68), (1, 8, 1025),
])
def test_decode_splits_fill_the_grid_without_empty_splits(B, K, nbt,
                                                          sm_count):
    """Every split owns at least one table entry and the splits cover the
    table; the (kv head, row, split) grid reaches two waves of the card's
    SMs unless the splits are already at their minimum length."""
    n = dec_ops.decode_splits(B, K, nbt, sm_count)
    per = -(-nbt // n)
    assert 1 <= n <= nbt
    assert (n - 1) * per < nbt <= n * per          # no split of zero pages
    assert B * K * n >= 2 * sm_count or per <= dec_ops.MIN_SPLIT_BLOCKS
    if per > dec_ops.MIN_SPLIT_BLOCKS:             # not cut finer than needed
        target = dec_ops.SPLIT_CTAS_PER_SM * sm_count
        assert B * K * n >= target * per // (per + 1)


def test_decode_splits_are_the_same_for_every_pos():
    """The split count is a function of shapes and the card only: it
    takes B, K, nbt and the SM count, never `pos` (reading it would sync
    the host once per layer), so rows at any position get the same
    plan."""
    import inspect
    assert list(inspect.signature(dec_ops.decode_splits).parameters) == [
        "B", "K", "nbt", "sm_count"]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("B,K,S", [(4, 32, 1088), (4, 8, 1088), (2, 4, 512),
                                   (1, 32, 4096), (8, 32, 16), (4, 32, 1),
                                   (4, 32, 520), (1, 1, 4096)])
def test_dense_splits_cover_the_cache_without_empty_splits(B, K, S,
                                                           sm_count):
    """The dense kernel's splits are whole 16-index units: each owns at
    least one, together they cover the cache, and their count is
    `decode_splits` over ceil(S / 16) units."""
    n = dec_ops.dense_splits(B, K, S, sm_count)
    units = -(-S // dec_ops.DENSE_SPLIT_UNIT)
    per = -(-units // n)
    assert 1 <= n <= units
    assert (n - 1) * per < units <= n * per        # no split of zero units
    assert n == dec_ops.decode_splits(B, K, units, sm_count)
    if (B, K, S, sm_count) == (4, 32, 1088, 132):   # the P/D serve's shape
        assert (n, per * dec_ops.DENSE_SPLIT_UNIT) == (9, 128)


def test_dense_splits_are_the_same_for_every_pos():
    """The dense split count takes B, K, S and the SM count, never
    `pos`: every row of a step gets the same plan, with no host sync."""
    import inspect
    assert list(inspect.signature(dec_ops.dense_splits).parameters) == [
        "B", "K", "S", "sm_count"]


def _split_merge_emulation(q, kc, vc, kv_pos, pos, window, n_split):
    """The dense kernel's walk in torch: row b walks cache indices
    0 .. min(S, pos + 1) - 1, cut into n_split ranges of whole 16-index
    units; each range keeps an fp32 (max, sum, acc) of its valid keys
    and the ranges merge by log-sum-exp, as the kernels' merge does."""
    B, H, hd = q.shape
    S, K = kc.shape[1], kc.shape[2]
    G = H // K
    per = -(-(-(-S // 16)) // n_split) * 16
    out = torch.zeros(B, H, hd)
    for b in range(B):
        p = int(pos[b])
        n = min(S, p + 1) if p >= 0 else 0
        parts = []
        for s in range(n_split):
            idx = torch.arange(s * per, max(s * per, min(n, (s + 1) * per)))
            kp = kv_pos[b, idx]
            ok = (kp >= 0) & (kp <= p)
            if window > 0:
                ok &= (p - kp) < window
            idx = idx[ok]
            if not len(idx):
                continue
            k = kc[b, idx].repeat_interleave(G, dim=1)     # (n, H, hd)
            v = vc[b, idx].repeat_interleave(G, dim=1)
            sc = torch.einsum("hd,nhd->hn", q[b], k) * hd ** -0.5
            m = sc.max(-1).values
            e = torch.exp(sc - m[:, None])
            parts.append((m, e.sum(-1), torch.einsum("hn,nhd->hd", e, v)))
        if parts:
            mx = torch.stack([m for m, _l, _a in parts]).max(0).values
            lsum = sum(l * torch.exp(m - mx) for m, l, _a in parts)
            acc = sum(a * torch.exp(m - mx)[:, None] for m, _l, a in parts)
            out[b] = acc / lsum[:, None]
    return out


@pytest.mark.parametrize("S,window,pos", [
    (200, 0, [199, 57, 0, 130, 9]),          # rows ending mid-split
    (200, 48, [199, 57, 0, 130, 9]),         # a window across splits
    (64, 64, [300, 63, 64, 1000, 9]),        # wrapped rings cut by splits
])
@pytest.mark.parametrize("n_split", [1, 3, 13])
def test_dense_split_walk_matches_plain(S, window, pos, n_split):
    """Cutting the walk into splits and merging them is the plain
    version's softmax for any split count, rings and windows included;
    a row with no valid key (row 4) gives exactly 0."""
    g = torch.Generator().manual_seed(S + window + n_split)
    B, H, K, hd = len(pos), 8, 4, 16
    q = torch.randn(B, H, hd, generator=g)
    kc = torch.randn(B, S, K, hd, generator=g)
    vc = torch.randn(B, S, K, hd, generator=g)
    kv_pos = torch.full((B, S), -1, dtype=torch.int32)
    idx = torch.arange(S, dtype=torch.int32)
    for b, p in enumerate(pos[:4]):
        if p < S:
            kv_pos[b] = torch.where(idx <= p, idx,
                                    torch.where(idx % 3 == 0, idx, -1))
        else:
            t = torch.arange(p - S + 1, p + 1, dtype=torch.int32)
            kv_pos[b, t % S] = t
    posn = torch.tensor(pos, dtype=torch.int32)
    n_split = min(n_split, -(-S // 16))
    got = _split_merge_emulation(q, kc, vc, kv_pos, posn, window, n_split)
    ref = dec_ops.decode_attention_plain(q, kc, vc, kv_pos, posn, window)
    assert torch.allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert float(got[4].abs().max()) == 0.0


def _dense_args(hd=64, H=4, K=4, pos_dtype=torch.int32):
    q = torch.zeros(2, H, hd)
    cache = torch.zeros(2, 24, K, hd)
    return (q, cache, cache.clone(), torch.zeros(2, 24, dtype=pos_dtype),
            torch.zeros(2, dtype=torch.int32))


def test_dense_check_args_accepts_supported():
    dec_ops.check_dense_args(*_dense_args())
    dec_ops.check_dense_args(*_dense_args(hd=128, H=32, K=4))


@pytest.mark.parametrize("bad", [
    dict(hd=16), dict(H=16, K=1), dict(H=6, K=4),
    dict(pos_dtype=torch.int64)])
def test_dense_check_args_rejects_unsupported(bad):
    with pytest.raises(ValueError):
        dec_ops.check_dense_args(*_dense_args(**bad))


def test_dense_check_args_rejects_layouts():
    """Batch mismatch and a non-contiguous cache are refused."""
    q, k, v, kv_pos, pos = _dense_args()
    with pytest.raises(ValueError):
        dec_ops.check_dense_args(q[:1], k, v, kv_pos, pos)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        dec_ops.check_dense_args(q, kt, kt, kv_pos, pos)


def test_wrappers_refuse_devices_without_a_kernel(monkeypatch):
    """Only CPU tensors and `meta` tensors (the dry-run's shapes) take
    the plain version; any other non-CUDA device raises instead of
    silently computing somewhere else.  `meta` stands for such a device
    once it is taken out of `PLAIN_DEVICES`."""
    for wrapper, make in ((paged_decode_attention, _decode_args),
                          (decode_attention, _dense_args)):
        args = [a.to("meta") for a in make()]
        before = wrapper.launches
        out = wrapper(*args)                     # the plain version
        assert out.device.type == "meta" and out.shape == args[0].shape
        assert wrapper.launches == before
    monkeypatch.setattr(dec_ops, "PLAIN_DEVICES", ("cpu",))
    args = [a.to("meta") for a in _decode_args()]
    before = paged_decode_attention.launches
    with pytest.raises(ValueError):
        paged_decode_attention(*args)
    assert paged_decode_attention.launches == before
    args = [a.to("meta") for a in _dense_args()]
    before = decode_attention.launches
    with pytest.raises(ValueError):
        decode_attention(*args)
    assert decode_attention.launches == before


@pytest.mark.parametrize("what", ["x", "Bm", "stride"])
def test_ssd_check_args_refuses_unaligned(what):
    """Kernel #4 stages x, B and C with 16-byte loads: a tensor that does
    not start on 16 bytes, or B/C tokens that do not lie a multiple of
    16 bytes apart, are refused before any launch."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    Q, nh, hp, ds = 32, 4, 32, 16
    x = torch.zeros(1, 1, Q, nh, hp)
    dt = torch.zeros(1, 1, Q, nh)
    A = -torch.ones(nh)
    bc = torch.zeros(1, 1, Q, 2 * ds)
    ssd_ops.check_args(x, dt, A, bc[..., :ds], bc[..., ds:])   # aligned
    if what == "x":
        x = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    elif what == "Bm":
        bc = torch.zeros(bc.numel() + 1)[1:].view(bc.shape)
    else:                       # tokens 2 * ds + 1 floats apart
        bc = torch.zeros(1, 1, Q, 2 * ds + 1)[..., :2 * ds]
    with pytest.raises(ValueError):
        ssd_ops.check_args(x, dt, A, bc[..., :ds], bc[..., ds:2 * ds])
