"""Kernel #2's bf16 body on the CPU: its plan and its split walk.

The body takes (rows a CTA, splits) from `flash_splits`, which reads the
shapes and the card's figures (`FlashConfig`: the tile's keys, the CTAs
an SM holds at each row count, the SM count; on the card the binding
reads them from the compiled kernels), so a step graph replays the same
plan and the host never reads a position.  Only calls that are not
causal split.  With splits, each CTA walks one range of 64-key tiles and
writes fp32 (m, l, O) partials that the shared decode merge combines;
`_split_walk` is that walk in plain torch ops, held here against
`flash_prefill_plain` (fp32, 1e-6) and the JAX package's Pallas kernel
in interpret mode (1e-5).  The kernel itself runs only on the card
(`tests/test_torch_cuda.py`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_prefill.ops import flash_prefill as pallas_flash
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ops import (
    FlashConfig, flash_prefill_plain, flash_splits,
)
from repro_torch.models.attention import build_mask

_KEYS = 64                  # keys a K/V tile of the bf16 body


def _config(hd, sm_count=132):
    """An H100's figures as the binding reads them
    (`test_flash_config_reads_the_compiled_bodies` on the card): two
    64-row CTAs an SM at head dim 64, one of every other body."""
    rows = {192: 1, 128: 1, 64: 2} if hd == 64 else {128: 1, 64: 1}
    return FlashConfig(_KEYS, rows, sm_count)


def _split_ranges(n_keys, n_split):
    """The key ranges [lo, hi) of the kernel's splits (`launch_bf16`):
    ceil(n_tiles / n_split) 64-key tiles each, cut at n_keys (empty past
    it)."""
    n_tiles = max(1, -(-n_keys // _KEYS))
    per = -(-n_tiles // n_split)
    return [(min(n_keys, s * per * _KEYS), min(n_keys, (s + 1) * per * _KEYS))
            for s in range(n_split)]


def _split_walk(q, k, v, mask, n_split):
    """The bf16 body's split walk in plain torch ops: each split's keys
    give fp32 (m, l, acc) partials per (row, query, head) under `mask`
    (B, Sq, Skv), a split with no valid key l = 0; the partials are merged
    by log-sum-exp as `launch_decode_merge` merges them, a row whose
    splits all have l = 0 giving exactly 0.  q (B, Sq, H, hd), k/v (B,
    Skv, K, hd) -> (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    ms, ls, accs = [], [], []
    for lo, hi in _split_ranges(Skv, n_split):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk[:, lo:hi])
        s = s * hd ** -0.5
        ok = mask[:, None, :, lo:hi]
        s = torch.where(ok, s, -torch.inf)
        m = s.amax(-1) if hi > lo else torch.full(s.shape[:3], -torch.inf)
        e = torch.where(ok, torch.exp(s - torch.where(
            torch.isinf(m), 0.0, m)[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", e, vv[:, lo:hi]))
    m = torch.stack(ms)                           # (n_split, B, H, Sq)
    lsum = torch.stack(ls)
    live = lsum > 0
    mx = torch.where(live, m, -torch.inf).amax(0)
    w = torch.where(live, torch.exp(m - torch.where(
        torch.isinf(mx), 0.0, mx)), 0.0)
    l_tot = (lsum * w).sum(0)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    out = torch.where(l_tot[..., None] > 0,
                      acc / l_tot.clamp_min(1e-30)[..., None], 0.0)
    return out.permute(0, 2, 1, 3)


# (B, Sq, H, K, n_keys, hd): whisper-large-v3's encoder, its decode step
# and chunk, a prompt's cross-attention; the serves' paged and
# contiguous chunks (hd 128, 120 at G = 4, the MoE serve's hd 64 at
# G = 2); internvl2-1b's G = 7; training; tiny and huge key counts
_SHAPES = [
    (4, 1500, 20, 20, 1500, 64), (4, 1, 20, 20, 1500, 64),
    (4, 16, 20, 20, 1500, 64), (4, 77, 20, 20, 1500, 64),
    (1, 240, 32, 32, 68 * 16, 128), (1, 256, 32, 32, 1088, 128),
    (1, 256, 32, 8, 1088, 120), (1, 240, 16, 8, 68 * 16, 64),
    (3, 456, 14, 2, 456, 64), (2, 512, 36, 36, 512, 64),
    (1, 1, 2, 1, 1, 64), (1, 3, 4, 4, 63, 128), (2, 1, 8, 8, 1 << 21, 64),
]


@pytest.mark.parametrize("shape", _SHAPES, ids=str)
@pytest.mark.parametrize("sm_count", [132, 114, 16])
def test_flash_splits_cover_every_tile_without_empty_splits(shape, sm_count):
    """Rows are one of the card's bodies (192 at head dim 64 only, 128 or
    64); the splits' ranges are contiguous, cover every key exactly once,
    are cut on 64-key tiles and none is empty; a causal call takes the
    same rows and never splits."""
    B, Sq, H, K, n_keys, hd = shape
    cfg = _config(hd, sm_count)
    for causal in (False, True):
        rows, n_split = flash_splits(B, Sq, H, K, n_keys, causal, cfg)
        assert rows in cfg.ctas_per_sm
        n_tiles = -(-n_keys // _KEYS)
        assert 1 <= n_split <= n_tiles
        if causal:
            assert (rows, n_split) == (
                flash_splits(B, Sq, H, K, n_keys, False, cfg)[0], 1)
        ranges = _split_ranges(n_keys, n_split)
        assert len(ranges) == n_split
        assert ranges[0][0] == 0 and ranges[-1][1] == n_keys
        for (lo, hi), (lo2, _hi2) in zip(ranges, ranges[1:]):
            assert hi == lo2
        for lo, hi in ranges:
            assert lo < hi and lo % _KEYS == 0


def test_flash_splits_at_the_main_path_shapes():
    """On 132 SMs, the plans `scripts/flash_prefill_plans.py` timed as
    fastest: the encoder takes 192-row CTAs unsplit (640 CTAs); whisper's
    decode step and chunk (80 CTAs of 64 rows) split their 1500 keys
    three ways; 77 queries take 128 rows; the serves' causal chunks (the
    paged and contiguous ones, hd 120, the MoE serve's paged chunk,
    granite's TP dense chunk at a rank's 8 heads over 4) take 64-row CTAs
    unsplit; internvl2-1b's G = 7 prefill 192 rows (126 CTAs, one wave)
    and a 2048-token prefill at hd 128 128 rows."""
    h64, h128 = _config(64), _config(128)
    assert flash_splits(4, 1500, 20, 20, 1500, False, h64) == (192, 1)
    assert flash_splits(4, 1, 20, 20, 1500, False, h64) == (64, 3)
    assert flash_splits(4, 16, 20, 20, 1500, False, h64) == (64, 3)
    assert flash_splits(4, 77, 20, 20, 1500, False, h64) == (128, 1)
    assert flash_splits(1, 240, 32, 32, 1088, True, h128) == (64, 1)
    assert flash_splits(1, 256, 32, 32, 1088, True, h128) == (64, 1)
    assert flash_splits(1, 256, 32, 8, 1088, True, _config(120)) == (64, 1)
    assert flash_splits(1, 240, 16, 8, 1088, True, h64) == (64, 1)
    assert flash_splits(1, 256, 8, 4, 1088, True, h64) == (64, 1)
    assert flash_splits(3, 456, 14, 2, 456, True, h64) == (192, 1)
    assert flash_splits(1, 2048, 32, 32, 2048, True, h128) == (128, 1)


def test_flash_plan_is_the_same_whatever_the_positions():
    """The wrappers' plan reads q's shape and dtype and the card's
    figures only: inputs that differ in every value (positions, segments,
    q itself) get the same plan, so a captured step replays it for any
    data; the fp32 body is planned by the same rule from the figures it
    is given."""
    cfg = _config(64)
    for dtype in (torch.bfloat16, torch.float32):
        plans = set()
        for seed in range(4):
            g = torch.Generator().manual_seed(seed)
            q = torch.randn(4, 16, 20, 64, generator=g).to(dtype)
            plans.add(fp_ops.flash_plan(q, 1500, 20, False, False, cfg))
        assert plans == {(64, 3)}


@pytest.mark.parametrize("paged", [False, True])
def test_wrappers_record_no_plan_for_the_plain_version(paged):
    """On CPU tensors the wrappers run the plain version and launch
    nothing: no launch is counted and `last_plan` is None."""
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    if paged:
        q = torch.randn(1, 4, 2, 64)
        pool = torch.randn(3, 16, 2, 64)
        kvp = torch.arange(48, dtype=torch.int32).reshape(3, 16)
        tab = torch.tensor([[0, 1]], dtype=torch.int32)
        pos = torch.arange(4, dtype=torch.int32)[None] + 20
        wrapper, before = paged_prefill_attention, \
            paged_prefill_attention.launches
        out = paged_prefill_attention(q, pool, pool, kvp, tab, pos)
    else:
        q, k, v, qp, kp, qs, ks = _case(1, 4, 70, 2, 2, 64, 0, True)
        wrapper, before = flash_prefill, flash_prefill.launches
        out = flash_prefill(q, k, v, qp, kp, qs, ks)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert wrapper.launches == before and wrapper.last_plan is None


def _case(B, Sq, Skv, H, K, hd, seed, causal, window=0, pad_rows=(),
          dead_keys=None, segs=None):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Skv, K, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Skv, K, hd), np.float32))
    if causal:
        q_pos = torch.arange(Skv - Sq, Skv, dtype=torch.int32).repeat(B, 1)
    else:
        q_pos = torch.zeros(B, Sq, dtype=torch.int32)
    kv_pos = torch.arange(Skv, dtype=torch.int32).repeat(B, 1)
    q_seg = torch.zeros(B, Sq, dtype=torch.int32)
    kv_seg = torch.zeros(B, Skv, dtype=torch.int32)
    if segs is not None:
        q_seg[:] = torch.tensor(segs[0], dtype=torch.int32)
        kv_seg[:] = torch.tensor(segs[1], dtype=torch.int32)
    for b in pad_rows:
        q_seg[b] = -1
    if dead_keys is not None:
        kv_pos[:, dead_keys] = -1
    return q, k, v, q_pos, kv_pos, q_seg, kv_seg


_WALKS = {
    # whisper's cross-attention: 1 and 16 queries over 1500 keys
    "cross Sq=1": dict(B=2, Sq=1, Skv=1500, H=4, K=4, hd=64, causal=False),
    "cross Sq=16": dict(B=2, Sq=16, Skv=1500, H=4, K=4, hd=64,
                        causal=False),
    # causal chunk at the end of a cache, G = 4, a window across splits
    "causal G=4": dict(B=1, Sq=40, Skv=300, H=8, K=2, hd=32, causal=True),
    "window": dict(B=1, Sq=40, Skv=300, H=4, K=4, hd=32, causal=True,
                   window=70),
    # every key of the first 192 (splits 0-2 at n_split >= 5) dead, and
    # a query row of all pad (exactly 0)
    "dead splits": dict(B=2, Sq=8, Skv=330, H=2, K=1, hd=32, causal=False,
                        pad_rows=(1,), dead_keys=slice(0, 192)),
    # packed segments whose boundaries fall inside tiles and splits
    "segments": dict(B=1, Sq=6, Skv=260, H=2, K=2, hd=16, causal=False,
                     segs=([0, 0, 1, 1, 2, -1],
                           [0] * 70 + [1] * 100 + [2] * 60 + [-1] * 30)),
}


@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
@pytest.mark.parametrize("name", list(_WALKS))
def test_split_walk_matches_plain(name, n_split):
    """Cutting each row's keys into the kernel's split ranges and merging
    the fp32 partials is the plain version's softmax for any split count;
    a split whose keys are all masked adds nothing, and a row with no
    valid key anywhere comes out exactly 0, never NaN."""
    case = _WALKS[name]
    window = case.get("window", 0)
    q, k, v, qp, kp, qs, ks = _case(**case, seed=n_split)
    n_split = min(n_split, -(-k.shape[1] // _KEYS))
    mask = build_mask(qp, kp, qs, ks, case["causal"], window)
    got = _split_walk(q, k, v, mask, n_split)
    ref = flash_prefill_plain(q, k, v, qp, kp, qs, ks, case["causal"],
                              window)
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, ref, atol=1e-6, rtol=1e-6)
    for b in case.get("pad_rows", ()):
        assert float(got[b].abs().max()) == 0.0


@pytest.mark.parametrize("n_split", [1, 4])
def test_split_walk_matches_the_pallas_kernel(n_split):
    """The same inputs through the JAX package's Pallas kernel (interpret
    mode): packed segments with padding, not causal and causal."""
    seg = [0] * 100 + [1] * 120 + [-1] * 36
    for causal in (False, True):
        q, k, v, qp, kp, qs, ks = _case(2, 256, 256, 4, 2, 32, 7 + n_split,
                                        causal, segs=(seg, seg))
        qp = kp.clone()
        mask = build_mask(qp, kp, qs, ks, causal)
        got = _split_walk(q, k, v, mask, n_split)
        j = [jnp.asarray(t.numpy()) for t in (q, k, v, qp, kp, qs, ks)]
        ref = np.asarray(pallas_flash(*j, causal=causal, block_q=64,
                                      block_kv=64, interpret=True))
        assert np.abs(got.numpy() - ref).max() < 1e-5
        assert float(got[:, 220:].abs().max()) == 0.0


def _flash_args(hd=64, H=4, K=4, Sq=8, Skv=16, dtype=torch.bfloat16,
                pos_dtype=torch.int32):
    q = torch.zeros(2, Sq, H, hd, dtype=dtype)
    kv = torch.zeros(2, Skv, K, hd, dtype=dtype)
    pos = torch.zeros(2, Sq, dtype=pos_dtype)
    kpos = torch.zeros(2, Skv, dtype=pos_dtype)
    return q, kv, kv.clone(), pos, kpos, pos.clone(), kpos.clone()


def test_check_flash_args_accepts_what_the_kernel_takes():
    for hd in fp_ops.HEAD_DIMS:
        fp_ops.check_flash_args(*_flash_args(hd=hd))
    fp_ops.check_flash_args(*_flash_args(H=14, K=2))        # G = 7
    fp_ops.check_flash_args(*_flash_args(dtype=torch.float32))


@pytest.mark.parametrize("bad", [
    dict(hd=96), dict(hd=16), dict(H=6, K=4), dict(pos_dtype=torch.int64),
    dict(dtype=torch.float16)], ids=str)
def test_check_flash_args_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        fp_ops.check_flash_args(*_flash_args(**bad))


def test_check_flash_args_refuses_layouts_and_key_counts(monkeypatch):
    """Non-contiguous K, a batch mismatch, a misaligned q, and more keys
    than the bf16 body walks are refused before any launch."""
    q, k, v, qp, kp, qs, ks = _flash_args()
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fp_ops.check_flash_args(q, kt, kt, qp, kp, qs, ks)
    with pytest.raises(ValueError):
        fp_ops.check_flash_args(q[:1], k, v, qp[:1], kp, qs[:1], ks)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype)
    q_off = flat[1:].view(q.shape)                 # 2 bytes off 16
    with pytest.raises(ValueError):
        fp_ops.check_flash_args(q_off, k, v, qp, kp, qs, ks)
    monkeypatch.setattr(fp_ops, "MAX_BF16_KEYS", 8)
    with pytest.raises(ValueError):
        fp_ops.check_flash_args(q, k, v, qp, kp, qs, ks)
    fp_ops.check_flash_args(*_flash_args(dtype=torch.float32))
