"""PyTorch port on the card: the CUDA kernels against their plain
versions at small shapes (the SSD kernel also at every SSM shape of the
configs, full width included), and the unified and P/D servers on CUDA
against the same servers on the CPU (reduced mamba2-370m: against the
CPU model replaying the serve's prefill chunk boundaries).  Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one; on the card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where JAX is not installed.
Tolerances, against the plain version computed in fp32 on the same
inputs: max|d| of 1e-4 (fp32 kernels: online softmax vs the plain
version's materialised softmax) or 2e-2 (bf16 kernels), and per head
vector max|d| / max|ref| of 1e-4 (fp32) or 1e-2 (bf16: the output's own
rounding is under 4e-3 of a vector's largest element).
"""
import random

import pytest
import torch

from repro_torch.config.base import ServingConfig, get_arch
from repro_torch.core.types import Request
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill, flash_prefill_plain, paged_prefill_attention,
    paged_prefill_attention_plain,
)
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
from repro_torch.models.model import (
    decode_step, init_cache, init_params, prefill_chunk,
)
from repro_torch.serving.server import RealSBSServer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_close(out, ref, dtype):
    """Absolute limit, and max|d| / max|ref| over each head vector; a
    vector whose reference is all zero must come out exactly zero."""
    d = (out.float() - ref).abs()
    assert float(d.max()) <= TOL[dtype]
    worst = d.amax(-1)
    scale = ref.abs().amax(-1)
    assert bool((worst <= REL_TOL[dtype] * scale).all())


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def _to(tree, device):
    """A params tree (dicts and lists of tensors) on `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _rand(g, shape, dtype, dev):
    return (torch.randn(shape, generator=g) * 0.5).to(dtype).to(dev)


def _paged_case(g, B, N, bs, nbt, K, hd, dtype, dev, lens):
    """Pools + tables where row b holds `lens[b]` tokens (0 = all -1)."""
    kp = _rand(g, (N, bs, K, hd), dtype, dev)
    vp = _rand(g, (N, bs, K, hd), dtype, dev)
    kvp = torch.randint(0, 64, (N, bs), generator=g, dtype=torch.int32)
    tab = torch.full((B, nbt), -1, dtype=torch.int32)
    free = (torch.randperm(N - 1, generator=g) + 1).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // bs)):
            phys = free.pop()
            tab[b, j] = phys
            r = torch.arange(bs, dtype=torch.int32) + j * bs
            kvp[phys] = torch.where(r < n, r, -1)
    return kp, vp, kvp.to(dev), tab.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (8, 2, 128), (32, 8, 128)])
def test_paged_decode_kernel_matches_plain(dev, dtype, H, K, hd):
    g = torch.Generator().manual_seed(H * K + hd)
    lens = [37, 16, 0, 1, 64]
    kp, vp, kvp, tab = _paged_case(g, 5, 30, 16, 4, K, hd, dtype, dev, lens)
    pos = torch.tensor([n - 1 if n else 5 for n in lens], dtype=torch.int32,
                       device=dev)
    q = _rand(g, (5, H, hd), dtype, dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, kvp, tab, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       kvp, tab, pos)
    _assert_close(out, ref, dtype)
    assert float(out[2].abs().max()) == 0.0          # all -1 table -> 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (32, 8, 128)])
def test_paged_prefill_kernel_matches_plain(dev, dtype, H, K, hd):
    g = torch.Generator().manual_seed(H + K + hd)
    # two rows, chunks starting mid-page; context written up to the chunk
    rows = [(21, 40), (5, 19)]
    lens = [p0 + sc for p0, sc in rows]
    kp, vp, kvp, tab = _paged_case(g, 2, 40, 16, 6, K, hd, dtype, dev, lens)
    Sc = max(sc for _p, sc in rows)
    positions = torch.stack([
        (p0 + torch.arange(Sc)).clamp(max=p0 + sc - 1) for p0, sc in rows
    ]).to(torch.int32).to(dev)
    q = _rand(g, (2, Sc, H, hd), dtype, dev)
    out = paged_prefill_attention(q, kp, vp, kvp, tab, positions)
    ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                        kvp, tab, positions)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_prefill_kernel_matches_plain(dev, dtype, causal, window):
    g = torch.Generator().manual_seed(3)
    B, S, H, K, hd = 2, 96, 8, 2, 64
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k = _rand(g, (B, S, K, hd), dtype, dev)
    v = _rand(g, (B, S, K, hd), dtype, dev)
    pos = torch.cat([torch.arange(40), torch.arange(45), torch.zeros(11,
                     dtype=torch.int64)]).to(torch.int32).repeat(B, 1).to(dev)
    seg = torch.cat([torch.zeros(40), torch.ones(45), -torch.ones(11)]
                    ).to(torch.int32).repeat(B, 1).to(dev)
    out = flash_prefill(q, k, v, pos, pos, seg, seg, causal, window)
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos, seg,
                              seg, causal, window)
    _assert_close(out, ref, dtype)
    assert float(out[:, 85:].abs().max()) == 0.0     # padding rows


# ---------------------------------------------------------------------------
# kernel #2 (tensor cores in bf16, FMA in fp32) at its design's edges:
# ragged chunks, K/V tiles skipped from the data, fully masked rows
# ---------------------------------------------------------------------------

def _extend_case(g, Sq, p0, S, K, hd, dtype, dev, H):
    """`attn_extend`'s call, two rows: q at positions p0..p0+Sq-1 over a
    dense cache of S entries written up to the chunk's end (position t
    at index t % S, so a ring once p0 + Sq > S; the tail of a longer
    cache empty).  Row 1's cache is all empty: every K/V tile of its
    query tiles is skipped and its output must be exactly 0."""
    qp = (p0 + torch.arange(Sq, dtype=torch.int32)).repeat(2, 1)
    kvp = torch.full((2, S), -1, dtype=torch.int32)
    last = p0 + Sq - 1
    t = torch.arange(max(0, last + 1 - S), last + 1, dtype=torch.int32)
    kvp[0, t % S] = t
    q = _rand(g, (2, Sq, H, hd), dtype, dev)
    k = _rand(g, (2, S, K, hd), dtype, dev)
    v = _rand(g, (2, S, K, hd), dtype, dev)
    zq = torch.zeros(2, Sq, dtype=torch.int32, device=dev)
    zk = torch.zeros(2, S, dtype=torch.int32, device=dev)
    return q, k, v, qp.to(dev), kvp.to(dev), zq, zk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)], ids=["G1", "G4"])
@pytest.mark.parametrize("Sq,p0,S,window", [
    (117, 40, 320, 0),        # ragged chunk, empty cache tail (5 tiles)
    (199, 0, 264, 0),         # first chunk of a prompt, ragged cache end
    (240, 512, 1088, 0),      # attn_extend's shape, 5 of 17 tiles empty
    (117, 500, 128, 96),      # wrapped sliding-window ring, window < S
    (240, 900, 256, 256),     # wrapped ring, window = S
], ids=["ragged117", "ragged199", "extend240", "ring117", "ring240"])
def test_flash_prefill_kernel_edges(dev, dtype, hd, H, K, Sq, p0, S, window):
    g = torch.Generator().manual_seed(Sq + p0 + S + hd + K)
    q, k, v, qp, kvp, qs, ks = _extend_case(g, Sq, p0, S, K, hd, dtype, dev,
                                            H)
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, qp, kvp, qs, ks, True, window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp, kvp, qs,
                              ks, True, window)
    _assert_close(out, ref, dtype)
    assert float(out[1].abs().max()) == 0.0          # all-empty cache -> 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(8, 8, 64), (8, 2, 128)])
def test_flash_prefill_kernel_pad_tiles(dev, dtype, H, K, hd):
    """Packed segments whose padding fills whole query tiles (no valid
    query row: every K/V tile skipped), and a row of padding only; pad
    rows come out exactly 0."""
    g = torch.Generator().manual_seed(11 + hd)
    B, S = 2, 320
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k = _rand(g, (B, S, K, hd), dtype, dev)
    v = _rand(g, (B, S, K, hd), dtype, dev)
    pos = torch.cat([torch.arange(70), torch.arange(47),
                     torch.zeros(S - 117, dtype=torch.int64)])
    seg = torch.cat([torch.zeros(70), torch.ones(47), -torch.ones(S - 117)])
    pos = torch.stack([pos, torch.zeros(S, dtype=torch.int64)])
    seg = torch.stack([seg, -torch.ones(S)])
    pos = pos.to(torch.int32).to(dev)
    seg = seg.to(torch.int32).to(dev)
    out = flash_prefill(q, k, v, pos, pos, seg, seg)
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos, seg,
                              seg)
    _assert_close(out, ref, dtype)
    assert float(out[seg < 0].abs().max()) == 0.0


def _packed_segments(lens, starts, S):
    """Packed-varlen positions and segment ids: segment i holds positions
    starts[i] .. starts[i] + lens[i] - 1; the rest of the S rows is pad."""
    pos = torch.zeros(S, dtype=torch.int32)
    seg = torch.full((S,), -1, dtype=torch.int32)
    at = 0
    for i, (n, p0) in enumerate(zip(lens, starts)):
        pos[at:at + n] = p0 + torch.arange(n, dtype=torch.int32)
        seg[at:at + n] = i
        at += n
    return pos, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(8, 8, 64), (8, 2, 128)])
@pytest.mark.parametrize("lens,starts", [
    ([1] * 160, [0] * 160),                    # one-token segments at 0
    # four chunks from position 0 fill the first key tile; later warps
    # span chunks that start past it
    ([16, 16, 16, 16, 5, 37, 30, 22], [0, 0, 0, 0, 300, 100, 64, 7]),
    ([8] * 20, [50 + 3 * i for i in range(20)]),   # short chunks, offset
], ids=["one_token_at_0", "chunks_at_any_pos", "short_chunks_offset"])
def test_flash_prefill_kernel_mixed_segments(dev, dtype, H, K, hd, lens,
                                             starts):
    """Warps and key tiles that span several segments, every key of which
    passes the position masks: only the segment mask separates them, so
    a query must not attend across segments."""
    g = torch.Generator().manual_seed(len(lens) + hd)
    S = 192
    pos, seg = _packed_segments(lens, starts, S)
    pos, seg = pos.repeat(2, 1).to(dev), seg.repeat(2, 1).to(dev)
    q = _rand(g, (2, S, H, hd), dtype, dev)
    k = _rand(g, (2, S, K, hd), dtype, dev)
    v = _rand(g, (2, S, K, hd), dtype, dev)
    out = flash_prefill(q, k, v, pos, pos, seg, seg)
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos, seg,
                              seg)
    _assert_close(out, ref, dtype)
    assert float(out[seg < 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)], ids=["G1", "G4"])
@pytest.mark.parametrize("Sc,window", [(117, 0), (199, 0), (240, 0),
                                       (199, 64)])
def test_paged_prefill_kernel_edges(dev, dtype, hd, H, K, Sc, window):
    """Ragged chunks starting mid-page at a long position (rows 0-1, one
    shorter and padded with repeats of its last position), and a row
    whose table is all -1 (every tile skipped, output exactly 0)."""
    g = torch.Generator().manual_seed(Sc + hd + K + window)
    rows = [(789, Sc), (213, Sc - 40)]
    lens = [p0 + sc for p0, sc in rows] + [0]
    kp, vp, kvp, tab = _paged_case(g, 3, 160, 16, 68, K, hd, dtype, dev,
                                   lens)
    positions = torch.stack([
        (p0 + torch.arange(Sc)).clamp(max=p0 + sc - 1)
        for p0, sc in rows + [(300, Sc)]]).to(torch.int32).to(dev)
    q = _rand(g, (3, Sc, H, hd), dtype, dev)
    before = paged_prefill_attention.launches
    out = paged_prefill_attention(q, kp, vp, kvp, tab, positions, window)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                        kvp, tab, positions, window)
    _assert_close(out, ref, dtype)
    assert float(out[2].abs().max()) == 0.0          # all -1 table -> 0


# ---------------------------------------------------------------------------
# kernel #1 (split-K over pages) at its design's edges
# ---------------------------------------------------------------------------

_DECODE_LENS = [1, 16, 37, 68 * 16, 0, 700]   # 1 token, 1 page, mid-page,
#   the full 68-entry table, an all -1 row, a long row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (16, 4), (32, 4)],
                         ids=["G1", "G4", "G8"])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_decode_kernel_edges(dev, dtype, hd, H, K, window):
    g = torch.Generator().manual_seed(H * K + hd + window)
    B = len(_DECODE_LENS)
    kp, vp, kvp, tab = _paged_case(g, B, 160, 16, 68, K, hd, dtype, dev,
                                   _DECODE_LENS)
    pos = torch.tensor([n - 1 if n else 40 for n in _DECODE_LENS],
                       dtype=torch.int32, device=dev)
    q = _rand(g, (B, H, hd), dtype, dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, kvp, tab, pos, window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       kvp, tab, pos, window)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0          # all -1 table -> 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 3, 17, 68])
def test_paged_decode_kernel_any_split(dev, dtype, n_split):
    """The split and merge agree with the plain version for any split
    count the launcher takes (1 = no merge, 68 = one table entry each,
    most of them past short rows' live blocks)."""
    from repro_torch.kernels.build import load_kernels
    g = torch.Generator().manual_seed(n_split)
    B, H, K, hd = len(_DECODE_LENS), 16, 4, 128
    kp, vp, kvp, tab = _paged_case(g, B, 160, 16, 68, K, hd, dtype, dev,
                                   _DECODE_LENS)
    pos = torch.tensor([n - 1 if n else 40 for n in _DECODE_LENS],
                       dtype=torch.int32, device=dev)
    q = _rand(g, (B, H, hd), dtype, dev)
    out = load_kernels().paged_decode_attention(q, kp, vp, kvp, tab, pos, 0,
                                                hd ** -0.5, n_split)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       kvp, tab, pos)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0


def _dense_case(g, pos, S, K, hd, dtype, dev, empty=()):
    """Caches as the engines keep them: position t at index t % S (a
    ring once pos >= S), stale later positions past a short row's cursor,
    and `empty` rows with no valid key."""
    B = len(pos)
    kc = _rand(g, (B, S, K, hd), dtype, dev)
    vc = _rand(g, (B, S, K, hd), dtype, dev)
    kvp = torch.full((B, S), -1, dtype=torch.int32)
    idx = torch.arange(S, dtype=torch.int32)
    for b, p in enumerate(pos):
        if b in empty:
            continue
        if p < S:
            kvp[b] = torch.where(idx <= p, idx, torch.where(idx % 3 == 0,
                                                            idx, -1))
        else:
            t = torch.arange(p - S + 1, p + 1, dtype=torch.int32)
            kvp[b, t % S] = t
    return kc, vc, kvp.to(dev), torch.tensor(pos, dtype=torch.int32,
                                             device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (16, 4, 64), (8, 1, 128),
                                    (32, 8, 128), (12, 2, 128)])
@pytest.mark.parametrize("window,S,pos", [
    (0, 200, [199, 57, 0, 130]),             # padded rows, any S
    (48, 200, [199, 57, 0, 130]),            # window inside the rows
    (64, 64, [300, 63, 64, 1000]),           # wrapped rings, window = S
])
def test_dense_decode_kernel_matches_plain(dev, dtype, H, K, hd, window, S,
                                           pos):
    g = torch.Generator().manual_seed(H * K + hd + S)
    kc, vc, kvp, posn = _dense_case(g, pos + [9], S, K, hd, dtype, dev,
                                    empty=(4,))
    q = _rand(g, (5, H, hd), dtype, dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, kvp, posn, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                 posn, window)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0          # no valid key -> 0


# rows of the split-K design's edges; row 4 has no valid key (exactly 0)
_DENSE_SPLIT_CASES = {
    # S up to 4096, rows that end mid-split, a one-index split tail
    "long rows": (4096, 0, [4095, 2050, 127, 1000, 9]),
    # a window whose edge falls inside a split
    "window across splits": (1088, 100, [1087, 700, 300, 129, 9]),
    # wrapped rings (pos >= S) cut by the splits at arbitrary indices
    "wrapped ring": (520, 520, [1500, 777, 519, 2047, 9]),
    # one-token rows: every split but the first walks nothing
    "one-token rows": (1088, 0, [0, 0, 1, 16, 9]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (16, 4)], ids=["G1", "G4"])
@pytest.mark.parametrize("case", list(_DENSE_SPLIT_CASES))
def test_dense_decode_kernel_split_edges(dev, dtype, hd, H, K, case):
    S, window, pos = _DENSE_SPLIT_CASES[case]
    g = torch.Generator().manual_seed(S + window + hd + K)
    kc, vc, kvp, posn = _dense_case(g, pos, S, K, hd, dtype, dev, empty=(4,))
    q = _rand(g, (len(pos), H, hd), dtype, dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, kvp, posn, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1     # split + merge: one
    ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                 posn, window)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 2, 5, 9, 68])
def test_dense_decode_kernel_any_split(dev, dtype, n_split):
    """The split and merge agree with the plain version for any split
    count the launcher takes (1 = no merge, 68 = one 16-index unit each,
    most of them past short rows' walks)."""
    from repro_torch.kernels.build import load_kernels
    g = torch.Generator().manual_seed(n_split)
    pos = [1087, 700, 129, 0, 40]
    kc, vc, kvp, posn = _dense_case(g, pos, 1088, 4, 128, dtype, dev,
                                    empty=(4,))
    q = _rand(g, (len(pos), 16, 128), dtype, dev)
    out = load_kernels().decode_attention(q, kc, vc, kvp, posn, 0,
                                          128 ** -0.5, n_split)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                 posn)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0


def test_dense_decode_wrapper_rejects_unsupported_on_cuda(dev):
    """G > 8, a head dim without an instantiation and a non-contiguous
    cache raise before any launch."""
    i32 = dict(dtype=torch.int32, device=dev)
    before = decode_attention.launches
    for H, K, hd in ((16, 1, 64), (4, 4, 96)):
        q = torch.zeros(2, H, hd, device=dev)
        c = torch.zeros(2, 32, K, hd, device=dev)
        with pytest.raises(ValueError):
            decode_attention(q, c, c, torch.zeros(2, 32, **i32),
                             torch.zeros(2, **i32))
    q = torch.zeros(2, 4, 64, device=dev)
    c = torch.zeros(2, 4, 32, 64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        decode_attention(q, c, c, torch.zeros(2, 32, **i32),
                         torch.zeros(2, **i32))
    assert decode_attention.launches == before


def test_wrapper_rejects_unsupported_head_dim_on_cuda(dev):
    q = torch.zeros(1, 4, 32, device=dev)
    pool = torch.zeros(3, 16, 4, 32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, torch.zeros(3, 16, **i32),
                               torch.zeros(1, 2, **i32),
                               torch.zeros(1, **i32))


def test_unified_server_on_cuda_matches_cpu(dev):
    """Reduced deepseek-7b in fp32: the served tokens on the card (through
    both kernels) equal the same server's on the CPU (plain versions)."""
    cfg = get_arch("deepseek-7b", reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        max_batch_per_dp=4, block_size=16, mixed_batch=True, mixed_chunk=32)

    def requests():
        rng = random.Random(5)
        return [Request(rid=i, arrival_time=0.02 * i, input_len=L,
                        output_len=6,
                        tokens=tuple(rng.randrange(cfg.vocab_size)
                                     for _ in range(L)))
                for i, L in enumerate((17, 40, 33, 64))]

    cpu_params = init_params(cfg, seed=0, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        params = _to(cpu_params, device)
        launches = (paged_decode_attention.launches,
                    paged_prefill_attention.launches)
        srv = RealSBSServer(cfg, params, scfg,
                            scheduler="sbs-la", max_len=96, max_new=6,
                            device=device)
        gens = srv.serve(requests(), timeout=120)
        out[device] = {g.rid: g.tokens for g in gens}
        if device == "cuda":
            assert paged_decode_attention.launches > launches[0]
            assert paged_prefill_attention.launches > launches[1]
    assert len(out["cpu"]) == 4
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("block_size", [0, 16], ids=["padded", "paged"])
def test_pd_server_on_cuda_matches_cpu(dev, block_size):
    """Reduced deepseek-7b in fp32, P/D-separated: the served tokens on
    the card (prefill through the contiguous flash entry, padded decode
    through kernel #3 or paged decode through kernel #1) equal the same
    server's on the CPU (plain versions)."""
    cfg = get_arch("deepseek-7b", reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2, chunk_size=32,
        max_batch_per_dp=4, block_size=block_size)

    def requests():
        rng = random.Random(6)
        return [Request(rid=i, arrival_time=0.02 * i, input_len=L,
                        output_len=6,
                        tokens=tuple(rng.randrange(cfg.vocab_size)
                                     for _ in range(L)))
                for i, L in enumerate((17, 40, 33, 64))]

    cpu_params = init_params(cfg, seed=0, device="cpu")
    dec = paged_decode_attention if block_size else decode_attention
    out = {}
    for device in ("cpu", "cuda"):
        params = _to(cpu_params, device)
        launches = (dec.launches, flash_prefill.launches)
        srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la",
                            max_len=96, max_new=6, device=device)
        gens = srv.serve(requests(), timeout=120)
        out[device] = {g.rid: g.tokens for g in gens}
        if device == "cuda":
            assert dec.launches > launches[0]
            assert flash_prefill.launches > launches[1]
    assert len(out["cpu"]) == 4
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# kernel #4: the SSD intra-chunk term
# ---------------------------------------------------------------------------

def _ssd_case(g, B, nc, Q, nh, hp, ds, dtype, dev, pad=0):
    """Inputs as `ssd_chunked_kernel` passes them: B and C as strided
    slices of one [B|C] tensor; the last chunk's last `pad` tokens padded
    with zeros and dt = 0."""
    x = torch.randn(B, nc, Q, nh, hp, generator=g) * 0.3
    dt = torch.nn.functional.softplus(torch.randn(B, nc, Q, nh, generator=g))
    A = -torch.exp(torch.linspace(0.0, 1.0, nh))
    bc = torch.randn(B, nc, Q, 2 * ds, generator=g) * 0.3
    if pad:
        for t in (x, dt, bc):
            t[:, -1, Q - pad:] = 0
    bc = bc.to(dtype).to(dev)
    return (x.to(dtype).to(dev), dt.to(dev), A.to(dev), bc[..., :ds],
            bc[..., ds:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nc,Q,nh,hp,ds,pad", [
    (1, 1, 256, 32, 64, 128, 0),       # mamba2-370m, full width
    (2, 2, 256, 32, 64, 128, 57),      # B·nc > 1, a ragged last chunk
    (1, 1, 32, 16, 32, 32, 0),         # mamba2-370m, reduced
    (1, 1, 256, 128, 64, 16, 0),       # jamba-v0.1-52b, full width
    (3, 2, 32, 16, 32, 16, 5),         # jamba-v0.1-52b, reduced
])
def test_ssd_chunk_kernel_matches_plain(dev, dtype, B, nc, Q, nh, hp, ds,
                                        pad):
    g = torch.Generator().manual_seed(Q + nh + ds + pad)
    x, dt, A, Bm, Cm = _ssd_case(g, B, nc, Q, nh, hp, ds, dtype, dev, pad)
    before = ssd_chunk.launches
    y, st = ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    yr, sr = ssd_chunk_plain(x.float(), dt, A, Bm.float(), Cm.float())
    assert y.dtype == st.dtype == torch.float32
    assert st.shape == (B, nc, nh, hp, ds)
    # outputs are fp32 from fp32 arithmetic on either input type
    _assert_close(y, yr, torch.float32)
    _assert_close(st, sr, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hp,ds", [(hp, ds) for hp in (32, 64)
                                   for ds in (16, 32, 64, 128)])
@pytest.mark.parametrize("Q", [1, 63, 64, 65, 256])
def test_ssd_chunk_kernel_edges(dev, dtype, hp, ds, Q):
    """Every (hp, ds) instantiation at chunk lengths around the kernel's
    32-token tiles (one tile, a ragged pair, the full 8), an odd head
    count, B·nc = 4 and a padded ragged last chunk; outputs are fp32
    from fp32 arithmetic and held at the fp32 tolerance."""
    g = torch.Generator().manual_seed(hp + ds + Q)
    pad = Q // 3
    x, dt, A, Bm, Cm = _ssd_case(g, 2, 2, Q, 3, hp, ds, dtype, dev, pad)
    y, st = ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    yr, sr = ssd_chunk_plain(x.float(), dt, A, Bm.float(), Cm.float())
    _assert_close(y, yr, torch.float32)
    _assert_close(st, sr, torch.float32)


def test_ssd_chunk_kernel_is_bit_identical_at_the_served_shape(dev):
    """At the SSM serve's shape (one full-width mamba2-370m chunk, bf16
    inputs, B and C strided) the kernel sums in the plain version's
    order, so both agree bit for bit: the serve's logit check needs it
    (a 1e-7 relative change of this term moves the random 48-layer
    model's logits by 0.17 of the largest, PERF.md)."""
    g = torch.Generator().manual_seed(7)
    x, dt, A, Bm, Cm = _ssd_case(g, 1, 1, 256, 32, 64, 128, torch.bfloat16,
                                 dev)
    y, st = ssd_chunk(x, dt, A, Bm, Cm)
    yr, sr = ssd_chunk_plain(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert torch.equal(y, yr)
    assert torch.equal(st, sr)


def test_ssd_chunk_wrapper_rejects_unsupported_on_cuda(dev):
    g = torch.Generator().manual_seed(0)
    x, dt, A, Bm, Cm = _ssd_case(g, 1, 1, 32, 4, 48, 16, torch.float32, dev)
    before = ssd_chunk.launches
    with pytest.raises(ValueError):
        ssd_chunk(x, dt, A, Bm, Cm)                        # hp 48
    x, dt, A, Bm, Cm = _ssd_case(g, 1, 1, 32, 4, 32, 16, torch.float32, dev)
    with pytest.raises(ValueError):
        ssd_chunk(x, dt.to(torch.bfloat16), A, Bm, Cm)
    assert ssd_chunk.launches == before


def test_pd_ssm_server_on_cuda_matches_cpu_replay(dev):
    """Reduced mamba2-370m in fp32, P/D on the padded plane: the tokens
    served on the card (prefill through kernel #4) equal the CPU model's
    (plain versions) on the prefill chunk boundaries the serve used (the
    SSD scan chunks each prefill chunk from its start)."""
    cfg = get_arch("mamba2-370m", reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2, chunk_size=32,
        max_batch_per_dp=4, block_size=0)
    rng = random.Random(6)
    reqs = [Request(rid=i, arrival_time=0.02 * i, input_len=L, output_len=6,
                    tokens=tuple(rng.randrange(cfg.vocab_size)
                                 for _ in range(L)))
            for i, L in enumerate((17, 40, 33, 64))]
    cpu_params = init_params(cfg, seed=0, device="cpu")
    srv = RealSBSServer(cfg, _to(cpu_params, "cuda"), scfg,
                        scheduler="sbs-la", max_len=96, max_new=6,
                        device="cuda")
    chunks = {}
    for eng in srv.engines:
        inner = eng._run_chunk
        eng._run_chunk = (lambda req, tok, _f=inner: (
            chunks.setdefault(req.rid, []).append(tok), _f(req, tok))[1])
    before = ssd_chunk.launches
    gens = srv.serve(reqs, timeout=120)
    assert ssd_chunk.launches > before
    assert sorted(g.rid for g in gens) == [0, 1, 2, 3]
    for g, r in zip(gens, reqs):
        cache, at = init_cache(cfg, 1, 96, device="cpu"), 0
        for n in chunks[r.rid]:
            lg, cache = prefill_chunk(cfg, cpu_params, torch.tensor(
                [r.tokens[at:at + n]]), cache)
            at += n
        toks = [int(lg[0].argmax())]
        while len(toks) < r.output_len:
            lg, cache = decode_step(cfg, cpu_params,
                                    torch.tensor([[toks[-1]]]), cache)
            toks.append(int(lg[0].argmax()))
        assert g.tokens == toks
