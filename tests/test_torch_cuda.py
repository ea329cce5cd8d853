"""PyTorch port on the card: the CUDA kernels against their plain
versions at small shapes (the SSD kernel also at every SSM shape of the
configs, full width included), and the unified and P/D servers on CUDA
(P/D also on pages with prefix sharing) against the same servers on the
CPU (reduced mamba2-370m: against the CPU model replaying the serve's
prefill chunk boundaries; reduced granite-moe and deepseek-v3 on the
unified plane); MoE dispatch on the card against every-expert
evaluation, with no host sync, and MLA's paged decode against the CPU.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one;
on the card run

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

from repro_torch.config.base import AttentionKind, ServingConfig, get_arch
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
# kernel #2's bf16 body (wgmma, a TMA/cp.async ring, a split over keys for
# few-query grids): not causal at whisper's kinds of shapes, every G and
# head dim, dead keys holding NaN, padding rows split and unsplit, and a
# split call replayed from a CUDA graph
# ---------------------------------------------------------------------------

def _cross_case(g, B, Sq, Skv, H, K, hd, dev):
    """Not causal: every position 0 and segment 0 (cross-attention)."""
    q = _rand(g, (B, Sq, H, hd), torch.bfloat16, dev)
    k = _rand(g, (B, Skv, K, hd), torch.bfloat16, dev)
    v = _rand(g, (B, Skv, K, hd), torch.bfloat16, dev)
    qp = torch.zeros(B, Sq, dtype=torch.int32, device=dev)
    kp = torch.zeros(B, Skv, dtype=torch.int32, device=dev)
    return q, k, v, qp, kp, qp.clone(), kp.clone()


@pytest.mark.parametrize("Skv", [1, 63, 64, 65, 1500])
@pytest.mark.parametrize("Sq", [1, 2, 16, 17, 64, 77, 1500])
def test_flash_bf16_not_causal_shapes(dev, Sq, Skv):
    """Whisper's head dim and G = 1 at every query count the body takes
    a different plan for (64-row CTAs split over keys, 64 and 192-row
    CTAs unsplit) over key counts around the 64-key tile."""
    g = torch.Generator().manual_seed(Sq * 7 + Skv)
    ins = _cross_case(g, 2, Sq, Skv, 4, 4, 64, dev)
    before = flash_prefill.launches
    out = flash_prefill(*ins, causal=False)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    ref = flash_prefill_plain(*[t.float() for t in ins[:3]], *ins[3:],
                              causal=False)
    _assert_close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 120, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 7])
@pytest.mark.parametrize("Sq,Skv", [(17, 1500), (77, 65), (300, 300)])
def test_flash_bf16_groups_and_head_dims(dev, hd, G, Sq, Skv):
    """G query heads a kv head (packed into a CTA's rows when G divides
    them, one head a CTA at 7) at head dims 64, 120 and 128, not causal,
    and causal on the square case."""
    g = torch.Generator().manual_seed(G * 100 + hd + Sq)
    K = 2
    ins = list(_cross_case(g, 2, Sq, Skv, G * K, K, hd, dev))
    causal = Sq == Skv
    if causal:
        ins[3] = torch.arange(Sq, dtype=torch.int32, device=dev).repeat(2, 1)
        ins[4] = ins[3].clone()
    out = flash_prefill(*ins, causal=causal)
    ref = flash_prefill_plain(*[t.float() for t in ins[:3]], *ins[3:],
                              causal=causal)
    _assert_close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bf16_dead_keys_hold_nan(dev, hd):
    """Keys with kv_pos < 0 or segment -1 are never read: NaN planted in
    their K/V rows (tiles partly alive, so both the TMA and the cp.async
    paths run) leaves the output finite and equal to the plain version
    on zeroed rows."""
    g = torch.Generator().manual_seed(hd)
    B, Sq, S, H, K = 2, 117, 320, 8, 4
    q, k, v, qp, kvp, qs, ks = _extend_case(g, Sq, 40, S, K, hd,
                                            torch.bfloat16, dev, H)
    ks[0, 100:110] = -1
    kvp[0, 30:35] = -1
    dead = (kvp < 0) | (ks < 0)
    kn, vn = k.clone(), v.clone()
    kn[dead] = float("nan")
    vn[dead] = float("nan")
    kz, vz = k.clone(), v.clone()
    kz[dead] = 0
    vz[dead] = 0
    for causal in (True, False):
        out = flash_prefill(q, kn, vn, qp, kvp, qs, ks, causal)
        assert bool(torch.isfinite(out).all())
        ref = flash_prefill_plain(q.float(), kz.float(), vz.float(), qp, kvp,
                                  qs, ks, causal)
        _assert_close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_bf16_padding_rows_zero_split_or_not(dev, rows, n_split):
    """Through the binding at a forced plan: a padding query row (segment
    -1), a row whose keys are all padding, and splits whose keys are all
    dead (row 1's first 192 keys) give exactly 0 where the plain version
    does, never NaN, whatever the split count."""
    from repro_torch.kernels.build import load_kernels
    g = torch.Generator().manual_seed(rows + n_split)
    B, Sq, Skv, H = 3, 16, 448, 4
    q, k, v, qp, kp, qs, ks = _cross_case(g, B, Sq, Skv, H, H, 64, dev)
    qs[0, 5] = -1                    # a padding query row
    ks[2] = -1                       # every key of row 2 is padding
    kp[1, :192] = -1                 # row 1's first splits all dead
    out = load_kernels().flash_prefill(q, k, v, qp, kp, qs, ks, False, 0,
                                       64 ** -0.5, rows, n_split)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp, kp, qs,
                              ks, causal=False)
    _assert_close(out, ref, torch.bfloat16)
    assert float(out[0, 5].abs().max()) == 0.0
    assert float(out[2].abs().max()) == 0.0


def test_paged_bf16_holes_and_window(dev):
    """The paged entry (bs 16, 64-key tiles of four pages) with -1 table
    entries inside a row's range, a window, and a split forced through
    the binding: dead pages are zero-filled, never read."""
    from repro_torch.kernels.build import load_kernels
    g = torch.Generator().manual_seed(5)
    rows = [(300, 64), (150, 40)]
    lens = [p0 + sc for p0, sc in rows]
    kp, vp, kvp, tab = _paged_case(g, 2, 80, 16, 30, 4, 128, torch.bfloat16,
                                   dev, lens)
    tab[0, 3] = -1                   # a hole: its keys are dead
    tab[1, 1] = -1
    positions = torch.stack([
        (p0 + torch.arange(64)).clamp(max=p0 + sc - 1) for p0, sc in rows
    ]).to(torch.int32).to(dev)
    q = _rand(g, (2, 64, 16, 128), torch.bfloat16, dev)
    for window in (0, 100):
        ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                            kvp, tab, positions, window)
        out = paged_prefill_attention(q, kp, vp, kvp, tab, positions, window)
        _assert_close(out, ref, torch.bfloat16)
        for n_split in (2, 5):
            out = load_kernels().paged_prefill_attention(
                q, kp, vp, kvp, tab, positions, window, 128 ** -0.5, 64,
                n_split)
            _assert_close(out, ref, torch.bfloat16)


def test_flash_bf16_split_call_replays_from_a_graph(dev):
    """Whisper's decode-step cross-attention (a split plan and the merge
    kernel, partials from torch.empty in the binding) captured in a CUDA
    graph replays bit for bit as eager calls, on new data too."""
    g = torch.Generator().manual_seed(9)
    ins = _cross_case(g, 4, 1, 1500, 20, 20, 64, dev)
    flash_prefill(*ins, causal=False)
    assert flash_prefill.last_plan[1] > 1        # the split path
    static = [t.clone() for t in ins]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefill(*static, causal=False)      # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefill(*static, causal=False)
    for seed in (1, 2):
        new = _cross_case(torch.Generator().manual_seed(seed), 4, 1, 1500,
                          20, 20, 64, dev)
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        eager = flash_prefill(*new, causal=False)
        assert torch.equal(out, eager)


def test_flash_config_reads_the_compiled_bodies(dev):
    """The planner's card figures come from the compiled kernels: 64-key
    tiles; bf16 bodies of 64 and 128 rows, and 192 at head dim 64 only;
    fp32 bodies of 64 rows, and 128 at head dim 64 only (their stages
    fill the shared memory); no paged body at head dim 120; at least one
    CTA an SM of every body and two of the bf16 64-row body at head dim
    64 (its launch bounds ask for two), and the card's SM count."""
    from repro_torch.kernels.flash_prefill.ops import flash_config
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf, f32 = torch.bfloat16, torch.float32
    for hd, paged, dtype, rows in (
            (64, False, bf, {192, 128, 64}), (64, True, bf, {192, 128, 64}),
            (128, False, bf, {128, 64}), (128, True, bf, {128, 64}),
            (120, False, bf, {128, 64}), (120, True, bf, set()),
            (64, False, f32, {128, 64}), (64, True, f32, {128, 64}),
            (128, False, f32, {64}), (128, True, f32, {64}),
            (120, False, f32, {64}), (120, True, f32, set())):
        cfg = flash_config(dev, hd, paged, dtype)
        assert cfg.keys == 64 and cfg.sm_count == sms
        assert set(cfg.ctas_per_sm) == rows
        assert all(n >= 1 for n in cfg.ctas_per_sm.values())
    assert flash_config(dev, 64, False, bf).ctas_per_sm[64] >= 2


# ---------------------------------------------------------------------------
# kernel #2's fp32 body (3xTF32 on wgmma, K and V split by the consumers)
# at its edges, held to the fp32 tolerances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
def test_flash_fp32_dead_keys_hold_nan(dev, hd):
    """Keys with kv_pos < 0 or segment -1 are never read: NaN planted in
    their K/V rows (tiles partly alive, so both the TMA and the cp.async
    paths run, and 0 x NaN would show) leaves the output finite and
    equal to the plain version on zeroed rows; padding query rows are
    exactly 0."""
    g = torch.Generator().manual_seed(hd + 1)
    q, k, v, qp, kvp, qs, ks = _extend_case(g, 117, 40, 320, 4, hd,
                                            torch.float32, dev, 8)
    ks[0, 100:110] = -1
    kvp[0, 30:35] = -1
    qs[0, 5:9] = -1
    dead = (kvp < 0) | (ks < 0)
    kn, vn = k.clone(), v.clone()
    kn[dead] = float("nan")
    vn[dead] = float("nan")
    kz, vz = k.clone(), v.clone()
    kz[dead] = 0
    vz[dead] = 0
    for causal in (True, False):
        out = flash_prefill(q, kn, vn, qp, kvp, qs, ks, causal)
        assert bool(torch.isfinite(out).all())
        ref = flash_prefill_plain(q, kz, vz, qp, kvp, qs, ks, causal)
        _assert_close(out, ref, torch.float32)
        assert float(out[0, 5:9].abs().max()) == 0.0


@pytest.mark.parametrize("hd", [64, 120, 128])
@pytest.mark.parametrize("Sq", [1, 17, 64, 65, 130])
def test_flash_fp32_ragged_window_segments(dev, hd, Sq):
    """Ragged query counts around the 64-row warpgroup, causal with a
    window, over packed segments whose padding (-1) is both queries and
    keys, and a query row whose every key is masked (its segment has no
    key): exactly 0 where the plain version is; hd 120's padding
    columns never reach the output."""
    g = torch.Generator().manual_seed(Sq + hd)
    B, Skv, H, K = 2, 200, 4, 2
    q = _rand(g, (B, Sq, H, hd), torch.float32, dev)
    k = _rand(g, (B, Skv, K, hd), torch.float32, dev)
    v = _rand(g, (B, Skv, K, hd), torch.float32, dev)
    kp = torch.arange(Skv, dtype=torch.int32).repeat(B, 1)
    ks = torch.zeros(B, Skv, dtype=torch.int32)
    ks[:, 120:] = 1
    ks[:, 180:] = -1
    qp = (Skv - Sq + torch.arange(Sq, dtype=torch.int32)).clamp(min=0)
    qp = qp.repeat(B, 1)
    qs = torch.ones(B, Sq, dtype=torch.int32)
    qs[0, ::3] = -1                   # padding query rows
    qs[1, -1] = 2                     # a segment no key has
    ints = [t.to(dev) for t in (qp, kp, qs, ks)]
    for window in (0, 50):
        out = flash_prefill(q, k, v, *ints, True, window)
        ref = flash_prefill_plain(q, k, v, *ints, True, window)
        _assert_close(out, ref, torch.float32)
        assert float(out[0, ::3].abs().max()) == 0.0
        assert float(out[1, -1].abs().max()) == 0.0


@pytest.mark.parametrize("hd", [64, 120, 128])
@pytest.mark.parametrize("G", [1, 2, 7])
def test_flash_fp32_groups(dev, hd, G):
    """G query heads a kv head (internvl2-1b's 7: one head a CTA) at
    every head dim, causal and not, through the planner's rows."""
    g = torch.Generator().manual_seed(G * 10 + hd)
    B, S, K = 2, 300, 2
    q = _rand(g, (B, S, G * K, hd), torch.float32, dev)
    k = _rand(g, (B, S, K, hd), torch.float32, dev)
    v = _rand(g, (B, S, K, hd), torch.float32, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for causal in (True, False):
        out = flash_prefill(q, k, v, pos, pos, seg, seg, causal)
        ref = flash_prefill_plain(q, k, v, pos, pos, seg, seg, causal)
        _assert_close(out, ref, torch.float32)


@pytest.mark.parametrize("hd", [64, 128])
def test_paged_fp32_holes_window_and_splits(dev, hd):
    """The paged entry in fp32 (16-token pages, 64-key tiles of four)
    with -1 table entries inside a row's range (dead pages zero-filled),
    a window, every row count the fp32 body has, and splits forced
    through the binding."""
    from repro_torch.kernels.build import load_kernels
    from repro_torch.kernels.flash_prefill.ops import flash_config
    g = torch.Generator().manual_seed(hd)
    rows = [(300, 64), (150, 40)]
    kp, vp, kvp, tab = _paged_case(g, 2, 80, 16, 30, 4, hd, torch.float32,
                                   dev, [p0 + sc for p0, sc in rows])
    tab[0, 3] = -1
    tab[1, 1] = -1
    positions = torch.stack([
        (p0 + torch.arange(64)).clamp(max=p0 + sc - 1) for p0, sc in rows
    ]).to(torch.int32).to(dev)
    q = _rand(g, (2, 64, 8, hd), torch.float32, dev)
    cfg = flash_config(dev, hd, True, torch.float32)
    for window in (0, 100):
        ref = paged_prefill_attention_plain(q, kp, vp, kvp, tab, positions,
                                            window)
        out = paged_prefill_attention(q, kp, vp, kvp, tab, positions, window)
        _assert_close(out, ref, torch.float32)
        for n_rows in cfg.ctas_per_sm:
            for n_split in (1, 2, 5):
                out = load_kernels().paged_prefill_attention(
                    q, kp, vp, kvp, tab, positions, window, hd ** -0.5,
                    n_rows, n_split)
                _assert_close(out, ref, torch.float32)


@pytest.mark.parametrize("hd", [64, 120, 128])
def test_flash_fp32_split_matches_unsplit(dev, hd):
    """A not-causal call of few CTAs (16 queries over 1500 keys) is split
    by the planner; every split count the binding takes agrees with the
    unsplit plan and the plain version, and a row whose keys are all
    padding is exactly 0 split or not."""
    from repro_torch.kernels.build import load_kernels
    g = torch.Generator().manual_seed(hd + 3)
    ins = list(_cross_case(g, 2, 16, 1500, 8, 4, hd, dev))
    ins[:3] = [t.float() for t in ins[:3]]
    ins[6][1] = -1                   # row 1: every key padding
    flash_prefill(*ins, causal=False)
    assert flash_prefill.last_plan[1] > 1
    ref = flash_prefill_plain(*ins, causal=False)
    one = load_kernels().flash_prefill(*ins, False, 0, hd ** -0.5, 64, 1)
    _assert_close(one, ref, torch.float32)
    for n_split in (2, 3, 6, 24):
        out = load_kernels().flash_prefill(*ins, False, 0, hd ** -0.5, 64,
                                           n_split)
        _assert_close(out, ref, torch.float32)
        assert float((out - one).abs().max()) <= 1e-5
        assert float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fp32_call_replays_from_a_graph(dev, causal):
    """The fp32 body in a captured step (phase 6j's shape cut to 2 x 256,
    causal and unsplit; not causal at 16 queries over 1500 keys, split
    with the merge kernel) replays bit for bit as eager calls, on new
    data too."""
    def case(seed):
        g = torch.Generator().manual_seed(seed)
        if causal:
            q, k, v, qp, kp, qs, ks = _cross_case(g, 2, 256, 256, 8, 8, 64,
                                                  dev)
            qp = torch.arange(256, dtype=torch.int32,
                              device=dev).repeat(2, 1)
            kp = qp.clone()
        else:
            q, k, v, qp, kp, qs, ks = _cross_case(g, 2, 16, 1500, 8, 8, 64,
                                                  dev)
        return [q.float(), k.float(), v.float(), qp, kp, qs, ks]
    static = case(0)
    flash_prefill(*static, causal=causal)
    assert (flash_prefill.last_plan[1] > 1) == (not causal)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefill(*static, causal=causal)     # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefill(*static, causal=causal)
    for seed in (1, 2):
        for dst, src in zip(static, case(seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_prefill(*static, causal=causal))


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
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (16, 8, 64), (16, 4, 64),
                                    (8, 1, 128), (32, 8, 128), (12, 2, 128)])
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


def test_pd_prefix_server_on_cuda_matches_cpu(dev):
    """Reduced deepseek-7b in fp32, P/D on pages with prefix_cache=True:
    two waves of prompts sharing a 48-token prefix (wave 2 repeats wave
    1) give the same tokens on the card (page-native prefill through the
    paged flash entry, paged decode through kernel #1; neither the
    contiguous entry nor kernel #3 runs) as on the CPU; pages are shared
    and copied on write, and every pool is empty after eviction."""
    cfg = get_arch("deepseek-7b", reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=2, chunk_size=32,
        max_batch_per_dp=4, block_size=16, n_limit=64)
    rng = random.Random(8)
    prefix = [rng.randrange(cfg.vocab_size) for _ in range(48)]
    prompts = [prefix + [rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in (5, 11, 30, 20)]
    prompts.append(list(prompts[0]))

    def wave(w):
        return [Request(rid=10 * w + i, arrival_time=0.05 * i,
                        input_len=len(p), output_len=6, tokens=tuple(p))
                for i, p in enumerate(prompts)]

    cpu_params = init_params(cfg, seed=0, device="cpu")
    counters = (paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention)
    out = {}
    for device in ("cpu", "cuda"):
        params = _to(cpu_params, device)
        before = [c.launches for c in counters]
        srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la",
                            max_len=96, max_new=6, prefix_cache=True,
                            device=device)
        gens = srv.serve(wave(0), timeout=120)
        gens += srv.serve(wave(1), timeout=120)
        out[device] = {g.rid: g.tokens for g in gens}
        stats = srv.prefix_stats()
        assert stats["prefix_hit_tokens"] > 0
        assert stats["decode_blocks_shared"] > 0
        assert stats["decode_cow_copies"] > 0
        if device == "cuda":
            ran = [c.launches - b for c, b in zip(counters, before)]
            assert ran[0] > 0 and ran[1] > 0 and ran[2:] == [0, 0]
        for eng in srv.engines:
            assert eng.binder.ensure_free(eng.pool.num_blocks - 1)
            eng.pool.check()
            assert eng.pool.used_count == 0
        for eng in srv.decode_engines:
            for st in eng._dp.values():
                assert st.binder.ensure_free(st.pool.num_blocks - 1)
                st.pool.check()
                assert st.pool.used_count == 0
    assert len(out["cpu"]) == 2 * len(prompts)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_launch_on_a_second_card(dev, dtype):
    """#2 (both entries) and #4 ask for more than 48 KB of dynamic shared
    memory, an attribute of the kernel on each card: a tensor-parallel
    rank on a second card launches them after the first card did, and
    each agrees with its plain version there (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    for d in (torch.device("cuda:0"), torch.device("cuda:1")):
        g = torch.Generator().manual_seed(5)
        q = _rand(g, (2, 96, 8, 64), dtype, d)
        k = _rand(g, (2, 96, 2, 64), dtype, d)
        v = _rand(g, (2, 96, 2, 64), dtype, d)
        pos = torch.arange(96, dtype=torch.int32).repeat(2, 1).to(d)
        seg = torch.zeros_like(pos)
        out = flash_prefill(q, k, v, pos, pos, seg, seg, True, 0)
        _assert_close(out, flash_prefill_plain(
            q.float(), k.float(), v.float(), pos, pos, seg, seg, True, 0),
            dtype)
        kp, vp, kvp, tab = _paged_case(g, 2, 40, 16, 6, 2, 64, dtype, d,
                                       [40, 19])
        positions = torch.stack([torch.arange(21, 40),
                                 torch.arange(19).clamp(max=18)]).to(
            torch.int32).to(d)
        qp = _rand(g, (2, 19, 8, 64), dtype, d)
        _assert_close(paged_prefill_attention(qp, kp, vp, kvp, tab,
                                              positions),
                      paged_prefill_attention_plain(
                          qp.float(), kp.float(), vp.float(), kvp, tab,
                          positions), dtype)
        x, dt, A, Bm, Cm = _ssd_case(g, 1, 2, 64, 4, 64, 16, dtype, d)
        y, st = ssd_chunk(x, dt, A, Bm, Cm)
        yr, sr = ssd_chunk_plain(x.float(), dt, A, Bm.float(), Cm.float())
        _assert_close(y, yr, torch.float32)
        _assert_close(st, sr, torch.float32)
        torch.cuda.synchronize(d)


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


# ---------------------------------------------------------------------------
# MoE and MLA (torch ops on the card; the GQA attention of an MoE model
# still runs through kernels #1 and #2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
@pytest.mark.parametrize("T", [8, 256])
def test_moe_block_on_cuda_matches_dense_reference(dev, arch, T):
    """Full-width expert shapes in fp32 with a capacity factor of E/k (C
    >= T: nothing drops): the sort-based dispatch on the card equals
    every-expert evaluation, and dispatch never synchronises with the
    host (C comes from shapes)."""
    import dataclasses
    from repro_torch.models.moe import (
        init_moe_params, moe_block, moe_block_dense_reference)
    mc = get_arch(arch).moe
    mc = dataclasses.replace(mc, capacity_factor=mc.num_experts / mc.top_k,
                             num_experts=min(mc.num_experts, 64),
                             d_expert=min(mc.d_expert, 512),
                             d_shared=min(mc.d_shared, 512))
    D = min(get_arch(arch).d_model, 2048)
    gen = torch.Generator(device=dev).manual_seed(T)
    p = init_moe_params(gen, D, mc, torch.float32)
    if "router_bias" in p:
        p["router_bias"] = torch.randn(mc.num_experts, device=dev,
                                       generator=gen) * 0.1
    x = torch.randn((T, D), device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe_block(x, p, mc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, _ = moe_block_dense_reference(x, p, mc)
    d = float((out - ref).abs().max())
    assert d <= 1e-4 * float(ref.abs().max())


def test_mla_paged_decode_on_cuda_matches_cpu(dev):
    """Reduced minicpm3-4b's absorbed MLA decode over latent pools, fp32,
    on the card and on the CPU: outputs and written pools within 1e-5."""
    from repro_torch.models.blocks import mla_decode_paged
    cfg = get_arch("minicpm3-4b", reduced=True)
    p = init_params(cfg, seed=0, device="cpu")["layers"][0]["attn"]
    g = torch.Generator().manual_seed(0)
    N, bs, m = 12, 8, cfg.mla
    ckv = torch.randn((N, bs, m.kv_lora_rank), generator=g)
    kr = torch.randn((N, bs, m.qk_rope_head_dim), generator=g)
    kvp = torch.full((N, bs), -1, dtype=torch.int32)
    tab = torch.tensor([[3, 7, 1, -1], [5, -1, -1, -1], [-1] * 4],
                       dtype=torch.int32)
    for b, n in enumerate((20, 3, 0)):
        for t in range(n):
            kvp[tab[b, t // bs], t % bs] = t
    pos = torch.tensor([20, 3, 0], dtype=torch.int32)
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    res = {}
    for device in ("cpu", "cuda"):
        pools = [t.clone().to(device) for t in (ckv, kr, kvp)]
        out = mla_decode_paged(_to(p, device), x.to(device), cfg, *pools,
                               tab.to(device), pos.to(device))
        res[device] = [out] + pools
    for c, d in zip(res["cpu"], res["cuda"]):
        if c.dtype == torch.int32:
            assert torch.equal(c, d.cpu())
        else:
            assert float((c - d.cpu()).abs().max()) <= 1e-5 * max(
                float(c.abs().max()), 1.0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_moe_and_mla_unified_server_on_cuda_matches_cpu(dev, arch):
    """Reduced granite-moe (GQA through kernels #1 and #2, G = 2) and
    reduced deepseek-v3 (MLA and MoE as torch ops) in fp32 on the
    unified plane: the served tokens on the card equal the same server's
    on the CPU."""
    cfg = get_arch(arch, reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        max_batch_per_dp=4, block_size=16, mixed_batch=True, mixed_chunk=32)
    rng = random.Random(5)
    prompts = [tuple(rng.randrange(cfg.vocab_size) for _ in range(L))
               for L in (17, 40, 33, 64)]
    cpu_params = init_params(cfg, seed=0, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        before = (paged_decode_attention.launches,
                  paged_prefill_attention.launches)
        srv = RealSBSServer(cfg, _to(cpu_params, device), scfg,
                            scheduler="sbs-la", max_len=96, max_new=6,
                            device=device)
        gens = srv.serve([Request(rid=i, arrival_time=0.02 * i,
                                  input_len=len(t), output_len=6, tokens=t)
                          for i, t in enumerate(prompts)], timeout=120)
        out[device] = {g.rid: g.tokens for g in gens}
        ran = (paged_decode_attention.launches - before[0],
               paged_prefill_attention.launches - before[1])
        if device == "cuda" and cfg.attention == AttentionKind.MLA:
            assert ran == (0, 0)
        elif device == "cuda":
            assert ran[0] > 0 and ran[1] > 0
    assert len(out["cpu"]) == 4
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# head dim 120 (h2o-danube-3-4b): kernel #3 and #2's contiguous entry run
# the 128-wide body with the padding zeroed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,S,pos", [
    (0, 1088, [1087, 700, 129, 40]),         # padded rows
    (512, 512, [1500, 700, 511, 2047]),      # wrapped rings, window = S
    (100, 520, [1500, 300, 519, 9]),         # a window smaller than S
])
def test_dense_decode_kernel_head_dim_120(dev, dtype, window, S, pos):
    """G = 4 (32 heads over 8 KV heads, h2o-danube's), rows of the
    padded plane, wrapped rings and a window smaller than S; an empty
    row gives exactly 0."""
    g = torch.Generator().manual_seed(S + window)
    kc, vc, kvp, posn = _dense_case(g, pos + [9], S, 8, 120, dtype, dev,
                                    empty=(4,))
    q = _rand(g, (5, 32, 120), dtype, dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, kvp, posn, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                 posn, window)
    _assert_close(out, ref, dtype)
    assert float(out[4].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["packed", "extend", "ring"])
def test_flash_prefill_kernel_head_dim_120(dev, dtype, case):
    """G = 4 at head dim 120: packed segments with padding (200 + 250 +
    pad of 512), attn_extend's 256-token chunk over a 1088-long cache
    with an empty tail, and a 117-token chunk over a wrapped window-96
    ring of 128; padding rows and an all-empty cache give exactly 0."""
    g = torch.Generator().manual_seed(len(case))
    B, H, K, hd = 2, 32, 8, 120
    window = 96 if case == "ring" else 0
    if case == "packed":
        S = Sq = 512
        pos = torch.zeros(S, dtype=torch.int32)
        seg = torch.full((S,), -1, dtype=torch.int32)
        at = 0
        for i, n in enumerate((200, 250)):
            pos[at:at + n] = torch.arange(n, dtype=torch.int32)
            seg[at:at + n] = i
            at += n
        qp = kvp = pos.repeat(B, 1)
        qs = ks = seg.repeat(B, 1)
    else:
        S, Sq, p0 = (1088, 256, 512) if case == "extend" else (128, 117, 500)
        qp = (p0 + torch.arange(Sq, dtype=torch.int32)).repeat(B, 1)
        kv = torch.full((S,), -1, dtype=torch.int32)
        t = torch.arange(max(0, p0 + Sq - S), p0 + Sq, dtype=torch.int32)
        kv[t % S] = t
        kvp = kv.repeat(B, 1)
        kvp[1] = -1                              # every tile skipped
        qs = torch.zeros(B, Sq, dtype=torch.int32)
        ks = torch.zeros(B, S, dtype=torch.int32)
    q = _rand(g, (B, Sq, H, hd), dtype, dev)
    k = _rand(g, (B, S, K, hd), dtype, dev)
    v = _rand(g, (B, S, K, hd), dtype, dev)
    ints = [x.to(dev).contiguous() for x in (qp, kvp, qs, ks)]
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, *ints, True, window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), *ints, True,
                              window)
    _assert_close(out, ref, dtype)
    if case == "packed":
        assert float(out[ints[2] < 0].abs().max()) == 0.0
    else:
        assert float(out[1].abs().max()) == 0.0


def test_paged_kernels_refuse_head_dim_120_on_cuda(dev):
    """Sliding-window models never page: kernel #1 and #2's paged entry
    stay at head dims 64 and 128."""
    i32 = dict(dtype=torch.int32, device=dev)
    pool = torch.zeros(3, 16, 2, 120, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        paged_decode_attention(torch.zeros(1, 4, 120, device=dev), pool,
                               pool, torch.zeros(3, 16, **i32),
                               torch.zeros(1, 2, **i32),
                               torch.zeros(1, **i32))
    with pytest.raises(ValueError, match="head dim"):
        paged_prefill_attention(torch.zeros(1, 8, 4, 120, device=dev), pool,
                                pool, torch.zeros(3, 16, **i32),
                                torch.zeros(1, 2, **i32),
                                torch.zeros(1, 8, **i32))


# ---------------------------------------------------------------------------
# compiled steps: CUDA graphs against the eager steps
# ---------------------------------------------------------------------------

def _graph_runner(params, dev):
    import threading
    from repro_torch.serving.step_graphs import StepGraphs
    return StepGraphs(params, dev, threading.RLock())


def _graph_cache(cfg, params, plane, lens, dev, dtype, seed):
    """A decode cache whose row b holds a prompt of lens[b] tokens (0: an
    idle row), prefilled in 16-token chunks: padded rows joined from
    batch-1 caches, or a paged cache with a table per row."""
    from repro_torch.models.model import (
        cache_join, init_paged_cache, paged_prefill_step)
    rng = random.Random(seed)
    if plane == "padded":
        cache = init_cache(cfg, len(lens), 96, dtype=dtype, device=dev)
    else:
        nbt = 96 // 16
        cache = init_paged_cache(cfg, len(lens), len(lens) * nbt + 1, 96, 16,
                                 dtype=dtype, device=dev)
        cache["block_tab"] = torch.arange(
            1, len(lens) * nbt + 1, dtype=torch.int32,
            device=dev).reshape(len(lens), nbt)
    for b, L in enumerate(lens):
        ids = [rng.randrange(cfg.vocab_size) for _ in range(L)]
        one = init_cache(cfg, 1, 96, dtype=dtype, device=dev) \
            if plane == "padded" else None
        for at in range(0, L, 16):
            t = torch.tensor([ids[at:at + 16]], device=dev)
            if plane == "padded":
                _, one = prefill_chunk(cfg, params, t, one)
            else:
                _, cache = paged_prefill_step(cfg, params, t, cache, b)
        if one is not None:
            cache = cache_join(cache, one, b)
    return cache


_GRAPH_CASES = [
    ("deepseek-7b", "padded"), ("deepseek-7b", "paged"),
    ("deepseek-7b", "unified"), ("granite-moe-1b-a400m", "unified"),
    ("minicpm3-4b", "paged"), ("mamba2-370m", "padded"),
    ("h2o-danube-3-4b", "padded"), ("deepseek-v3-671b", "unified"),
]


def _graph_step_fn(cfg, params, plane):
    from repro_torch.models.model import paged_decode_masked, paged_decode_step
    if plane == "padded":
        return lambda c, token: decode_step(cfg, params, token, c)
    if plane == "paged":
        return lambda c, token: paged_decode_step(cfg, params, token, c)
    return lambda c, token, mask: paged_decode_masked(cfg, params, token, c,
                                                      mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,plane", _GRAPH_CASES,
                         ids=[f"{a}-{p}" for a, p in _GRAPH_CASES])
def test_decode_graphs_match_eager_on_cuda(dev, dtype, arch, plane):
    """Four decode steps of every model family and plane replayed from a
    CUDA graph against the same steps run eagerly on a copy of the
    cache: the same tokens, logits within 1e-5 of the largest in fp32
    (bit-identical expected; the difference is printed), and the same
    cursors, tables and kv_pos."""
    cfg = get_arch(arch, reduced=True)
    params = _to(init_params(cfg, seed=0, device="cpu", dtype=dtype), dev)
    cache = _graph_cache(cfg, params, "padded" if plane == "padded"
                         else "paged", [70, 21, 0, 40], dev, dtype, 1)
    fn = _graph_step_fn(cfg, params, plane)
    args = {"token": torch.tensor([[3], [5], [7], [11]], dtype=torch.int32,
                                  device=dev)}
    if plane == "unified":
        args["mask"] = torch.tensor([True, False, True, True], device=dev)
    eager = {k: v.clone() for k, v in cache.items()}
    runner = _graph_runner(params, dev)
    worst = 0.0
    for _ in range(4):
        lg_e, eager = fn(eager, **args)
        lg_g, cache = runner.run(("decode", 0), fn, cache, **args)
        torch.cuda.synchronize()
        worst = max(worst, float((lg_g.float() - lg_e.float()).abs().max()
                                 / lg_e.float().abs().max()))
        assert torch.equal(lg_g.argmax(-1), lg_e.argmax(-1))
        for key in ("cur", "block_tab", "kv_pos"):
            if key in cache:
                assert torch.equal(cache[key], eager[key]), key
        args["token"] = lg_e.argmax(-1).to(torch.int32)[:, None]
    print(f"{arch} {plane} {dtype}: graph vs eager logits max|d|/max|ref| "
          f"= {worst:.3e}")
    if dtype == torch.float32:
        assert worst <= 1e-5
    assert runner.captured == 1 and runner.replays == 4


def _graph_scfg(plane):
    # on pages with prefix sharing one decode DP unit of 8 rows: which
    # of two units a prompt lands on, and so what it shares, follows
    # timing
    prefix = plane == "pd-prefix"
    kw = dict(num_prefill_instances=1 if prefix else 2,
              prefill_dp_per_instance=2 if prefix else 1,
              num_decode_instances=1, decode_dp_per_instance=1 if prefix else 2,
              chunk_size=32, t_default=0.05, l_net=0.001,
              max_batch_per_dp=8 if prefix else 4, n_limit=64,
              block_size=0 if plane == "pd-padded" else 16)
    if plane == "unified":
        kw.update(mixed_batch=True, mixed_chunk=32)
    return ServingConfig(**kw)


_GRAPH_SERVES = [
    ("deepseek-7b", "unified"), ("deepseek-7b", "pd-padded"),
    ("deepseek-7b", "pd-paged"), ("deepseek-7b", "pd-prefix"),
    ("granite-moe-1b-a400m", "unified"), ("minicpm3-4b", "pd-prefix"),
    ("mamba2-370m", "pd-padded"), ("h2o-danube-3-4b", "pd-padded"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,plane", _GRAPH_SERVES,
                         ids=[f"{a}-{p}" for a, p in _GRAPH_SERVES])
def test_graph_servers_match_eager_on_cuda(dev, dtype, arch, plane):
    """Servers of every family and plane with step graphs (the default)
    and without give the same tokens on the card; on pages with
    prefix_cache=True (joins by PageHandoff over shared pages and
    copy-on-write tails) also the same reuse counters.  Graph mode
    replays its decode steps and its page-native or dense prefill
    chunks: the graph counts are read back."""
    from repro_torch.serving.real_engine import EngineSpec
    cfg = get_arch(arch, reduced=True)
    params = _to(init_params(cfg, seed=0, device="cpu", dtype=dtype), dev)
    scfg = _graph_scfg(plane)
    rng = random.Random(7)
    if plane == "pd-prefix":
        prefix = [rng.randrange(cfg.vocab_size) for _ in range(48)]
        seed = prefix + [rng.randrange(cfg.vocab_size) for _ in range(10)]
        waves = [[seed], [seed] + [prefix + [rng.randrange(cfg.vocab_size)
                                             for _ in range(10)]
                                   for _ in range(4)]]
    else:
        waves = [[[rng.randrange(cfg.vocab_size) for _ in range(L)]
                  for L in (17, 40, 33, 64)]]
    out = {}
    for graphs in (True, False):
        spec = EngineSpec(cfg, params, max_len=96,
                          max_batch=scfg.max_batch_per_dp, max_new=6,
                          block_size=scfg.block_size,
                          decode_slots=(scfg.resolved_decode_slots
                                        if scfg.block_size else 0),
                          device=dev, step_graphs=graphs)
        srv = RealSBSServer(cfg, params, scfg, scheduler="sbs", spec=spec,
                            prefix_cache=plane == "pd-prefix")
        tokens = {}
        for w, wave in enumerate(waves):
            gens = srv.serve([Request(rid=10 * w + i, arrival_time=0.05 * i,
                                      input_len=len(p), output_len=3 + i % 2,
                                      tokens=tuple(p))
                              for i, p in enumerate(wave)], timeout=120)
            assert len(gens) == len(wave)
            tokens.update({g.rid: g.tokens for g in gens})
        out[graphs] = (tokens, srv.prefix_stats())
        engines = [*srv.engines, *srv.decode_engines]
        if graphs:
            st = [e.graphs.stats() for e in engines]
            assert sum(s["graphs"] for s in st) >= 2     # one per DP unit
            assert sum(s["replays"] for s in st) > 0
            if plane in ("unified", "pd-prefix"):
                assert any(k[0] == "prefill" for e in engines
                           for k in e.graphs._entries)
            if plane == "pd-padded":
                assert all(k[0] == "prefill-dense" and e.graphs.replays > 0
                           for e in srv.engines for k in e.graphs._entries)
        else:
            assert all(e.graphs is None for e in engines)
    assert out[True] == out[False]
    if plane == "pd-prefix":
        assert out[True][1]["decode_cow_copies"] > 0


@pytest.mark.parametrize("graphs", [True, False], ids=["graph", "eager"])
def test_graph_replay_after_preemption_matches_cpu(dev, graphs):
    """Paged decode engine, reduced deepseek-7b in fp32: two residents
    join by PageHandoff over a shared 32-token prefix (each one's tail
    copied on write), step, the first is preempted (parked as a dense
    cache), the other steps alone, the first re-joins by the dense join;
    both finish with the tokens of the same engine on the CPU."""
    import threading
    from repro_torch.core.types import DecodeDPState
    from repro_torch.models.model import (
        init_paged_cache, paged_gather_blocks, paged_prefill_step)
    from repro_torch.serving.plane import ASYNC
    from repro_torch.serving.real_engine import (
        EngineSpec, KVHandoffBus, PageHandoff, RealDecodeEngine)
    cfg = get_arch("deepseek-7b", reduced=True)
    cpu_params = init_params(cfg, seed=0, device="cpu")
    rng = random.Random(3)
    prefix = [rng.randrange(cfg.vocab_size) for _ in range(32)]
    prompts = [prefix + [rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in (8, 13)]

    def step(eng, dps):
        done = threading.Event()
        eng._post = lambda kind, payload: done.set()
        assert eng.start_step([dps], 0.0) is ASYNC
        assert done.wait(60)
        return eng.finish_step(0.0, [dps])

    out = {}
    for device in ("cpu", "cuda"):
        params = _to(cpu_params, device)
        spec = EngineSpec(cfg, params, max_len=96, max_batch=4, max_new=6,
                          block_size=16, device=device,
                          step_graphs=graphs or device == "cpu")
        bus = KVHandoffBus()
        eng = RealDecodeEngine(0, [0], spec, bus, share_prefix=True)
        dps = DecodeDPState(dp_id=0, instance_id=0, block_size=16)
        reqs = []
        for i, ids in enumerate(prompts):
            pc = init_paged_cache(cfg, 1, spec.nbt + 1, 96, 16,
                                  device=device)
            pc["block_tab"] = torch.arange(1, spec.nbt + 1, dtype=torch.int32,
                                           device=device)[None]
            for at in range(0, len(ids), 16):
                lg, pc = paged_prefill_step(
                    cfg, params, torch.tensor([ids[at:at + 16]],
                                              device=device), pc, 0)
            n = -(-len(ids) // 16)
            payload = paged_gather_blocks(cfg, pc, spec.table(
                list(range(1, n + 1))))
            bus.publish(i, PageHandoff(payload, len(ids)),
                        int(lg[0].argmax()))
            r = Request(rid=i, arrival_time=0.0, input_len=len(ids),
                        output_len=6, tokens=tuple(ids), priority=2 - 2 * i)
            r.generated = 1
            dps.admit(r.input_len, reserve_len=r.input_len + r.output_len)
            eng.admit(0, r)
            reqs.append(r)
        eng.start()
        try:
            finished = list(step(eng, dps))      # both join, one step
            assert (eng.blocks_shared, eng.cow_copies) == (2, 2)
            assert eng.preempt(0) is reqs[0]
            finished += step(eng, dps)           # rid 1 alone
            eng.admit(0, reqs[0])                # the dense re-join
            while eng.has_work():
                finished += step(eng, dps)
        finally:
            eng.stop()
            eng.join_worker(timeout=10)
        assert sorted(r.rid for r in finished) == [0, 1]
        out[device] = {r.rid: bus.gen(r.rid).tokens for r in reqs}
        if device == "cuda" and graphs:
            assert eng.graphs.replays > 0
    assert out["cuda"] == out["cpu"]


def test_step_capture_has_no_host_sync(dev):
    """Capturing the decode step of every family (and a page-native
    prefill chunk) with the sync debug mode set to "error": a hidden host
    sync would raise."""
    from repro_torch.models.model import paged_prefill_step
    for arch, plane in _GRAPH_CASES:
        cfg = get_arch(arch, reduced=True)
        params = _to(init_params(cfg, seed=0, device="cpu",
                                 dtype=torch.bfloat16), dev)
        cache = _graph_cache(cfg, params, "padded" if plane == "padded"
                             else "paged", [20, 0, 5, 9], dev,
                             torch.bfloat16, 2)
        args = {"token": torch.zeros((4, 1), dtype=torch.int32, device=dev)}
        if plane == "unified":
            args["mask"] = torch.ones(4, dtype=torch.bool, device=dev)
        runner = _graph_runner(params, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.prepare(("decode", 0), _graph_step_fn(cfg, params, plane),
                           cache, **args)
            if plane != "padded":
                runner.prepare(
                    ("prefill", 0, 13),
                    lambda c, tokens, slot: paged_prefill_step(
                        cfg, params, tokens, c, slot), cache,
                    tokens=torch.zeros((1, 13), dtype=torch.int32,
                                       device=dev), slot=2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert runner.captured == (1 if plane == "padded" else 2)


def test_swapped_pool_raises_on_cuda(dev):
    """A graph holds raw pointers: a pool, a kv_pos map or a weight that
    is not the storage it was captured on raises at the next replay."""
    from repro_torch.models.model import paged_decode_step
    cfg = get_arch("deepseek-7b", reduced=True)
    params = _to(init_params(cfg, seed=0, device="cpu"), dev)
    cache = _graph_cache(cfg, params, "paged", [20, 5, 0, 0], dev,
                         torch.float32, 3)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    runner = _graph_runner(params, dev)

    def fn(c, token):
        return paged_decode_step(cfg, params, token, c)
    _lg, cache = runner.run(("decode", 0), fn, cache, token=tok)
    for name in ("k", "v", "kv_pos"):
        with pytest.raises(RuntimeError, match="not the storage"):
            runner.run(("decode", 0), fn,
                       dict(cache, **{name: cache[name].clone()}), token=tok)
    w = params["layers"][1]["mlp"]["w_up"]
    params["layers"][1]["mlp"]["w_up"] = w.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            runner.run(("decode", 0), fn, cache, token=tok)
    finally:
        params["layers"][1]["mlp"]["w_up"] = w
    assert runner.captured == 1 and runner.replays == 1


# ---------------------------------------------------------------------------
# compiled dense prefill: a prefill engine's pool rows through the graphs
# ---------------------------------------------------------------------------

_DENSE_ARCHS = ["deepseek-7b", "h2o-danube-3-4b", "mamba2-370m",
                "jamba-hybrid", "granite-moe-1b-a400m"]


def _dense_arch(name):
    """A reduced config; "jamba-hybrid" is reduced jamba with the layer
    pattern (SSM, DENSE) (no MoE layer)."""
    import dataclasses
    from repro_torch.config.base import LayerKind
    if name != "jamba-hybrid":
        return get_arch(name, reduced=True)
    return dataclasses.replace(get_arch("jamba-v0.1-52b", reduced=True),
                               layer_pattern=(LayerKind.SSM, LayerKind.DENSE))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", _DENSE_ARCHS)
def test_dense_prefill_graphs_match_eager_on_cuda(dev, dtype, arch):
    """Prompts interleaved chunk by chunk (16-token chunks and shorter
    tails; h2o-danube's window-64 ring wraps; a released row is reused)
    through `EngineSpec.dense_prefill` with step graphs — each chunk
    length captured once and replayed, the rows' K/V and positions
    copied through the static working cache — and eagerly on the rows
    of a second pool: bit-identical logits and rows (cursor, kv_pos, the
    written K/V, SSM and conv states).  The first capture runs with the
    sync debug mode set to "error": a host sync in the step would
    raise."""
    from repro_torch.models.model import cache_row
    from repro_torch.serving.real_engine import EngineSpec, _DenseRows
    cfg = _dense_arch(arch)
    params = _to(init_params(cfg, seed=0, device="cpu", dtype=dtype), dev)
    rng = random.Random(8)
    lens = (80, 29, 53, 21)
    prompts = [[rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in lens]
    schedule = [(0, 16), (1, 16), (0, 16), (1, 13), (0, 32), (0, 16),
                (2, 16), (2, 7), (3, 16), (2, 30), (3, 5)]
    modes = {}
    for graphs in (True, False):
        spec = EngineSpec(cfg, params, max_len=96, device=dev,
                          step_graphs=graphs)
        modes[graphs] = (spec, spec.step_graphs_for(), _DenseRows(spec, 2),
                         spec.request_cache() if graphs else None, {})
    at = {i: 0 for i in range(len(prompts))}
    for p, n in schedule:
        toks = torch.tensor([prompts[p][at[p]:at[p] + n]], dtype=torch.int32,
                            device=dev)
        out = {}
        for graphs, (spec, g, rows, work, row_of) in modes.items():
            if p not in row_of:
                row_of[p] = rows.take()
            b, r = row_of[p]
            first = graphs and not g._entries
            if first:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                lg = spec.dense_prefill(g, toks, rows.caches[b], r, at[p],
                                        work)
            finally:
                if first:
                    torch.cuda.set_sync_debug_mode("default")
            out[graphs] = (lg, cache_row(rows.caches[b], r))
        torch.cuda.synchronize()
        (lg_g, row_g), (lg_e, row_e) = out[True], out[False]
        assert torch.equal(lg_g, lg_e)
        assert torch.equal(row_g["cur"], row_e["cur"])
        assert torch.equal(row_g["kv_pos"], row_e["kv_pos"])
        written = row_e["kv_pos"][0] >= 0
        for name in ("k", "v", "ssm", "conv_x", "conv_bc"):
            if name in row_e:
                a, e = row_g[name], row_e[name]
                if name in ("k", "v"):
                    a, e = a[:, :, written], e[:, :, written]
                assert torch.equal(a, e), name
        at[p] += n
        if at[p] == len(prompts[p]):
            for _s, _g, rows, _w, row_of in modes.values():
                rows.release(row_of.pop(p))
    g = modes[True][1]
    assert g.captured == 6 and g.replays == len(schedule)


def test_dense_prefill_engine_captures_its_chunk_at_build(dev):
    """A dense prefill engine with step graphs captures its full chunk's
    graph when it is built, so a prompt of whole chunks captures nothing
    while it is served; a page-native one captures its full chunk too.
    A second dense engine of the same spec captures nothing: it replays
    the spec's graphs (`EngineSpec.dense_graphs`), while a second
    page-native engine, with a cache of its own, captures its own."""
    from repro_torch.serving.real_engine import (
        EngineSpec, KVHandoffBus, RealPrefillEngine)
    cfg = get_arch("deepseek-7b", reduced=True)
    params = _to(init_params(cfg, seed=0, device="cpu"), dev)
    for native in (False, True):
        spec = EngineSpec(cfg, params, max_len=96, max_batch=4,
                          block_size=16 if native else 0, device=dev)
        eng = RealPrefillEngine(0, [0], 32, spec, KVHandoffBus(),
                                page_native=native)
        key = ("prefill", 0, 32) if native else ("prefill-dense", 32)
        assert list(eng.graphs._entries) == [key]
        assert eng.graphs.captured == 1
        other = RealPrefillEngine(1, [1], 32, spec, KVHandoffBus(),
                                  page_native=native)
        assert list(other.graphs._entries) == [key]
        assert other.graphs.captured == (1 if native else 0)
        assert (other.graphs._entries is eng.graphs._entries) != native
        if not native:      # the pools are the first engine's
            assert other.graphs.pool_bytes() == 0 < eng.graphs.pool_bytes()


# ---------------------------------------------------------------------------
# The sharded DP+EP plane on the card
# ---------------------------------------------------------------------------

def _granite_moe(dev, dtype, D=1024, E=32, k=8, F=512, cf=1.25):
    """An MoE layer of full-width granite-moe-1b-a400m's shape on `dev`."""
    from repro_torch.config.base import MoEConfig
    from repro_torch.models.moe import init_moe_params
    mc = MoEConfig(num_experts=E, top_k=k, d_expert=F, capacity_factor=cf)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return mc, init_moe_params(g, D, mc, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_ep_on_logical_card_mesh(dev, dtype):
    """The EP layer on four logical shards of one card (cuda:0 × 4) at
    granite's width against its plain version on the same inputs in the
    same dtype, with the binding capacity of the config: every exchange
    counted, and timed on the card."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.moe_ep import (
        count_exchanges, moe_block_ep, moe_block_ep_reference,
    )
    mc, p = _granite_moe(dev, dtype)
    mesh = make_engine_mesh(4, devices=[dev] * 4)
    x = (torch.randn(256, 1024, generator=torch.Generator().manual_seed(1))
         * 0.5).to(dev, dtype)
    with count_exchanges(timed=True) as st:
        out, _ = moe_block_ep(x, p, mc, mesh, ("data",), ("data", "model"))
    ref, _ = moe_block_ep_reference(x, p, mc, 4)
    assert st.exchanges == 2 and st.bytes > 0 and st.seconds() > 0
    _assert_close(out, ref.float(), dtype)


def test_sharded_decode_step_on_card_matches_unsharded(dev):
    """A merged decode step of reduced granite-moe on four logical shards
    of the card (kernel #1 on each shard, the EP exchange per MoE layer)
    against the unsharded step on the same cache, at the reduced
    config's non-binding capacity factor."""
    from repro_torch.distributed.sharding import unshard_paged_cache
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.model import (
        init_paged_cache, paged_decode_masked,
    )
    from repro_torch.models.moe_ep import count_exchanges
    from repro_torch.serving.real_engine import EngineSpec
    cfg = get_arch("granite-moe-1b-a400m", reduced=True)
    params = init_params(cfg, seed=0, device=dev)
    spec = EngineSpec(cfg, params, max_len=64, max_batch=2, block_size=8,
                      mesh=make_engine_mesh(4, devices=[dev] * 4),
                      step_graphs=False)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    glob = init_paged_cache(cfg, 4 * S, 4 * B, 64, 8, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    glob["k"].normal_(generator=g)
    glob["v"].normal_(generator=g)
    for s in range(4 * S):
        blk = (s // S) * B + 1 + (s % S)
        glob["block_tab"][s, 0] = blk
        glob["kv_pos"][blk, :5] = torch.arange(5, device=dev)
        glob["cur"][s] = 5
    merged = spec.shard_cache({n: t.clone() for n, t in glob.items()})
    tok = torch.randint(0, cfg.vocab_size, (4 * S, 1), device=dev)
    mask = torch.ones(4 * S, dtype=torch.bool, device=dev)
    n0 = paged_decode_attention.launches
    with count_exchanges() as st:
        lg_s, out_s = spec.masked_decode_fn(merged, tok, mask)
    assert paged_decode_attention.launches - n0 == 4 * cfg.num_layers
    assert st.exchanges == 2 * cfg.num_layers
    lg_1, out_1 = paged_decode_masked(cfg, params, tok, glob, mask)
    assert float((lg_s - lg_1).abs().max()) <= 1e-4
    back = unshard_paged_cache(out_s, dev)
    assert torch.equal(back["cur"], out_1["cur"])


def test_ep_all_to_all_over_distinct_cards():
    """The exchange as peer copies between four cards (skipped with
    fewer): slice g of every source lands on card g."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs")
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.moe_ep import count_exchanges, ep_all_to_all
    mesh = make_engine_mesh(4)
    blocks = [(torch.arange(4 * 1000, dtype=torch.float32).reshape(4, 1000)
               + 10000 * s).to(f"cuda:{s}") for s in range(4)]
    with count_exchanges(timed=True) as st:
        out = ep_all_to_all(blocks, mesh)
    for g in range(4):
        assert out[g].device == torch.device(f"cuda:{g}")
        for s in range(4):
            assert torch.equal(out[g][s].cpu(), blocks[s][g].cpu())
    assert st.exchanges == 1 and st.bytes == 12 * 1000 * 4
    assert st.seconds() > 0


# ---------------------------------------------------------------------------
# Compiled sharded steps: the merged decode graph and the chunk graphs by
# shard, on logical shards of one card and across cards
# ---------------------------------------------------------------------------

def _sharded_spec(devices, dtype=torch.float32, **kw):
    """A sharded spec of reduced granite-moe on a 4-shard mesh over
    `devices` (params made on the mesh's first device)."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.serving.real_engine import EngineSpec
    mesh = make_engine_mesh(4, devices=devices)
    cfg = get_arch("granite-moe-1b-a400m", reduced=True)
    params = init_params(cfg, seed=0, device=mesh.lead, dtype=dtype)
    return EngineSpec(cfg, params, max_len=64, max_batch=2, block_size=8,
                      mesh=mesh, **kw)


def _sharded_case(spec, seed):
    """A merged cache whose rows (one idle a shard) hold random prefixes,
    per-shard feed tokens, and a second cache with the same contents."""
    S = spec.paged_slots
    g = torch.Generator().manual_seed(seed)
    caches = (spec.merged_paged_cache(), spec.merged_paged_cache())
    for shards in zip(*(c["shards"] for c in caches)):
        k = torch.randn(shards[0]["k"].shape, generator=g) * 0.5
        v = torch.randn(shards[0]["v"].shape, generator=g) * 0.5
        tab = torch.full(shards[0]["block_tab"].shape, -1, dtype=torch.int32)
        kvp = torch.full(shards[0]["kv_pos"].shape, -1, dtype=torch.int32)
        cur = torch.zeros(S, dtype=torch.int32)
        for s in range(S - 1):
            L = int(torch.randint(1, 24, (), generator=g))
            blocks = [1 + 3 * s + j for j in range(-(-L // 8))]
            tab[s, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
            for t in range(L):
                kvp[blocks[t // 8], t % 8] = t
            cur[s] = L
        for c in shards:
            dev = c["k"].device
            c["k"].copy_(k.to(c["k"].dtype))
            c["v"].copy_(v.to(c["v"].dtype))
            c["block_tab"] = tab.to(dev)
            c["kv_pos"].copy_(kvp.to(dev))
            c["cur"] = cur.to(dev)
    toks = [torch.randint(0, spec.cfg.vocab_size, (S, 1), generator=g,
                          dtype=torch.int32).to(d)
            for d in spec.mesh.devices]
    return caches[0], caches[1], toks


def _same_cache(a, b):
    for x, y in zip(a["shards"], b["shards"]):
        for name in ("k", "v", "kv_pos", "cur", "block_tab"):
            assert torch.equal(x[name], y[name]), name


def _staged_chunk(spec, cache, k):
    """`cache` with shard k's idle row installed at cursor 0 over two
    fresh blocks: (cache, global slot)."""
    from repro_torch.models.model import paged_clear_rows, paged_install_row
    from repro_torch.serving.kv_pool import pad_block_table
    S, B = spec.paged_slots, spec.paged_pool_blocks
    tab = torch.tensor(pad_block_table([k * B + 10, k * B + 11], spec.nbt),
                       dtype=torch.int32, device=spec.device)
    cache = paged_clear_rows(dict(cache, home=k), tab[:2])
    cache.pop("home")
    slot = k * S + S - 1
    return paged_install_row(cache, slot, tab, 0), slot


def _check_sharded_graphs(spec, steps=3):
    """Merged decode steps and a chunk on each shard, replayed against the
    eager steps on a copy of the cache: bit-identical logits and caches,
    and the wrapper launches and EP exchanges counted through replays."""
    from repro_torch.models.moe_ep import count_exchanges
    runner = spec.step_graphs_for()
    graph_c, eager_c, toks = _sharded_case(spec, 5)
    mask = [torch.arange(spec.paged_slots, device=d) % 3 != 1
            for d in spec.mesh.devices]
    key = ("decode", "merged")
    L = spec.cfg.num_layers
    runner.prepare(key, spec.masked_decode_fn, graph_c, token=toks,
                   mask=mask)
    for _ in range(steps):
        n0 = paged_decode_attention.launches
        with count_exchanges() as ex:
            lg_g, graph_c = runner.run(key, spec.masked_decode_fn, graph_c,
                                       token=toks, mask=mask)
        assert paged_decode_attention.launches - n0 == 4 * L
        assert ex.exchanges == 2 * L and ex.bytes > 0
        with count_exchanges() as ex_e:
            lg_e, eager_c = spec.masked_decode_fn(eager_c, toks, mask)
        assert (ex_e.exchanges, ex_e.bytes) == (ex.exchanges, ex.bytes)
        assert torch.equal(lg_g, lg_e)
        _same_cache(graph_c, eager_c)
        toks = [t.argmax(-1, keepdim=True).to(torch.int32).to(d)
                for t, d in zip(lg_g.split(spec.paged_slots),
                                spec.mesh.devices)]
    assert runner.replays == steps and runner.captured == 1
    for k in range(4):
        graph_c, slot = _staged_chunk(spec, graph_c, k)
        eager_c, _ = _staged_chunk(spec, eager_c, k)
        ids = torch.randint(0, spec.cfg.vocab_size, (1, 16),
                            generator=torch.Generator().manual_seed(k),
                            dtype=torch.int32).to(spec.device)
        n0 = paged_prefill_attention.launches
        lg_g, graph_c = spec.paged_prefill(runner, ids, graph_c, slot)
        lg_g, graph_c = spec.paged_prefill(runner, ids[:, :8], graph_c,
                                           slot)
        assert paged_prefill_attention.launches - n0 == 2 * L
        lg_e, eager_c = spec.paged_prefill(None, ids, eager_c, slot)
        lg_e, eager_c = spec.paged_prefill(None, ids[:, :8], eager_c, slot)
        assert torch.equal(lg_g, lg_e)
        _same_cache(graph_c, eager_c)
    assert ("prefill", 3, 16) in runner._entries
    return runner


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_graphs_match_eager_on_logical_shards(dev, dtype):
    """On four logical shards of one card each step is ONE graph (no
    move crosses devices), bit-identical to the eager step."""
    runner = _check_sharded_graphs(_sharded_spec([dev] * 4, dtype))
    assert all(len(g) == 1 and not c for e in runner._entries.values()
               for g, c in e.segments)
    assert all(len(e.segments) == 1 for e in runner._entries.values())


def test_sharded_capture_has_no_host_sync(dev):
    spec = _sharded_spec([dev] * 4, torch.bfloat16)
    runner = spec.step_graphs_for()
    cache, _c, toks = _sharded_case(spec, 6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.prepare(("decode", "merged"), spec.decode_fn, cache,
                       token=toks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert runner.captured == 1


def test_sharded_replay_after_a_swapped_shard_pool_raises(dev):
    spec = _sharded_spec([dev] * 4)
    runner = spec.step_graphs_for()
    cache, _c, toks = _sharded_case(spec, 7)
    key = ("decode", "merged")
    _lg, cache = runner.run(key, spec.decode_fn, cache, token=toks)
    for name in ("k", "v", "kv_pos"):
        shards = list(cache["shards"])
        shards[1] = dict(shards[1], **{name: shards[1][name].clone()})
        with pytest.raises(RuntimeError, match="of shard 1 is not the"):
            runner.run(key, spec.decode_fn, dict(cache, shards=shards),
                       token=toks)
    w = spec.params["layers"][0]["moe"]["w_down"]
    old = w.shards[2]
    w.shards[2] = old.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            runner.run(key, spec.decode_fn, cache, token=toks)
    finally:
        w.shards[2] = old
    assert runner.replays == 1


@pytest.mark.parametrize("cards", [2, 4])
def test_segmented_sharded_graphs_across_cards(cards):
    """With the shards on `cards` cards each step is captured in segments
    (one graph a card between the moves that cross cards), and still
    agrees with the eager step bit for bit (skipped with fewer cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} NVIDIA GPUs")
    devices = [f"cuda:{i * cards // 4}" for i in range(4)]
    runner = _check_sharded_graphs(_sharded_spec(devices))
    entry = runner._entries[("decode", "merged")]
    n_moe = sum("moe" in p for p in runner.params["layers"])
    # a cut at each exchange (2 an MoE layer) and at the logits' return
    assert len(entry.segments) == 2 * n_moe + 2
    assert all(len(g) == cards for g, _c in entry.segments)
    assert sum(len(c) for _g, c in entry.segments) > 0


# ---------------------------------------------------------------------------
# a hybrid's per-slot SSM state beside paged K/V, through the graphs
# ---------------------------------------------------------------------------

def _hybrid_join(cfg, params, cache, slot, tab, L, g, dev, dtype, max_len):
    """Prefill a random prompt of L tokens densely (16-token chunks) and
    join it into `slot` of the paged cache over the table row `tab`."""
    from repro_torch.models.model import paged_cache_join
    one = init_cache(cfg, 1, max_len, dtype=dtype, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, L), generator=g)
    for at in range(0, L, 16):
        _, one = prefill_chunk(cfg, params, ids[:, at:at + 16].to(dev), one)
    return paged_cache_join(cfg, cache, one, slot, tab)


def _same_entries(a, b):
    for name in ("k", "v", "kv_pos", "cur", "block_tab", "ssm", "conv_x",
                 "conv_bc"):
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "jamba-hybrid"])
def test_paged_hybrid_decode_graph_matches_eager_on_cuda(dev, dtype, arch):
    """Reduced jamba (and the MoE-free hybrid) on a paged cache whose
    SSM layers keep per-slot state: four decode steps replayed from a
    CUDA graph, each reading the state the last one returned, against
    the same steps run eagerly on a copy of the cache: bit-identical
    logits, pools, cursors and SSM states; then a replay after a
    swapped SSM weight raises."""
    import dataclasses
    from repro_torch.config.base import LayerKind
    from repro_torch.models.model import init_paged_cache, paged_decode_step
    cfg = get_arch("jamba-v0.1-52b", reduced=True)
    if arch == "jamba-hybrid":
        cfg = dataclasses.replace(cfg, layer_pattern=(LayerKind.SSM,
                                                      LayerKind.DENSE))
    params = _to(init_params(cfg, seed=0, device="cpu", dtype=dtype), dev)
    cache = init_paged_cache(cfg, 4, 4 * 6 + 1, 96, 16, dtype=dtype,
                             device=dev)
    g = torch.Generator().manual_seed(4)
    for b, L in enumerate([70, 21, 0, 40]):
        if L:
            tab = torch.arange(1 + 6 * b, 7 + 6 * b, dtype=torch.int32,
                               device=dev)
            cache = _hybrid_join(cfg, params, cache, b, tab, L, g, dev,
                                 dtype, 96)
    assert "ssm" in cache

    def fn(c, token):
        return paged_decode_step(cfg, params, token, c)
    tok = torch.tensor([[3], [5], [7], [11]], dtype=torch.int32, device=dev)
    eager = {k: v.clone() for k, v in cache.items()}
    runner = _graph_runner(params, dev)
    for _ in range(4):
        before = cache["ssm"].clone()
        lg_e, eager = fn(eager, tok)
        lg_g, new = runner.run(("decode", 0), fn, cache, token=tok)
        assert torch.equal(cache["ssm"], before)       # the snapshot kept
        cache = new
        assert torch.equal(lg_g, lg_e)
        _same_entries(cache, eager)
        tok = lg_e.argmax(-1).to(torch.int32)[:, None]
    assert runner.captured == 1 and runner.replays == 4
    mp = params["layers"][0]["mamba"]
    name = next(iter(mp))
    w = mp[name]
    mp[name] = w.clone()
    try:
        with pytest.raises(RuntimeError, match="weights"):
            runner.run(("decode", 0), fn, cache, token=tok)
    finally:
        mp[name] = w
    assert runner.replays == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_hybrid_graph_matches_eager_on_logical_shards(dev, dtype):
    """Reduced jamba on the sharded plane over four logical shards of the
    card: the merged decode step (masked, one row of three masked out)
    replayed from ONE graph against the eager step, three times:
    bit-identical logits and shards (SSM states included; a masked-out
    row's state kept), the SSM_MOE layer's two EP exchanges counted
    through each replay."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.moe_ep import count_exchanges
    from repro_torch.serving.real_engine import EngineSpec
    mesh = make_engine_mesh(4, devices=[dev] * 4)
    cfg = get_arch("jamba-v0.1-52b", reduced=True)
    params = init_params(cfg, seed=0, device=mesh.lead, dtype=dtype)
    spec = EngineSpec(cfg, params, max_len=64, max_batch=2, block_size=8,
                      mesh=mesh)
    S, B = spec.paged_slots, spec.paged_pool_blocks
    g = torch.Generator().manual_seed(5)
    caches = [spec.merged_paged_cache(), spec.merged_paged_cache()]
    for k in range(4):
        for s in range(S - 1):
            L = int(torch.randint(1, 24, (), generator=g))
            tab = spec.table([k * B + 1 + 3 * s + j
                              for j in range(-(-L // 8))])
            state = g.get_state()
            for i, c in enumerate(caches):
                g.set_state(state)
                caches[i] = _hybrid_join(cfg, spec.params, c, k * S + s,
                                         tab, L, g, dev, dtype, 64)
    graph_c, eager_c = caches
    toks = [torch.randint(0, cfg.vocab_size, (S, 1), generator=g,
                          dtype=torch.int32).to(dev) for _ in range(4)]
    mask = [torch.arange(S, device=dev) % 3 != 1 for _ in range(4)]
    runner = spec.step_graphs_for()
    key = ("decode", "merged")
    runner.prepare(key, spec.masked_decode_fn, graph_c, token=toks,
                   mask=mask)
    for _ in range(3):
        kept = [c["ssm"][:, 1].clone() for c in graph_c["shards"]]
        with count_exchanges() as ex:
            lg_g, graph_c = runner.run(key, spec.masked_decode_fn, graph_c,
                                       token=toks, mask=mask)
        assert ex.exchanges == 2 and ex.bytes > 0
        lg_e, eager_c = spec.masked_decode_fn(eager_c, toks, mask)
        assert torch.equal(lg_g, lg_e)
        for a, b, old in zip(graph_c["shards"], eager_c["shards"], kept):
            _same_entries(a, b)
            assert torch.equal(a["ssm"][:, 1], old)
        toks = [t.argmax(-1, keepdim=True).to(torch.int32)
                for t in lg_g.split(S)]
    assert runner.replays == 3 and runner.captured == 1
    entry = runner._entries[key]
    assert len(entry.segments) == 1 and len(entry.segments[0][0]) == 1


# ---------------------------------------------------------------------------
# the training path: the autograd Functions of #2 and #4, the Trainer
# ---------------------------------------------------------------------------

# (B, S, H, K, hd, causal, packed, window): PERF.md §6's rows of #2's
# contiguous entry (deepseek-7b's hd 128, h2o-danube's hd 120 with its
# window, whisper's encoder not causal at hd 64, internvl2-1b's G = 7)
# and the training forward's (minicpm-2b: 36 heads of 64)
_FLASH_TRAIN_CASES = [
    (2, 256, 32, 32, 128, True, True, 0),
    (2, 256, 32, 8, 120, True, False, 96),
    (2, 300, 20, 20, 64, False, False, 0),
    (2, 200, 14, 2, 64, True, True, 0),
    (2, 512, 36, 36, 64, True, False, 0),
]


def _flash_train_case(B, S, H, K, hd, packed, dev, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g) * 0.5
    k = torch.randn(B, S, K, hd, generator=g) * 0.5
    v = torch.randn(B, S, K, hd, generator=g) * 0.5
    do = torch.randn(B, S, H, hd, generator=g)
    pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    seg = torch.zeros(B, S, dtype=torch.int32)
    if packed:                     # two documents and a padded tail
        seg[:, S // 3:] = 1
        pos[:, S // 3:] -= S // 3
        seg[1, S - 17:] = -1
    return ([t.to(dev, dtype) for t in (q, k, v)], do.to(dev),
            [t.to(dev) for t in (pos, seg)])


def _grads_close(got, ref, tol):
    """Each gradient within `tol` of its reference's largest magnitude."""
    for a, b in zip(got, ref):
        assert a is not None and torch.isfinite(a).all()
        d = float((a.float() - b.float()).abs().max())
        assert d <= tol * float(b.abs().max()), (d, float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_TRAIN_CASES,
                         ids=lambda c: "B{}S{}H{}K{}hd{}c{}p{}w{}".format(*c))
def test_flash_prefill_train_grads_on_cuda(dev, dtype, case):
    """#2's autograd Function on the card (kernel forward, torch-ops
    backward) against autograd through the plain version on the same
    inputs widened to fp32: q, k and v gradients within 1e-4 (fp32) or
    1e-2 (bf16) of each one's largest; one kernel launch a forward."""
    from repro_torch.kernels.flash_prefill import flash_prefill_train
    B, S, H, K, hd, causal, packed, window = case
    (q, k, v), do, (pos, seg) = _flash_train_case(B, S, H, K, hd, packed,
                                                  dev, dtype)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    n = flash_prefill.launches
    out = flash_prefill_train(*ins, pos, pos, seg, seg, causal, window)
    assert flash_prefill.launches == n + 1
    got = torch.autograd.grad(out, ins, do.to(dtype))
    ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = flash_prefill_plain(*ref_in, pos, pos, seg, seg, causal, window)
    want = torch.autograd.grad(ref, ref_in, do)
    _assert_close(out.detach(), ref.detach(), dtype)
    _grads_close(got, want, REL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssd_chunk_train_grads_on_cuda(dev, dtype, arch):
    """#4's autograd Function on the card against autograd through its
    plain version, at the full-width config's SSD shape (two 256-token
    chunks, or jamba's 128 heads of 64 over d_state 16): every input's
    gradient within 1e-4 (fp32) or 1e-2 (bf16) of its largest."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_train
    from repro_torch.models.mamba import ssm_dims
    cfg = get_arch(arch)
    _di, nh, _ = ssm_dims(cfg.d_model, cfg.ssm)
    hp, ds, Q = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk_size
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.randn(1, 2, Q, nh, hp, generator=g) * 0.3).to(dev, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(1, 2, Q, nh, generator=g) - 2).to(dev)
    A = -torch.exp(torch.linspace(0, 1, nh)).to(dev)
    bc = (torch.randn(1, 2, Q, 2 * ds, generator=g) * 0.3).to(dev, dtype)
    Bm, Cm = bc[..., :ds], bc[..., ds:]
    dy = torch.randn(1, 2, Q, nh, hp, generator=g).to(dev)
    dst = torch.randn(1, 2, nh, hp, ds, generator=g).to(dev)
    ins = [t.detach().requires_grad_(True) for t in (x, dt, A, bc)]
    n = ssd_chunk.launches
    y, st = ssd_chunk_train(ins[0], ins[1], ins[2], ins[3][..., :ds],
                            ins[3][..., ds:])
    assert ssd_chunk.launches == n + 1
    got = torch.autograd.grad((y, st), ins, (dy, dst))
    ref_in = [t.detach().float().requires_grad_(True) for t in (x, dt, A, bc)]
    ry, rst = ssd_chunk_plain(ref_in[0], ref_in[1], ref_in[2],
                              ref_in[3][..., :ds], ref_in[3][..., ds:])
    want = torch.autograd.grad((ry, rst), ref_in, (dy, dst))
    _grads_close(got, want, REL_TOL[dtype])


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "jamba-v0.1-52b"])
def test_reduced_trainer_on_cuda(dev, arch):
    """A reduced dense, MoE, SSM and hybrid model trains on the card: one
    `forward_train` gives every parameter a finite, non-None gradient
    with #2 (attention layers) and #4 (SSM layers) launched, then three
    `Trainer` steps keep the loss finite and lower it."""
    from repro_torch.data import synthetic_batches
    from repro_torch.config.base import TrainConfig
    from repro_torch.models.model import forward_train
    from repro_torch.train import Trainer
    from repro_torch.train.optimizer import tree_leaves
    cfg = get_arch(arch, reduced=True)
    params = init_params(cfg, seed=0, device=dev)
    data = next(synthetic_batches(cfg.vocab_size, 2, 64, seed=0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    n_fp, n_ssd = flash_prefill.launches, ssd_chunk.launches
    loss, _ = forward_train(cfg, params, batch)
    kinds = {k.value for k in cfg.layer_kinds()}
    assert (flash_prefill.launches > n_fp) == bool(kinds & {"dense", "moe"})
    assert (ssd_chunk.launches > n_ssd) == bool(kinds & {"ssm", "ssm_moe"})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    tcfg = TrainConfig(global_batch=2, seq_len=64, lr=1e-3, warmup_steps=1,
                       total_steps=4)
    tr = Trainer(cfg, tcfg, device=dev, params=params)
    ces = []
    for _ in range(3):
        tr.fit(iter([data]), 1, log_every=0)
        ces.append(float(tr.last_metrics["ce"]))
        assert torch.isfinite(tr.last_metrics["grad_norm"])
    assert ces[-1] < ces[0]
