#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout; needs a card

Phases (any failure exits non-zero and prints no result):
  1. build the CUDA kernels of `src/repro_torch/csrc` (sm_90a) and print
     the build time;
  2. paged decode attention (kernel #1, split-K over pages) against its
     plain PyTorch version at the serving path's shapes (H=K=32, hd=128,
     bs=16, bf16) and at G>1 (H=32, K=8): ragged live lengths, rows whose
     table is all -1, garbage in the null block; and at the split
     design's edges (rows of 1 token, 1 page, mid-page and the full
     68-entry table, so that some splits are empty; an all -1 row, which
     must be exactly 0; G = 1, 4 and 8; hd 64 and 128; bf16 and fp32);
  3. dense decode attention (kernel #3, split-K over the cache) against
     its plain version: the padded plane's shape (4 rows of 1088,
     H=K=32, hd=128, mixed live lengths and an idle row) in bf16 and
     fp32, G=4 (H=32, K=8), and a wrapped sliding-window ring (pos > S,
     window = S) with a row that has no valid key; and at the split
     design's edges (S = 4096 with rows that end mid-split, a window
     whose edge falls inside a split, wrapped rings cut by the splits,
     one-token rows, an empty row that must be exactly 0; G = 1 and 4,
     hd 64 and 128, bf16 and fp32);
  4. flash prefill (kernel #2: tensor cores in bf16, FMA in fp32), both
     entries, against their plain versions: the paged entry with a chunk
     that starts mid-page over a prefix read through shared pages, the
     contiguous entry on packed segments with padding and at
     `attn_extend`'s shape (one 256-token chunk inside a 1088-long cache
     whose tail is empty); and at the tensor-core design's edges: ragged
     chunks of 117, 199 and 240 tokens, rows whose K/V tiles are all
     skipped (an all -1 table, an empty cache: exactly 0), wrapped
     sliding-window rings with a window, G = 1 and 4, hd 64 and 128,
     and packed segments that one warp or key tile spans while every
     key passes the position masks (448 one-token segments at position
     0; chunks that start at nonzero positions);
  5. mixed serve: full-width deepseek-7b (random bf16 weights from a
     seed) behind `RealSBSServer` (unified mixed-batch plane, sbs-la, 2
     DP units, 16-token pages) answers 8 requests of 128-1024 prompt
     tokens and 16-32 new tokens; every request must finish, the pools
     must drain, kernels #1 and #2 (paged entry) must have launched, and
     each request's first-token logits must agree with a plain dense
     forward;
  5b. the SSD intra-chunk kernel (kernel #4) against its plain version:
     full-width mamba2-370m's 256-token chunk (32 heads of 64, d_state
     128) in bf16 and fp32, a ragged chunk padded with dt = 0, B·nc > 1,
     the SSM shapes of reduced mamba2-370m, full-width and reduced
     jamba-v0.1-52b, and the redesign's edges (Q = 1, 63, 64, 65 and
     ragged lengths, odd head counts, every (hp, ds)); at the served
     shape the kernel must equal the plain version bit for bit;
  6. P/D serve: the same model and requests behind the P/D-separated
     `RealSBSServer` on the padded plane (2 prefill instances with
     256-token chunks, 1 decode instance of 2 DP units × 4 rows of 1088
     tokens, sbs-la); the same checks, with kernels #3 and #2
     (contiguous entry) launched;
  6b. SSM serve: full-width mamba2-370m (48 SSM layers, random bf16
     weights from seed 0) behind the same P/D deployment with the same 8
     requests; every request finishes, the decode rows drain, kernel #4
     launches (once per layer per prefill chunk), and each first-token
     logits row agrees with a plain forward over the whole prompt
     through `ssd_chunked` (no kernel) that crosses the prefill chunk
     boundaries the serve used (its error against a one-pass forward is
     printed, not checked: bf16 logits depend on those boundaries); the
     error is also printed on a line of its own beside the recorded
     sensitivity of the check to a 1e-7 perturbation of kernel #4;
  7. report: one JSON line per serve (TTFT/ITL, launches per step, a
     profile of device time by kernel group and the idle share), the
     P/D and SSM serves' figures each on a line of its own, one JSON
     line with the kernels (device and wall time per call, launches on
     their path's serve, bound), the card's name and power limit, and
     the contract line last.

Launch counts are set to 0 just before each serve and read just after,
so each kernel's `launches` is its count on its own path's serve.

The kernels are timed with CUDA events over calls that rotate through
several copies of the inputs (more than the 50 MB L2), as a serving step
finds them cold, twice (`time_ms`): `wall_ms` over calls the host issues
back to back, so a call costs the larger of its host issue and its
device time, and `ms` over the same calls queued behind a device-side
spin, so the events time only the card.  `bound_ms` is the larger of the
bytes the call must move over 3.35 TB/s and its flops over 989 TFLOP/s
(bf16 dense), counted from this run's inputs.  `library_ms` and
`library_wall_ms` time torch.nn.functional.scaled_dot_product_attention
on the pre-gathered K/V the same two ways, as a yardstick only; the port
never calls it.  The SSD kernel has none (null): no single PyTorch call
computes its function.
"""
from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor peak
# A kernel's output is held against its plain version on the same inputs
# by max|out - ref| / max|ref| over each head vector of each token (see
# `rel_err`).  In bf16 the output's own rounding moves an element by up
# to 2^-8 of itself, so under 4e-3 of the vector's largest; a dropped or
# misread page moves a vector by a large share of its size.  In fp32 both sides
# accumulate in fp32 and differ only in summation order.
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LOGITS_REL_TOL = 5e-2              # served vs plain bf16 forward
# what a 1e-7 relative perturbation of the SSD intra-chunk term does to the
# SSM serve's logits check (worst of its 8 prompts; recorded, from
# `scripts/ssm_chunking_sensitivity.py --perturb` on one H100, PERF.md)
SSM_LOGITS_AT_1E7 = 0.1731
BLOCK = 16
MAX_LEN = 1088                     # 1024-token prompts + 32 new, 16-aligned
MAX_BATCH = 4                      # per-DP memory budget (requests × max_len)
N_REQUESTS = 8
PD_CHUNK = 256                     # prefill chunk of the P/D serve


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_SPIN = {}


def _spin_cycles_per_ms() -> float:
    """Device clock cycles per ms of `torch.cuda._sleep`, measured once."""
    import torch
    if "c" not in _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        stop.record()
        torch.cuda.synchronize()
        _SPIN["c"] = 20_000_000 / start.elapsed_time(stop)
    return _SPIN["c"]


def time_ms(fn, n_inputs: int, iters: int = 20):
    """(device ms, wall ms) per call of fn(i), rotating i over n_inputs
    input copies.  Wall: the calls issued back to back by the host and
    timed by events around them, so a call costs the larger of its host
    issue (a wrapper's Python checks, the binding, the launches) and its
    device time.  Device: the same calls queued behind a device-side
    spin long enough for the host to issue all of them, so the events
    time only the card's work."""
    import torch
    for i in range(min(3, n_inputs)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for it in range(iters):
        fn(it % n_inputs)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    wall = start.elapsed_time(stop) / iters
    torch.cuda._sleep(int(_spin_cycles_per_ms() * (2 * host_ms + 2)))
    start.record()
    for it in range(iters):
        fn(it % n_inputs)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, wall


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rel_err(out, ref) -> float:
    """The largest max|out - ref| / max|ref| over the vectors of the last
    axis (one head of one token).  A vector whose reference is all zero
    (a fully masked row) must come out exactly zero, else inf."""
    import torch
    d = (out.float() - ref.float()).abs().amax(-1)
    r = ref.float().abs().amax(-1)
    ratio = torch.where(r > 0, d / r.clamp_min(1e-30),
                        torch.where(d > 0, math.inf, 0.0))
    return float(ratio.max())


def compare(tag, out, ref, errs):
    """Hold a kernel's output against its plain version; appends
    (max_abs_err, max_rel_err) to `errs`, raises past REL_TOL."""
    import torch
    if not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: kernel output is not finite")
    dt = str(out.dtype).replace("torch.", "")
    abs_err = float((out.float() - ref.float()).abs().max())
    rel = rel_err(out, ref)
    print(f"{tag} {dt} max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
          f"(tol {REL_TOL[dt]} per head vector)", flush=True)
    if not rel <= REL_TOL[dt]:
        raise AssertionError(f"{tag} {dt}: max_rel_err {rel}")
    errs.append((abs_err, rel))


def report_timing(tag, r):
    print(f"{tag} timed at {r['shape']}: ms={r['ms']!r} "
          f"wall_ms={r['wall_ms']!r} plain_ms={r['plain_ms']!r} "
          f"library_ms={r['library_ms']!r} "
          f"library_wall_ms={r['library_wall_ms']!r} "
          f"bound_ms={r['bound_ms']!r} ({r['bound_by']})", flush=True)


def copies(t, n):
    return [t] + [t.clone() for _ in range(n - 1)]


# ---------------------------------------------------------------------------
# phase 2: paged decode attention
# ---------------------------------------------------------------------------

def decode_case(H, K, hd, device, seed, dt):
    """Inputs shaped like one serving step of a DP unit: decode_slots rows
    over a pool of MAX_BATCH·MAX_LEN/BLOCK (+1) pages."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = 2 * MAX_BATCH
    nbt = MAX_LEN // BLOCK
    N = MAX_BATCH * MAX_LEN // BLOCK + 1
    # ragged live lengths (pos = index of the token being decoded), two
    # decode_mask'ed rows (pos kept, table all -1)
    pos = [1054, 700, 129, 15, 0, 511, 300, 64]
    masked = {6, 7}
    free = torch.randperm(N - 1, generator=g)[:N - 1].add(1).tolist()
    tab = torch.full((B, nbt), -1, dtype=torch.int32)
    kv_pos = torch.randint(0, 2048, (N, BLOCK), generator=g, dtype=torch.int32)
    kv_pos[0] = torch.randint(0, 64, (BLOCK,), generator=g)   # null garbage
    for b, p in enumerate(pos):
        if b in masked:
            continue
        n_live = p // BLOCK + 1
        n_res = min(n_live + 2, nbt)           # lifetime pages beyond pos
        ids = [free.pop() for _ in range(n_res)]
        tab[b, :n_res] = torch.tensor(ids, dtype=torch.int32)
        for j, phys in enumerate(ids):
            rows = torch.arange(BLOCK, dtype=torch.int32) + j * BLOCK
            # positions past pos are stale entries (masked either way)
            kv_pos[phys] = torch.where(rows <= p, rows,
                                       torch.where(rows % 3 == 0, -1, rows))
    q = (torch.randn(B, H, hd, generator=g) * 0.5).to(dt)
    kp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    vp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    to = dict(device=device)
    return (q.to(**to), kp.to(**to), vp.to(**to), kv_pos.to(**to),
            tab.to(**to), torch.tensor(pos, dtype=torch.int32, **to))


def decode_work(q, k_pool, tab, kv_pos, pos):
    """Bytes and flops the call needs for this data (live pages only)."""
    B, H, hd = q.shape
    K = k_pool.shape[2]
    esz = q.element_size()
    nbt = tab.shape[1]
    nbytes = 2 * q.numel() * esz + tab.numel() * 4 + pos.numel() * 4
    flops = 0
    for b in range(B):
        p = int(pos[b])
        n_blk = min(p // BLOCK + 1, nbt) if p >= 0 else 0
        for j in range(n_blk):
            phys = int(tab[b, j])
            if phys < 0:
                continue
            nbytes += BLOCK * (2 * K * hd * esz + 4)
            kp = kv_pos[phys]
            flops += 4 * hd * H * int(((kp >= 0) & (kp <= p)).sum())
    return nbytes, flops


def paged_rows_case(lens, H, K, hd, device, seed, dt, Sq=None):
    """A pool of MAX_BATCH·MAX_LEN/BLOCK (+1) pages and a 68-entry table
    per row, row b holding positions 0..lens[b]-1 in its first pages (0 =
    a table of -1 only); unallocated pages and the null block hold
    garbage positions.  q is (B, H, hd), or (B, Sq, H, hd) if Sq."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, nbt = len(lens), MAX_LEN // BLOCK
    N = MAX_BATCH * MAX_LEN // BLOCK + 1
    kv_pos = torch.randint(0, 2048, (N, BLOCK), generator=g,
                           dtype=torch.int32)
    tab = torch.full((B, nbt), -1, dtype=torch.int32)
    free = (torch.randperm(N - 1, generator=g) + 1).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // BLOCK)):
            phys = free.pop()
            tab[b, j] = phys
            r = torch.arange(BLOCK, dtype=torch.int32) + j * BLOCK
            kv_pos[phys] = torch.where(r < n, r, -1)
    shape = (B, H, hd) if Sq is None else (B, Sq, H, hd)
    q = (torch.randn(shape, generator=g) * 0.5).to(dt)
    kp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    vp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    to = dict(device=device)
    return q.to(**to), kp.to(**to), vp.to(**to), kv_pos.to(**to), tab.to(**to)


def check_zero(tag, rows):
    """A fully masked row must come out exactly 0."""
    if rows.numel() and float(rows.abs().max()) != 0.0:
        raise AssertionError(f"{tag}: a fully masked row is not exactly 0")


# rows of the redesign's edge cases for kernel #1: 1 token, 1 page,
# mid-page, the full 68-entry table (so that some of a short row's
# splits are empty), an all -1 table (exactly 0), a long row
DECODE_EDGE_LENS = [1, BLOCK, 37, MAX_LEN, 0, 700]


def check_decode(device):
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_splits, paged_decode_attention, paged_decode_attention_plain)
    out = {"errs": []}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device != "cpu" else 132)          # "cpu": a rehearsal
    bf16, fp32 = torch.bfloat16, torch.float32
    for i, (H, K, hd, dt) in enumerate((
            (32, 32, 128, bf16), (32, 32, 128, fp32), (32, 8, 128, bf16),
            (32, 4, 128, bf16), (32, 4, 128, fp32), (16, 16, 64, bf16))):
        lens = DECODE_EDGE_LENS
        q, kp, vp, kvp, tab = paged_rows_case(lens, H, K, hd, device,
                                              80 + i, dt)
        pos = torch.tensor([n - 1 if n else 40 for n in lens],
                           dtype=torch.int32, device=device)
        got = paged_decode_attention(q, kp, vp, kvp, tab, pos)
        ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                           kvp, tab, pos)
        tag = (f"[decode] edges H={H} K={K} hd={hd} rows={lens} "
               f"splits={decode_splits(len(lens), K, tab.shape[1], sms)}")
        check_zero(tag, got[4])
        compare(tag, got, ref, out["errs"])
    for H, K, dt in ((32, 32, torch.bfloat16), (32, 8, torch.bfloat16),
                     (32, 32, torch.float32)):
        q, kp, vp, kvp, tab, pos = decode_case(H, K, 128, device, H + K, dt)
        got = paged_decode_attention(q, kp, vp, kvp, tab, pos)
        ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                           kvp, tab, pos)
        check_zero("[decode] all -1 table", got[(tab < 0).all(dim=1)])
        compare(f"[decode] H={H} K={K}", got, ref, out["errs"])
        if (H, K, dt) != (32, 32, torch.bfloat16):
            continue
        # main-path shape: time kernel, plain and the SDPA yardstick
        n = 4
        kps, vps = copies(kp, n), copies(vp, n)
        out["ms"], out["wall_ms"] = time_ms(lambda i: paged_decode_attention(
            q, kps[i], vps[i], kvp, tab, pos), n, iters=50)
        out["plain_ms"], _ = time_ms(lambda i: paged_decode_attention_plain(
            q, kps[i], vps[i], kvp, tab, pos), n, iters=10)
        from repro_torch.models.attention import gather_paged, gather_paged_pos
        kg = [gather_paged(k, tab).transpose(1, 2).contiguous() for k in kps]
        vg = [gather_paged(v, tab).transpose(1, 2).contiguous() for v in vps]
        kvg = gather_paged_pos(kvp, tab)
        mask = ((kvg >= 0) & (kvg <= pos[:, None]))[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out["library_ms"], out["library_wall_ms"] = time_ms(
            lambda i: sdpa(qs, kg[i], vg[i], attn_mask=mask), n, iters=50)
        nbytes, flops = decode_work(q.cpu(), kp, tab.cpu(), kvp.cpu(),
                                    pos.cpu())
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
        out["shape"] = (f"B={q.shape[0]} H=K=32 hd=128 bs={BLOCK} "
                        f"nbt={tab.shape[1]} N={kp.shape[0]} bf16, "
                        f"live={pos.tolist()}")
    return out


# ---------------------------------------------------------------------------
# phase 3: dense decode attention
# ---------------------------------------------------------------------------

def dense_decode_case(H, K, hd, S, pos, device, seed, dt, window=0,
                      empty=()):
    """Rows of a dense cache as the engines keep them: position t at index
    t % S (a ring once pos >= S), stale positions of an earlier tenant
    past a row's cursor (masked, and past the kernel's early stop), and
    `empty` rows with no valid key at all."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(pos)
    kv_pos = torch.full((B, S), -1, dtype=torch.int32)
    idx = torch.arange(S, dtype=torch.int32)
    for b, p in enumerate(pos):
        if b in empty:
            continue
        if p < S:
            kv_pos[b] = torch.where(idx <= p, idx,
                                    torch.where(idx % 3 == 0, idx, -1))
        else:
            t = torch.arange(p - S + 1, p + 1, dtype=torch.int32)
            kv_pos[b, t % S] = t
    q = (torch.randn(B, H, hd, generator=g) * 0.5).to(dt)
    kc = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    vc = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    to = dict(device=device)
    return (q.to(**to), kc.to(**to), vc.to(**to), kv_pos.to(**to),
            torch.tensor(pos, dtype=torch.int32, **to))


def dense_valid(kv_pos, pos, window):
    v = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        v = v & ((pos[:, None] - kv_pos) < window)
    return v


def dense_decode_work(q, k_cache, kv_pos, pos, window):
    """Bytes and flops the call needs for this data: K/V of the valid
    (live) entries only, the kv_pos of the walked indices, q, out."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    esz = q.element_size()
    valid = dense_valid(kv_pos, pos, window)
    walked = sum(min(S, int(p) + 1) if int(p) >= 0 else 0 for p in pos)
    n_valid = int(valid.sum())
    nbytes = (2 * q.numel() * esz + pos.numel() * 4 + walked * 4
              + n_valid * 2 * K * hd * esz)
    return nbytes, 4 * hd * H * n_valid


def check_dense_decode(device):
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, dense_splits)
    out = {"errs": []}
    S = MAX_LEN
    main_pos = [1087, 700, 129, 40]     # row 3: an idle slot's garbage row
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = (
        ("padded rows", 32, 32, S, main_pos, 0, (), bf16, 128),
        ("padded rows", 32, 32, S, main_pos, 0, (), fp32, 128),
        ("G=4", 32, 8, S, [1000, 333, 64, 7], 0, (), bf16, 128),
        ("G=4", 32, 8, S, [1000, 333, 64, 7], 0, (), fp32, 128),
        ("wrapped ring, one empty row", 32, 8, 512, [1500, 700, 511, 2047],
         512, (3,), bf16, 128),
        ("wrapped ring, one empty row", 32, 8, 512, [1500, 700, 511, 2047],
         512, (3,), fp32, 128),
    )
    # the split-K design's edges: S up to 4096 with rows that end
    # mid-split, a window whose edge falls inside a split, wrapped rings
    # cut by the splits, one-token rows; row 4 has no valid key (exactly
    # 0); G = 1 and 4, hd 64 and 128
    edges = (
        ("long rows", 4096, 0, [4095, 2050, 127, 1000, 9]),
        ("window across splits", S, 100, [1087, 700, 300, 129, 9]),
        ("wrapped ring", 520, 520, [1500, 777, 519, 2047, 9]),
        ("one-token rows", S, 0, [0, 0, 1, 16, 9]),
    )
    for j, (name, S_, window, pos) in enumerate(edges):
        for H, K, hd, dt in ((32, 32, 128, bf16), (32, 8, 128, bf16),
                             (16, 4, 64, fp32)):
            cases += ((f"edges {name} hd={hd}", H, K, S_, pos, window, (4,),
                       dt, hd),)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device != "cpu" else 132)          # "cpu": a rehearsal
    for i, (tag, H, K, S_, pos, window, empty, dt, hd) in enumerate(cases):
        q, kc, vc, kvp, posn = dense_decode_case(H, K, hd, S_, pos, device,
                                                 40 + i, dt, window, empty)
        got = decode_attention(q, kc, vc, kvp, posn, window)
        ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                     posn, window)
        label = (f"[dense decode] {tag} H={H} K={K} S={S_} window={window} "
                 f"splits={dense_splits(len(pos), K, S_, sms)}")
        for b in empty:
            check_zero(label, got[b])
        compare(label, got, ref, out["errs"])
    # time the padded plane's shape (bf16)
    q, kc, vc, kvp, posn = dense_decode_case(32, 32, 128, S, main_pos,
                                             device, 40, bf16)
    n = 4
    kcs, vcs = copies(kc, n), copies(vc, n)
    out["ms"], out["wall_ms"] = time_ms(lambda i: decode_attention(
        q, kcs[i], vcs[i], kvp, posn), n, iters=50)
    out["plain_ms"], _ = time_ms(lambda i: decode_attention_plain(
        q, kcs[i], vcs[i], kvp, posn), n, iters=10)
    kt = [k.transpose(1, 2).contiguous() for k in kcs]
    vt = [v.transpose(1, 2).contiguous() for v in vcs]
    mask = dense_valid(kvp, posn, 0)[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"], out["library_wall_ms"] = time_ms(
        lambda i: sdpa(qs, kt[i], vt[i], attn_mask=mask), n, iters=50)
    nbytes, flops = dense_decode_work(q.cpu(), kc, kvp.cpu(), posn.cpu(), 0)
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = (f"B=4 S={S} H=K=32 hd=128 bf16, pos={main_pos} "
                    f"(bound: K/V of valid entries only)")
    return out


# ---------------------------------------------------------------------------
# phase 4: flash prefill, both entries
# ---------------------------------------------------------------------------

def paged_prefill_case(H, K, hd, device, seed, rows, dt):
    """`rows` = [(pos0, Sc)]: each row's chunk starts mid-page at pos0 and
    its first pages are SHARED with row 0's (a prefix read through shared
    pages); every row also owns private pages up to its chunk's end."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    nbt = MAX_LEN // BLOCK
    N = MAX_BATCH * MAX_LEN // BLOCK + 1
    B = len(rows)
    Sc = max(sc for _p, sc in rows)
    free = torch.randperm(N - 1, generator=g).add(1).tolist()
    shared = [free.pop() for _ in range(rows[0][0] // BLOCK)]
    tab = torch.full((B, nbt), -1, dtype=torch.int32)
    kv_pos = torch.full((N, BLOCK), -1, dtype=torch.int32)
    kv_pos[0] = torch.randint(0, 64, (BLOCK,), generator=g)   # null garbage
    positions = torch.zeros(B, Sc, dtype=torch.int32)
    for b, (p0, sc) in enumerate(rows):
        n_sh = min(len(shared), p0 // BLOCK)
        n_all = min((p0 + Sc - 1) // BLOCK + 2, nbt)
        ids = shared[:n_sh] + [free.pop() for _ in range(n_all - n_sh)]
        tab[b, :n_all] = torch.tensor(ids, dtype=torch.int32)
        for j, phys in enumerate(ids):
            r = torch.arange(BLOCK, dtype=torch.int32) + j * BLOCK
            kv_pos[phys] = torch.where(r < p0 + sc, r, -1)
        # a shorter chunk pads with repeats of its last position
        positions[b] = (p0 + torch.arange(Sc)).clamp(max=p0 + sc - 1)
    q = (torch.randn(B, Sc, H, hd, generator=g) * 0.5).to(dt)
    kp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    vp = (torch.randn(N, BLOCK, K, hd, generator=g) * 0.5).to(dt)
    to = dict(device=device)
    return (q.to(**to), kp.to(**to), vp.to(**to), kv_pos.to(**to),
            tab.to(**to), positions.to(**to))


def attention_work(q, kv_rows_bytes, pairs, out_bytes, extra=0):
    H, hd = q.shape[2], q.shape[3]
    nbytes = q.numel() * q.element_size() + kv_rows_bytes + out_bytes + extra
    return nbytes, 4 * hd * H * pairs


def paged_prefill_work(q, k_pool, kv_pos, tab, positions):
    from repro_torch.models.attention import gather_paged_pos
    K, hd = k_pool.shape[2], k_pool.shape[3]
    esz = q.element_size()
    kvg = gather_paged_pos(kv_pos, tab)
    pairs = int(((kvg[:, None, :] >= 0)
                 & (kvg[:, None, :] <= positions[:, :, None])).sum())
    n_pages = 0
    for b in range(tab.shape[0]):
        last = int(positions[b].max()) // BLOCK + 1
        n_pages += int((tab[b, :last] >= 0).sum())
    kv_bytes = n_pages * BLOCK * (2 * K * hd * esz + 4)
    return attention_work(q, kv_bytes, pairs, q.numel() * esz,
                          extra=tab.numel() * 4 + positions.numel() * 4)


def check_paged_prefill(device):
    import torch
    from repro_torch.kernels.flash_prefill import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from repro_torch.models.attention import (
        build_mask, gather_paged, gather_paged_pos)
    out = {"errs": []}
    # the redesign's edges: ragged chunks (117, 199, 240 tokens) starting
    # mid-page at a long position, a shorter row padded with repeats of
    # its last position, and a row whose table is all -1 (every K/V tile
    # skipped, output exactly 0); G = 1 and 4, hd 64 and 128
    bf16, fp32 = torch.bfloat16, torch.float32
    for i, (Sc, H, K, hd, dt) in enumerate((
            (117, 32, 32, 128, bf16), (199, 32, 8, 128, bf16),
            (240, 32, 8, 128, fp32), (240, 16, 16, 64, bf16),
            (199, 16, 4, 64, fp32))):
        p0 = 49 * BLOCK + 5
        lens = [p0 + Sc, 300 + Sc - 40, 0]
        q, kp, vp, kvp, tab = paged_rows_case(lens, H, K, hd, device,
                                              90 + i, dt, Sq=Sc)
        posn = torch.stack([(p + torch.arange(Sc)).clamp(max=p + sc - 1)
                            for p, sc in ((p0, Sc), (300, Sc - 40),
                                          (300, Sc))])
        posn = posn.to(torch.int32).to(device)
        got = paged_prefill_attention(q, kp, vp, kvp, tab, posn)
        ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                            kvp, tab, posn)
        tag = f"[paged prefill] edges Sc={Sc} H={H} K={K} hd={hd}"
        check_zero(tag, got[2])
        compare(tag, got, ref, out["errs"])
    two = [(13 * BLOCK + 5, 240), (9 * BLOCK + 11, 117)]
    # the main path's shape: one row, a 240-token chunk at a long position
    one = [(49 * BLOCK + 5, 240)]
    for H, K, rows, dt, seed in ((32, 32, two, bf16, 1024),
                                 (32, 8, two, bf16, 256),
                                 (32, 32, one, fp32, 7),
                                 (32, 32, one, bf16, 7)):
        q, kp, vp, kvp, tab, posn = paged_prefill_case(H, K, 128, device,
                                                       seed, rows, dt)
        got = paged_prefill_attention(q, kp, vp, kvp, tab, posn)
        ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                            kvp, tab, posn)
        compare(f"[paged prefill] H={H} K={K} rows={rows}", got, ref,
                out["errs"])
    # time the last case (bf16, the main path's shape)
    n = 4
    kps, vps = copies(kp, n), copies(vp, n)
    out["ms"], out["wall_ms"] = time_ms(lambda i: paged_prefill_attention(
        q, kps[i], vps[i], kvp, tab, posn), n, iters=30)
    out["plain_ms"], _ = time_ms(lambda i: paged_prefill_attention_plain(
        q, kps[i], vps[i], kvp, tab, posn), n, iters=10)
    kg = [gather_paged(k, tab).transpose(1, 2).contiguous() for k in kps]
    vg = [gather_paged(v, tab).transpose(1, 2).contiguous() for v in vps]
    kvg = gather_paged_pos(kvp, tab)
    mask = build_mask(posn, kvg, causal=True)[:, None]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"], out["library_wall_ms"] = time_ms(
        lambda i: sdpa(qt, kg[i], vg[i], attn_mask=mask), n, iters=30)
    nbytes, flops = paged_prefill_work(q.cpu(), kp, kvp.cpu(), tab.cpu(),
                                       posn.cpu())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = (f"B=1 Sc=240 at pos {49 * BLOCK + 5} H=K=32 hd=128 "
                    f"bs={BLOCK} bf16")
    return out


def packed_case(H, K, hd, device, seed, dt, B=2, S=512, lens=(200, 250),
                starts=(0, 0)):
    """Packed varlen chunk: segment i holds positions starts[i] ..
    starts[i] + lens[i] - 1, then padding, in every row."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    pos = torch.zeros(S, dtype=torch.int32)
    seg = torch.full((S,), -1, dtype=torch.int32)
    at = 0
    for i, (n, p0) in enumerate(zip(lens, starts)):
        pos[at:at + n] = p0 + torch.arange(n, dtype=torch.int32)
        seg[at:at + n] = i
        at += n
    pos = pos.repeat(B, 1)
    seg = seg.repeat(B, 1)
    q = (torch.randn(B, S, H, hd, generator=g) * 0.5).to(dt)
    k = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    v = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    return [t.to(device) for t in (q, k, v, pos, seg)]


def check_flash_prefill(device):
    import torch
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    from repro_torch.models.attention import build_mask
    out = {"errs": []}
    for H, K, dt in ((32, 32, torch.bfloat16), (32, 8, torch.bfloat16),
                     (32, 32, torch.float32)):
        q, k, v, pos, seg = packed_case(H, K, 128, device, H + 3 * K, dt)
        got = flash_prefill(q, k, v, pos, pos, seg, seg)
        ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos,
                                  seg, seg)
        if got[seg < 0].abs().max() != 0:
            raise AssertionError("padding rows of the packed chunk are not 0")
        compare(f"[flash prefill] H={H} K={K} packed 200+250+pad", got, ref,
                out["errs"])
    # warps and key tiles that span several segments, every key valid by
    # position for every query: only the segment mask separates them
    # (448 one-token segments at position 0; four chunks from 0 and four
    # that start past them)
    segs = (("448 one-token segments at 0", [1] * 448, [0] * 448),
            ("chunks at 0,0,0,0,700,300,64,7",
             [16, 16, 16, 16, 100, 120, 90, 60], [0, 0, 0, 0, 700, 300, 64, 7]))
    for H, K, dt in ((32, 32, torch.bfloat16), (32, 8, torch.bfloat16),
                     (32, 32, torch.float32)):
        for name, lens, starts in segs:
            q, k, v, pos, seg = packed_case(H, K, 128, device, H + K, dt,
                                            lens=lens, starts=starts)
            got = flash_prefill(q, k, v, pos, pos, seg, seg)
            ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos,
                                      pos, seg, seg)
            tag = f"[flash prefill] segments H={H} K={K} {name}"
            check_zero(tag, got[seg < 0])
            compare(tag, got, ref, out["errs"])
    # attn_extend's shape: one 256-token chunk at positions 512..767 over
    # a 1088-long dense cache whose tail is empty (the chunk written)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, qp, kvp, qs, ks = extend_case(device, 17, dt)
        got = flash_prefill(q, k, v, qp, kvp, qs, ks)
        ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp, kvp,
                                  qs, ks)
        compare("[flash prefill] attn_extend chunk 256 at 512 of 1088", got,
                ref, out["errs"])
    # the redesign's edges: ragged chunks over a cache with an empty tail,
    # wrapped sliding-window rings (window < S and = S), G = 1 and 4, hd 64
    # and 128; row 1's cache is all empty (every K/V tile skipped, output
    # exactly 0)
    bf16, fp32 = torch.bfloat16, torch.float32
    for i, (Sc, p0, S, window, H, K, hd, dt) in enumerate((
            (117, 40, 320, 0, 32, 32, 128, bf16),
            (199, 0, 264, 0, 32, 8, 128, bf16),
            (240, 512, MAX_LEN, 0, 16, 4, 64, bf16),
            (117, 500, 128, 96, 32, 8, 128, bf16),
            (240, 900, 256, 256, 32, 32, 128, bf16),
            (199, 500, 128, 96, 16, 16, 64, fp32))):
        q, k, v, qp, kvp, qs, ks = extend_case(device, 30 + i, dt, S=S, p0=p0,
                                               Sc=Sc, H=H, K=K, hd=hd, B=2)
        kvp[1] = -1
        got = flash_prefill(q, k, v, qp, kvp, qs, ks, True, window)
        ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp, kvp,
                                  qs, ks, True, window)
        tag = (f"[flash prefill] edges Sq={Sc} at {p0} over S={S} "
               f"window={window} H={H} K={K} hd={hd}")
        check_zero(tag, got[1])
        compare(tag, got, ref, out["errs"])
    q, k, v, qp, kvp, qs, ks = extend_case(device, 17, torch.bfloat16)
    n = 4
    kk, vv = copies(k, n), copies(v, n)
    out["ms"], out["wall_ms"] = time_ms(lambda i: flash_prefill(
        q, kk[i], vv[i], qp, kvp, qs, ks), n, iters=30)
    out["plain_ms"], _ = time_ms(lambda i: flash_prefill_plain(
        q, kk[i], vv[i], qp, kvp, qs, ks), n, iters=10)
    mask = build_mask(qp, kvp, qs, ks, True)
    kt = [t.transpose(1, 2).contiguous() for t in kk]
    vt = [t.transpose(1, 2).contiguous() for t in vv]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"], out["library_wall_ms"] = time_ms(
        lambda i: sdpa(qt, kt[i], vt[i], attn_mask=mask[:, None]), n,
        iters=30)
    esz = q.element_size()
    K, hd = k.shape[2], k.shape[3]
    live = int((kvp >= 0).sum())
    nbytes, flops = attention_work(
        q, live * 2 * K * hd * esz, int(mask.sum()), q.numel() * esz,
        extra=4 * (2 * qp.numel() + 2 * kvp.numel()))
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = ("B=1 Sq=256 at positions 512..767 over Skv=1088 "
                    "(768 live) H=K=32 hd=128 bf16")
    return out


def extend_case(device, seed, dt, S=MAX_LEN, p0=512, Sc=256, H=32, K=32,
                hd=128, B=1):
    """`attn_extend`'s call: q at positions p0..p0+Sc-1, K/V of the whole
    dense cache written up to the chunk's end (position t at index t % S:
    the empty tail of a long cache, a ring once p0 + Sc > S), segments
    all 0."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    qp = (p0 + torch.arange(Sc, dtype=torch.int32)).repeat(B, 1)
    kvp = torch.full((S,), -1, dtype=torch.int32)
    t = torch.arange(max(0, p0 + Sc - S), p0 + Sc, dtype=torch.int32)
    kvp[t % S] = t
    kvp = kvp.repeat(B, 1)
    q = (torch.randn(B, Sc, H, hd, generator=g) * 0.5).to(dt)
    k = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    v = (torch.randn(B, S, K, hd, generator=g) * 0.5).to(dt)
    zq = torch.zeros(B, Sc, dtype=torch.int32)
    zk = torch.zeros(B, S, dtype=torch.int32)
    return [t.to(device) for t in (q, k, v, qp, kvp, zq, zk)]


# ---------------------------------------------------------------------------
# phase 5b: the SSD intra-chunk kernel
# ---------------------------------------------------------------------------

def ssd_case(B, nc, Q, nh, hp, ds, device, seed, dt, pad=0):
    """`ssd_chunked_kernel`'s call: B and C strided slices of one [B|C]
    tensor, dt = softplus(N(0,1)), A = -exp(linspace(0, 1, nh)); the last
    chunk's last `pad` tokens zero with dt = 0, as the caller pads."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, nc, Q, nh, hp, generator=g) * 0.3
    dtv = torch.nn.functional.softplus(torch.randn(B, nc, Q, nh,
                                                   generator=g))
    A = -torch.exp(torch.linspace(0.0, 1.0, nh))
    bc = torch.randn(B, nc, Q, 2 * ds, generator=g) * 0.3
    if pad:
        for t in (x, dtv, bc):
            t[:, -1, Q - pad:] = 0
    bc = bc.to(dt).to(device)
    return (x.to(dt).to(device), dtv.to(device), A.to(device),
            bc[..., :ds], bc[..., ds:])


def ssd_work(x, dt, A, Bm, Cm):
    """Bytes (each input read once, y and the state written once in
    fp32) and flops of the call: C·Bᵀ once per chunk (one group), the
    causal half of y and the state per head."""
    B, nc, Q, nh, hp = x.shape
    ds = Bm.shape[-1]
    BC = B * nc
    esz = x.element_size()
    nbytes = (x.numel() * esz + dt.numel() * 4 + A.numel() * 4
              + 2 * BC * Q * ds * esz
              + BC * Q * nh * hp * 4 + BC * nh * hp * ds * 4)
    pairs = Q * (Q + 1) // 2
    flops = BC * (2 * pairs * ds + nh * (2 * pairs * hp + 2 * Q * hp * ds))
    return nbytes, flops


def check_ssd(device):
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
    out = {"errs": []}
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = (
        ("mamba2-370m full width", 1, 1, 256, 32, 64, 128, 0, bf16),
        ("mamba2-370m full width", 1, 1, 256, 32, 64, 128, 0, fp32),
        ("ragged chunk, 199 of 256 tokens", 1, 1, 256, 32, 64, 128, 57,
         bf16),
        ("B=2 nc=3", 2, 3, 256, 32, 64, 128, 0, bf16),
        ("mamba2-370m reduced", 1, 2, 32, 16, 32, 32, 5, fp32),
        ("jamba-v0.1-52b full width", 1, 1, 256, 128, 64, 16, 0, bf16),
        ("jamba-v0.1-52b reduced", 2, 2, 32, 16, 32, 16, 0, fp32),
        # the redesign's edges: chunk lengths around its 32-token tiles
        # (one token, 63-65, a ragged pair), an odd head count, B·nc > 1
        # with a padded ragged last chunk, every (hp, ds) instantiation
        ("one token", 1, 1, 1, 32, 64, 128, 0, bf16),
        ("Q=63", 1, 1, 63, 32, 64, 128, 0, bf16),
        ("Q=64", 1, 1, 64, 32, 64, 128, 0, bf16),
        ("Q=65 nh=3, padded", 2, 2, 65, 3, 64, 128, 20, bf16),
        ("hp=32 ds=16 nh=5", 1, 2, 100, 5, 32, 16, 7, bf16),
        ("hp=32 ds=64", 1, 1, 256, 8, 32, 64, 0, bf16),
        ("hp=32 ds=128 nh=3", 2, 1, 161, 3, 32, 128, 0, fp32),
        ("hp=64 ds=32", 1, 1, 256, 8, 64, 32, 30, bf16),
        ("hp=64 ds=64 nh=7", 1, 3, 97, 7, 64, 64, 0, fp32),
    )
    for i, (tag, B, nc, Q, nh, hp, ds, pad, dt) in enumerate(cases):
        x, dtv, A, Bm, Cm = ssd_case(B, nc, Q, nh, hp, ds, device, 60 + i,
                                     dt, pad)
        y, st = ssd_chunk(x, dtv, A, Bm, Cm)
        yr, sr = ssd_chunk_plain(x.float(), dtv, A, Bm.float(), Cm.float())
        name = str(dt).replace("torch.", "")
        label = (f"[ssd] {tag} ({name} in) B={B} nc={nc} Q={Q} nh={nh} "
                 f"hp={hp} ds={ds}")
        compare(label + " y", y, yr, out["errs"])
        compare(label + " state", st, sr, out["errs"])
    # the served shape: bit for bit equal to the plain version (the SSM
    # serve's logit check needs it, PERF.md)
    x, dtv, A, Bm, Cm = ssd_case(1, 1, 256, 32, 64, 128, device, 60, bf16)
    y, st = ssd_chunk(x, dtv, A, Bm, Cm)
    yr, sr = ssd_chunk_plain(x, dtv, A, Bm, Cm)
    same = bool(torch.equal(y, yr) and torch.equal(st, sr))
    print(f"[ssd] served shape bf16: bit-identical to the plain version: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("[ssd] served shape differs from the plain "
                             "version")
    # time one full-width 256-token chunk in bf16 (a served prefill chunk
    # of one layer), inputs rotated over copies larger than the L2
    x, dtv, A, Bm, Cm = ssd_case(1, 1, 256, 32, 64, 128, device, 60, bf16)
    n = 40
    xs = copies(x, n)
    bcs = [torch.cat([Bm, Cm], -1).clone() for _ in range(n)]
    ds = Bm.shape[-1]
    out["ms"], out["wall_ms"] = time_ms(lambda i: ssd_chunk(
        xs[i], dtv, A, bcs[i][..., :ds], bcs[i][..., ds:]), n, iters=80)
    out["plain_ms"], _ = time_ms(lambda i: ssd_chunk_plain(
        xs[i], dtv, A, bcs[i][..., :ds], bcs[i][..., ds:]), n, iters=10)
    out["library_ms"] = None      # no single PyTorch call computes it
    out["library_wall_ms"] = None
    out["bound_ms"], out["bound_by"] = bound(*ssd_work(x, dtv, A, Bm, Cm))
    out["shape"] = ("B=1 nc=1 Q=256 nh=32 hp=64 ds=128, x/B/C bf16 "
                    "(B and C strided slices of one [B|C] tensor)")
    return out


# ---------------------------------------------------------------------------
# phases 5, 6 and 6b: serve full-width deepseek-7b and mamba2-370m
# ---------------------------------------------------------------------------

def make_requests(cfg, n, seed, lens=(128, 1024), outs=(16, 32)):
    from repro_torch.core.types import Request
    rng = random.Random(seed)
    plens = [lens[0], lens[1]] + [rng.randrange(lens[0], lens[1] + 1)
                                  for _ in range(n - 2)]
    reqs = []
    for i, L in enumerate(plens):
        reqs.append(Request(
            rid=i, arrival_time=0.05 * i, input_len=L,
            output_len=rng.randrange(outs[0], outs[1] + 1),
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    return reqs


def dense_forward_logits(cfg, params, tokens, device, chunks=None):
    """Last-position logits of a plain dense forward over the prompt:
    projections, RoPE, masked einsum attention, SwiGLU — no pages, no
    kernels.  `chunks` is not needed: without a window ring, attention
    does not depend on prefill chunk boundaries."""
    import torch
    from repro_torch.models.attention import build_mask, gqa_reference
    from repro_torch.models.layers import apply_rope, rms_norm, swiglu
    from repro_torch.models.model import logits_from_hidden
    ids = torch.tensor([list(tokens)], dtype=torch.long, device=device)
    S = ids.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    mask = build_mask(pos, pos, causal=True)
    D, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    x = params["embed"][ids]
    for p in params["layers"]:
        a = p["attn"]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = apply_rope((h @ a["w_q"].reshape(D, -1)).reshape(1, S, H, hd),
                       pos, cfg.rope_theta)
        k = apply_rope((h @ a["w_k"].reshape(D, -1)).reshape(1, S, K, hd),
                       pos, cfg.rope_theta)
        v = (h @ a["w_v"].reshape(D, -1)).reshape(1, S, K, hd)
        o = gqa_reference(q, k, v, mask)
        x = x + o.reshape(1, S, H * hd) @ a["w_o"].reshape(H * hd, D)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        m = p["mlp"]
        x = x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x[0, -1])


def ssm_forward_logits(cfg, params, tokens, device, chunks=None,
                       scan=None):
    """Last-position logits of a plain forward over the whole prompt
    through `ssd_chunked` (the SSD scan in plain torch), with no kernel.
    `chunks` (prefill chunk lengths) makes it cross the boundaries a
    serve used, carrying each layer's SSM state and conv tails across
    them: in bf16 the logits depend on where chunks start (the scan is
    chunked from each prefill chunk's start, and rounding differs); None
    runs the prompt in one pass.  `scan` replaces `ssd_chunked` (the
    sensitivity script's perturbed scans)."""
    import torch
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.mamba import mamba_forward, ssd_chunked
    from repro_torch.models.model import logits_from_hidden
    scan = scan or ssd_chunked
    ids = torch.tensor([list(tokens)], dtype=torch.long, device=device)
    states = [(None, None)] * len(params["layers"])
    at = 0
    for n in chunks or [ids.shape[1]]:
        x = params["embed"][ids[:, at:at + n]]
        for i, p in enumerate(params["layers"]):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            y, states[i] = mamba_forward(h, p["mamba"], cfg.ssm, *states[i],
                                         scan=scan)
            x = x + y
        at += n
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x[0, -1])


def ssm_whole_prompt_logits(cfg, params, tokens, device):
    """`ssm_forward_logits` in one pass, whatever chunks the serve used."""
    return ssm_forward_logits(cfg, params, tokens, device)


def record_first_logits(engine):
    """Observe, without changing the engine, the logits each request's
    first token is sampled from: wraps the engine's `finish_step` to read
    the step's chunk results (one (token, logits) per granted chunk, in
    grant order) for the grants that complete a prompt.  Returns the
    dict {rid: logits} it fills."""
    seen = {}
    inner = engine.finish_step

    def finish_step(now, dp_states):
        cres = engine._chunk_result or {}
        for d, grants in engine._grants.items():
            for (req, use), (_tok, lg) in zip(grants, cres.get(d, [])):
                if engine._consumed[req.rid] + use >= req.input_len:
                    seen[req.rid] = lg
        return inner(now, dp_states)

    engine.finish_step = finish_step
    return seen


def percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    k = (len(xs) - 1) * q
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def record_prefill_logits(srv):
    """Observe, without changing the engines, the logits each request's
    first token is sampled from on the P/D plane: the prefill engines
    call `real_engine.prefill_chunk`, whose result this wraps (keyed by
    the cache it returns), and each engine's `finish_pass` is wrapped to
    pick, for every prompt the pass completes, its context's last chunk
    logits; each engine's `_run_chunk` is wrapped to note the chunk
    lengths each request was prefilled in.  Returns ({rid: logits},
    {rid: [chunk lengths]}, undo)."""
    from repro_torch.serving import real_engine as RE
    seen, last, chunks = {}, {}, {}
    inner_chunk = RE.prefill_chunk

    def prefill_chunk(cfg, params, tokens, cache):
        logits, new = inner_chunk(cfg, params, tokens, cache)
        last[id(new)] = logits[0]
        return logits, new

    for eng in srv.engines:
        def finish_pass(now, _eng=eng, _inner=eng.finish_pass):
            for rid, ctx in _eng._ctx.items():
                if ctx.first_token is not None and rid not in seen:
                    seen[rid] = last.pop(id(ctx.cache))
            return _inner(now)

        def run_chunk(req, tok, _inner=eng._run_chunk):
            chunks.setdefault(req.rid, []).append(tok)
            return _inner(req, tok)
        eng.finish_pass = finish_pass
        eng._run_chunk = run_chunk
    RE.prefill_chunk = prefill_chunk

    def undo():
        RE.prefill_chunk = inner_chunk
    return seen, chunks, undo


def check_served(cfg, params, spec, srv, reqs, gens, first_logits, device,
                 tag, forward=dense_forward_logits, chunks=None,
                 info_forward=None):
    """Every request finished with its tokens, the decode caches drained,
    and each first-token logits agree with a plain forward (`forward`,
    over the chunk boundaries `chunks` the serve used).  `info_forward`,
    if given, is another reference whose error is printed and returned,
    not checked.  Returns (worst max|d|/max|ref|, argmax agreements, the
    worst error against `info_forward` or None)."""
    import torch
    if sorted(g.rid for g in gens) != [r.rid for r in reqs]:
        raise AssertionError(f"{tag}: unfinished requests: {len(gens)} of "
                             f"{len(reqs)} finished")
    for g, r in zip(gens, reqs):
        if len(g.tokens) != spec.target_len(r):
            raise AssertionError(f"{tag} request {r.rid}: {len(g.tokens)} "
                                 f"tokens, expected {spec.target_len(r)}")
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            if spec.paged:
                st.pool.check()
                if st.pool.used_count != 0:
                    raise AssertionError(f"{tag}: the block pools did not "
                                         f"drain")
            if st.occupied():
                raise AssertionError(f"{tag}: the decode slots did not drain")
    prefilled = (sum(e.tokens_processed for e in srv.engines) if srv.engines
                 else sum(e.prefill_tokens for e in srv.decode_engines))
    if prefilled != sum(r.input_len for r in reqs):
        raise AssertionError(f"{tag}: prefill token count mismatch")
    worst = 0.0
    agree = 0
    info = None if info_forward is None else 0.0
    chunks = chunks or {}
    for r in reqs:
        got = first_logits.get(r.rid)
        prompt = r.tokens[:r.input_len]
        ref = forward(cfg, params, prompt, device, chunks.get(r.rid))
        if got is None or got.shape != (cfg.vocab_size,) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"{tag} request {r.rid}: bad first-token "
                                 f"logits")
        rel = float((got.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
        worst = max(worst, rel)
        agree += int(int(got.argmax()) == int(ref.argmax()))
        if info_forward is not None:
            alt = info_forward(cfg, params, prompt, device).float()
            info = max(info, float((got.float() - alt).abs().max()
                                   / alt.abs().max()))
    print(f"{tag} first-token logits vs plain forward: worst "
          f"max|d|/max|ref|={worst:.3e} (tol {LOGITS_REL_TOL}), argmax "
          f"agrees on {agree}/{len(reqs)}", flush=True)
    if info is not None:
        print(f"{tag} (not checked) vs {info_forward.__name__}: worst "
              f"max|d|/max|ref|={info:.3e}", flush=True)
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"{tag}: first-token logits disagree: {worst}")
    return worst, agree, info


def mixed_scfg():
    from repro_torch.config.base import ServingConfig
    return ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=256, t_default=0.05, l_net=0.001,
        max_batch_per_dp=MAX_BATCH, block_size=BLOCK,
        mixed_batch=True, mixed_chunk=256)


def pd_scfg():
    """The P/D serve's deployment.  SBS's flow control rejects a prompt
    that waited more than n_limit × (2 or 3) dispatch cycles; with the
    default n_limit=8 the smoke's burst (8 prompts, about 5,000 tokens
    within 0.35 s, against 2 × 256 tokens per pass) trips it at full
    width, so the serve raises n_limit: every request must be answered
    for the token and logits checks."""
    from repro_torch.config.base import ServingConfig
    return ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=PD_CHUNK, t_default=0.05, l_net=0.001,
        max_batch_per_dp=MAX_BATCH, block_size=0, n_limit=64)


def serve(cfg, params, device, counters, n_requests=N_REQUESTS,
          lens=(128, 1024), outs=(16, 32)):
    """Drive the unified mixed-batch plane; returns the serve report.
    `counters` are the kernel wrappers whose launch counts the run reads
    (set to 0 just before the measured serve).  The size arguments let
    the same code rehearse on the CPU with a reduced config."""
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    scfg = mixed_scfg()
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=BLOCK,
                      decode_slots=scfg.resolved_decode_slots, device=device)
    # warm-up serve (cuBLAS handles, allocator) on its own server
    warm = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
    warm.serve(make_requests(cfg, 2, seed=99, lens=(lens[0], lens[0]),
                             outs=(2, 2)), timeout=300)
    srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
    first_logits = record_first_logits(srv.decode_engines[0])
    reqs = make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs)
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    gens = srv.serve(reqs, timeout=600)
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    worst, agree, _ = check_served(cfg, params, spec, srv, reqs, gens,
                                   first_logits, device, "[serve]")
    eng = srv.decode_engines[0]
    ttft = [g.ttft for g in gens]
    durs = [d for d, _a, _r in eng.step_samples]
    profile = profile_serve(
        lambda: RealSBSServer(cfg, params, scfg, scheduler="sbs-la",
                              spec=spec),
        cfg, n_requests, lens, outs, device)
    return {
        "plane": "unified mixed-batch, paged", "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens], "wall_s": wall,
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(eng.itl, 0.5),
        "itl_p99_s": percentile(eng.itl, 0.99),
        "steps": eng.steps, "mixed_steps": eng.mixed_steps,
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "launches": launches,
        "launches_per_step": {k: v / eng.steps for k, v in launches.items()},
        "logits_rel_err": worst, "argmax_agree": agree, "profile": profile,
    }


def serve_pd(cfg, params, device, counters, n_requests=N_REQUESTS,
             lens=(128, 1024), outs=(16, 32), tag="[pd serve]",
             forward=dense_forward_logits, info_forward=None):
    """Drive the P/D-separated deployment on the padded plane; returns
    the serve report (as `serve`).  `forward` is the plain reference of
    the first-token logits, run over the serve's chunk boundaries;
    `info_forward` an unchecked second one (see `check_served`)."""
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    scfg = pd_scfg()
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=0, device=device)
    warm = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
    warm.serve(make_requests(cfg, 2, seed=99, lens=(lens[0], lens[0]),
                             outs=(2, 2)), timeout=300)
    srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
    first_logits, chunks, undo = record_prefill_logits(srv)
    reqs = make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs)
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    try:
        gens = srv.serve(reqs, timeout=600)
    finally:
        undo()
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    worst, agree, info = check_served(cfg, params, spec, srv, reqs, gens,
                                      first_logits, device, tag, forward,
                                      chunks, info_forward)
    eng = srv.decode_engines[0]
    passes = sum(e.passes for e in srv.engines)
    ttft = [g.ttft for g in gens]
    durs = [d for d, _a, _r in eng.step_samples]
    profile = profile_serve(
        lambda: RealSBSServer(cfg, params, scfg, scheduler="sbs-la",
                              spec=spec),
        cfg, n_requests, lens, outs, device)
    return {
        "plane": "P/D, padded decode", "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens], "wall_s": wall,
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(eng.itl, 0.5),
        "itl_p99_s": percentile(eng.itl, 0.99),
        "decode_steps": eng.steps, "prefill_passes": passes,
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "launches": launches,
        "decode_attention_per_decode_step":
            launches.get("decode_attention", 0) / max(eng.steps, 1),
        "flash_prefill_per_prefill_pass":
            launches.get("flash_prefill", 0) / max(passes, 1),
        "ssd_chunk_per_prefill_pass":
            launches.get("ssd_chunk", 0) / max(passes, 1),
        "logits_rel_err": worst, "argmax_agree": agree,
        "logits_rel_err_unchecked_reference": info,
        "prefill_chunks": {r.rid: chunks.get(r.rid) for r in reqs},
        "profile": profile,
    }


def _kernel_group(name: str) -> str:
    if "paged_decode" in name:          # the split kernel and the merge
        return "paged_decode_attention"
    if "dense_decode_kernel" in name:
        return "decode_attention"
    if "flash_kernel" in name:
        return "flash_prefill"
    if "ssd_chunk_kernel" in name:
        return "ssd_chunk"
    if any(t in name.lower() for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def profile_serve(make_server, cfg, n_requests, lens, outs, device):
    """Where the device time of the same serve goes: a second run of the
    measured requests under torch.profiler (a fresh server, so the
    measured run above carries no profiler cost).  Returns device time by
    kernel group and the device's idle share of the serve's wall time,
    or None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device == "cpu":
        return None
    srv = make_server()
    reqs = make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        srv.serve(reqs, timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e6
        top.append((us / 1e6, e.count, e.key[:90]))
    busy = sum(groups.values())
    if busy <= 0:
        return None
    top.sort(reverse=True)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "by_group_s": groups,
            "top_kernels": [{"s": t, "calls": c, "name": n}
                            for t, c, n in top[:10]]}


# ---------------------------------------------------------------------------

def kernel_items(dec, dense, pfx, fla, ssd, mixed, pd, ssm):
    """The kernels line: every kernel of the port with its measurements
    and its launches on its own path's serve."""
    def errs(es):
        return dict(max_abs_err=max(a for a, _r in es),
                    max_rel_err=max(r for _a, r in es))

    def item(name, source, replaces, rep, r, path, **extra):
        n = rep["launches"][name]
        steps = rep.get("steps") or rep["decode_steps"]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, **errs(r["errs"]), rel_tol=REL_TOL,
            ms=r["ms"], wall_ms=r["wall_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library_wall_ms=r["library_wall_ms"],
            path=path, launches_per_decode_step=n / steps, shape=r["shape"],
            **extra)

    csrc = "src/repro_torch/csrc/"
    dec_k = "src/repro/kernels/decode_attention/kernel.py"
    fp_k = "src/repro/kernels/flash_prefill/kernel.py:87"
    return [
        item("paged_decode_attention", csrc + "paged_decode_attention.cu",
             dec_k + ":115", mixed, dec, "mixed serve"),
        item("paged_prefill_attention", csrc + "flash_prefill.cu", fp_k,
             mixed, pfx, "mixed serve"),
        item("flash_prefill", csrc + "flash_prefill.cu", fp_k, pd, fla,
             "P/D serve"),
        item("decode_attention", csrc + "decode_attention.cu",
             dec_k + ":166", pd, dense, "P/D serve"),
        item("ssd_chunk", csrc + "ssd_chunk.cu",
             "src/repro/kernels/ssd_scan/kernel.py:54", ssm, ssd,
             "SSM serve (P/D, padded)",
             launches_per_prefill_pass=ssm["ssd_chunk_per_prefill_pass"],
             library_note="none: no single PyTorch call computes the SSD "
                          "intra-chunk term"),
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.config.base import get_arch
        from repro_torch.kernels.build import load_kernels
        from repro_torch.kernels.decode_attention import (
            decode_attention, paged_decode_attention)
        from repro_torch.kernels.flash_prefill import (
            flash_prefill, paged_prefill_attention)
        from repro_torch.kernels.ssd_scan import ssd_chunk
        from repro_torch.models.model import init_params
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    try:
        device = "cuda"
        t0 = time.monotonic()
        load_kernels()
        print(f"[build] kernels built and loaded in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        dec = check_decode(device)
        dense = check_dense_decode(device)
        pfx = check_paged_prefill(device)
        fla = check_flash_prefill(device)
        ssd = check_ssd(device)
        for tag, r in (("[decode]", dec), ("[dense decode]", dense),
                       ("[paged prefill]", pfx), ("[flash prefill]", fla),
                       ("[ssd]", ssd)):
            report_timing(tag, r)
        cfg = get_arch("deepseek-7b")
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
        torch.cuda.synchronize()
        print(f"[init] {cfg.name} bf16 weights in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        counters = [paged_decode_attention, paged_prefill_attention,
                    flash_prefill, decode_attention, ssd_chunk]
        mixed = serve(cfg, params, device, counters)
        for name in ("paged_decode_attention", "paged_prefill_attention"):
            if mixed["launches"][name] <= 0:
                raise AssertionError(f"{name} never launched on the mixed "
                                     f"serve")
        torch.cuda.empty_cache()
        pd = serve_pd(cfg, params, device, counters)
        for name in ("decode_attention", "flash_prefill"):
            if pd["launches"][name] <= 0:
                raise AssertionError(f"{name} never launched on the P/D "
                                     f"serve")
        prof = pd["profile"] or {}
        print(f"[pd serve] ttft_p50_s={pd['ttft_p50_s']!r} "
              f"ttft_p99_s={pd['ttft_p99_s']!r}", flush=True)
        print(f"[pd serve] itl_p50_s={pd['itl_p50_s']!r} "
              f"itl_p99_s={pd['itl_p99_s']!r}", flush=True)
        print(f"[pd serve] wall_s={pd['wall_s']!r}", flush=True)
        print(f"[pd serve] idle_share={prof.get('idle_share')!r} "
              f"(profiled second run, wall_s={prof.get('wall_s')!r})",
              flush=True)
        print(f"[pd serve] device_s_by_group={prof.get('by_group_s')!r}",
              flush=True)
        print(f"[pd serve] launches={pd['launches']!r} per decode step: "
              f"decode_attention="
              f"{pd['decode_attention_per_decode_step']!r}, per prefill "
              f"pass: flash_prefill="
              f"{pd['flash_prefill_per_prefill_pass']!r}", flush=True)
        del params
        torch.cuda.empty_cache()
        scfg_ = get_arch("mamba2-370m")
        t0 = time.monotonic()
        sparams = init_params(scfg_, seed=0, dtype=torch.bfloat16,
                              device=device)
        torch.cuda.synchronize()
        print(f"[init] {scfg_.name} bf16 weights in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        ssm = serve_pd(scfg_, sparams, device, counters, tag="[ssm serve]",
                       forward=ssm_forward_logits,
                       info_forward=ssm_whole_prompt_logits)
        if ssm["launches"]["ssd_chunk"] <= 0:
            raise AssertionError("ssd_chunk never launched on the SSM serve")
        sprof = ssm["profile"] or {}
        print(f"[ssm serve] logits_rel_err={ssm['logits_rel_err']!r} "
              f"(limit {LOGITS_REL_TOL}; recorded: a 1e-7 relative "
              f"perturbation of kernel #4's output gives "
              f"{SSM_LOGITS_AT_1E7})", flush=True)
        print(f"[ssm serve] ttft_p50_s={ssm['ttft_p50_s']!r} "
              f"ttft_p99_s={ssm['ttft_p99_s']!r}", flush=True)
        print(f"[ssm serve] itl_p50_s={ssm['itl_p50_s']!r} "
              f"itl_p99_s={ssm['itl_p99_s']!r}", flush=True)
        print(f"[ssm serve] wall_s={ssm['wall_s']!r}", flush=True)
        print(f"[ssm serve] decode_step_p50_s={ssm['step_p50_s']!r} "
              f"decode_step_p99_s={ssm['step_p99_s']!r} "
              f"(decode_steps={ssm['decode_steps']})", flush=True)
        print(f"[ssm serve] prefill_passes={ssm['prefill_passes']} "
              f"ssd_chunk launches={ssm['launches']['ssd_chunk']} "
              f"({ssm['ssd_chunk_per_prefill_pass']!r} per prefill pass)",
              flush=True)
        print(f"[ssm serve] idle_share={sprof.get('idle_share')!r} "
              f"(profiled second run, wall_s={sprof.get('wall_s')!r})",
              flush=True)
        print(f"[ssm serve] device_s_by_group={sprof.get('by_group_s')!r}",
              flush=True)
        kernels = kernel_items(dec, dense, pfx, fla, ssd, mixed, pd, ssm)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(json.dumps({"serve": mixed}), flush=True)
        print(json.dumps({"serve_pd": pd}), flush=True)
        print(json.dumps({"serve_ssm": ssm}), flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(smi, flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
