#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout; needs a card

Phases (any failure exits non-zero and prints no result):
  1. build the CUDA kernels of `src/repro_torch/csrc` (sm_90a) and print
     the build time;
  2. paged decode attention (kernel #1) against its plain PyTorch version
     at the serving path's shapes (H=K=32, hd=128, bs=16, bf16) and at
     G>1 (H=32, K=8): ragged live lengths, rows whose table is all -1,
     garbage in the null block;
  3. flash prefill (kernel #2), both entries, against their plain
     versions: the paged entry with a chunk that starts mid-page over a
     prefix read through shared pages, the contiguous entry on packed
     segments with padding;
  4. serve: full-width deepseek-7b (random bf16 weights from a seed)
     behind `RealSBSServer` (unified mixed-batch plane, sbs-la, 2 DP
     units, 16-token pages) answers 8 requests of 128-1024 prompt tokens
     and 16-32 new tokens; every request must finish, the pools must
     drain, both kernels must have launched, and each request's
     first-token logits must agree with a plain dense forward;
  5. report: one JSON line with the kernels (time per launch, launches
     on the serve, bound), the card's name and power limit, one JSON
     line with the serve's TTFT/ITL, and the contract line last.

The kernels are timed with CUDA events over launches that rotate through
several copies of the inputs (more than the 50 MB L2), as a serving step
finds them cold.  `bound_ms` is the larger of the bytes the call must
move over 3.35 TB/s and its flops over 989 TFLOP/s (bf16 dense), counted
from this run's inputs.  `library_ms` times
torch.nn.functional.scaled_dot_product_attention on the pre-gathered K/V
as a yardstick only; the port never calls it.
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
LOGITS_REL_TOL = 5e-2              # served vs dense bf16 forward, 30 layers
BLOCK = 16
MAX_LEN = 1088                     # 1024-token prompts + 32 new, 16-aligned
MAX_BATCH = 4                      # per-DP memory budget (requests × max_len)
N_REQUESTS = 8


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_ms(fn, n_inputs: int, iters: int = 20) -> float:
    """Mean ms per call of fn(i), rotating i over n_inputs input copies."""
    import torch
    for i in range(min(3, n_inputs)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for it in range(iters):
        fn(it % n_inputs)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def check_decode(device):
    import torch
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    out = {"errs": []}
    for H, K, dt in ((32, 32, torch.bfloat16), (32, 8, torch.bfloat16),
                     (32, 32, torch.float32)):
        q, kp, vp, kvp, tab, pos = decode_case(H, K, 128, device, H + K, dt)
        got = paged_decode_attention(q, kp, vp, kvp, tab, pos)
        ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                           kvp, tab, pos)
        masked_rows = (tab < 0).all(dim=1)
        if got[masked_rows].abs().max() != 0:
            raise AssertionError("a row with an all -1 table is not 0")
        compare(f"[decode] H={H} K={K}", got, ref, out["errs"])
        if (H, K, dt) != (32, 32, torch.bfloat16):
            continue
        # main-path shape: time kernel, plain and the SDPA yardstick
        n = 4
        kps, vps = copies(kp, n), copies(vp, n)
        out["ms"] = time_ms(lambda i: paged_decode_attention(
            q, kps[i], vps[i], kvp, tab, pos), n, iters=50)
        out["plain_ms"] = time_ms(lambda i: paged_decode_attention_plain(
            q, kps[i], vps[i], kvp, tab, pos), n, iters=10)
        from repro_torch.models.attention import gather_paged, gather_paged_pos
        kg = [gather_paged(k, tab).transpose(1, 2).contiguous() for k in kps]
        vg = [gather_paged(v, tab).transpose(1, 2).contiguous() for v in vps]
        kvg = gather_paged_pos(kvp, tab)
        mask = ((kvg >= 0) & (kvg <= pos[:, None]))[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out["library_ms"] = time_ms(
            lambda i: sdpa(qs, kg[i], vg[i], attn_mask=mask), n, iters=50)
        nbytes, flops = decode_work(q.cpu(), kp, tab.cpu(), kvp.cpu(),
                                    pos.cpu())
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
        out["shape"] = (f"B={q.shape[0]} H=K=32 hd=128 bs={BLOCK} "
                        f"nbt={tab.shape[1]} N={kp.shape[0]} bf16, "
                        f"live={pos.tolist()}")
    return out


# ---------------------------------------------------------------------------
# phase 3: flash prefill, both entries
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
    two = [(13 * BLOCK + 5, 240), (9 * BLOCK + 11, 117)]
    # the main path's shape: one row, a 240-token chunk at a long position
    one = [(49 * BLOCK + 5, 240)]
    bf16, fp32 = torch.bfloat16, torch.float32
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
    out["ms"] = time_ms(lambda i: paged_prefill_attention(
        q, kps[i], vps[i], kvp, tab, posn), n, iters=30)
    out["plain_ms"] = time_ms(lambda i: paged_prefill_attention_plain(
        q, kps[i], vps[i], kvp, tab, posn), n, iters=10)
    kg = [gather_paged(k, tab).transpose(1, 2).contiguous() for k in kps]
    vg = [gather_paged(v, tab).transpose(1, 2).contiguous() for v in vps]
    kvg = gather_paged_pos(kvp, tab)
    mask = build_mask(posn, kvg, causal=True)[:, None]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"] = time_ms(
        lambda i: sdpa(qt, kg[i], vg[i], attn_mask=mask), n, iters=30)
    nbytes, flops = paged_prefill_work(q.cpu(), kp, kvp.cpu(), tab.cpu(),
                                       posn.cpu())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = (f"B=1 Sc=240 at pos {49 * BLOCK + 5} H=K=32 hd=128 "
                    f"bs={BLOCK} bf16")
    return out


def packed_case(H, K, hd, device, seed, dt, B=2, S=512):
    """Packed varlen chunk: two segments and padding per row."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    lens = (200, 250)
    pos = torch.cat([torch.arange(lens[0]), torch.arange(lens[1]),
                     torch.zeros(S - sum(lens), dtype=torch.int64)])
    seg = torch.cat([torch.zeros(lens[0]), torch.ones(lens[1]),
                     -torch.ones(S - sum(lens))])
    pos = pos.to(torch.int32).repeat(B, 1)
    seg = seg.to(torch.int32).repeat(B, 1)
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
    q, k, v, pos, seg = packed_case(32, 32, 128, device, 11, torch.bfloat16)
    n = 4
    ks, vs = copies(k, n), copies(v, n)
    out["ms"] = time_ms(lambda i: flash_prefill(
        q, ks[i], vs[i], pos, pos, seg, seg), n, iters=30)
    out["plain_ms"] = time_ms(lambda i: flash_prefill_plain(
        q, ks[i], vs[i], pos, pos, seg, seg), n, iters=10)
    mask = build_mask(pos, pos, seg, seg, True)
    kt = [t.transpose(1, 2).contiguous() for t in ks]
    vt = [t.transpose(1, 2).contiguous() for t in vs]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"] = time_ms(
        lambda i: sdpa(qt, kt[i], vt[i], attn_mask=mask[:, None]), n,
        iters=30)
    esz = q.element_size()
    pairs = int(mask.sum())
    nbytes, flops = attention_work(
        q, 2 * k.numel() * esz, pairs, q.numel() * esz,
        extra=4 * (4 * pos.numel()))
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = "B=2 S=512 (200+250+62 pad) H=K=32 hd=128 bf16"
    return out


# ---------------------------------------------------------------------------
# phase 4: serve full-width deepseek-7b
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


def dense_forward_logits(cfg, params, tokens, device):
    """Last-position logits of a plain dense forward over the prompt:
    projections, RoPE, masked einsum attention, SwiGLU — no pages, no
    kernels."""
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


def serve(cfg, device, counters, n_requests=N_REQUESTS, lens=(128, 1024),
          outs=(16, 32), dtype=None):
    """Drive the port's main path; returns the serve report.  `counters`
    is the list of kernel wrappers whose launch counts the run reads.
    The size arguments let the same code rehearse on the CPU with a
    reduced config (fp32 `dtype`)."""
    import torch
    from repro_torch.config.base import ServingConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    dtype = dtype or torch.bfloat16
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=dtype, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=256, t_default=0.05, l_net=0.001,
        max_batch_per_dp=MAX_BATCH, block_size=BLOCK,
        mixed_batch=True, mixed_chunk=256)
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

    if sorted(g.rid for g in gens) != [r.rid for r in reqs]:
        raise AssertionError(f"unfinished requests: {len(gens)} of "
                             f"{len(reqs)} finished")
    for g, r in zip(gens, reqs):
        if len(g.tokens) != spec.target_len(r):
            raise AssertionError(f"request {r.rid}: {len(g.tokens)} tokens, "
                                 f"expected {spec.target_len(r)}")
    eng = srv.decode_engines[0]
    for st in eng._dp.values():
        st.pool.check()
        if st.pool.used_count != 0 or st.occupied():
            raise AssertionError("the block pools did not drain")
    if eng.prefill_tokens != sum(r.input_len for r in reqs):
        raise AssertionError("prefill token count mismatch")

    worst = 0.0
    agree = 0
    for r in reqs:
        got = first_logits.get(r.rid)
        ref = dense_forward_logits(cfg, params, r.tokens[:r.input_len],
                                   device)
        if got is None or got.shape != (cfg.vocab_size,) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"request {r.rid}: bad first-token logits")
        rel = float((got.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
        worst = max(worst, rel)
        agree += int(int(got.argmax()) == int(ref.argmax()))
    print(f"[serve] first-token logits vs dense forward: worst max|d|/max|ref|"
          f"={worst:.3e} (tol {LOGITS_REL_TOL}), argmax agrees on "
          f"{agree}/{len(reqs)}", flush=True)
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"first-token logits disagree: {worst}")

    ttft = [g.ttft for g in gens]
    durs = [d for d, _a, _r in eng.step_samples]
    profile = profile_serve(cfg, params, scfg, spec, n_requests, lens, outs,
                            device)
    return {
        "model": cfg.name, "dtype": str(dtype).replace("torch.", ""),
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens],
        "init_s": t_init, "wall_s": wall,
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(eng.itl, 0.5),
        "itl_p99_s": percentile(eng.itl, 0.99),
        "steps": eng.steps, "mixed_steps": eng.mixed_steps,
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "launches": launches, "logits_rel_err": worst,
        "argmax_agree": agree, "profile": profile,
    }


def _kernel_group(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "paged_decode_attention"
    if "flash_kernel" in name:
        return "flash_prefill"
    if any(t in name.lower() for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def profile_serve(cfg, params, scfg, spec, n_requests, lens, outs, device):
    """Where the device time of the same serve goes: a second run of the
    measured requests under torch.profiler (a fresh server, so the
    measured run above carries no profiler cost).  Returns device time by
    kernel group and the device's idle share of the serve's wall time,
    or None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.server import RealSBSServer
    if device == "cpu":
        return None
    srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
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
        from repro_torch.kernels.decode_attention import paged_decode_attention
        from repro_torch.kernels.flash_prefill import (
            flash_prefill, paged_prefill_attention)
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
        pfx = check_paged_prefill(device)
        fla = check_flash_prefill(device)
        rep = serve(get_arch("deepseek-7b"), device,
                    [paged_decode_attention, paged_prefill_attention,
                     flash_prefill])
        launches = rep["launches"]
        for name in ("paged_decode_attention", "paged_prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the serve")
        steps = rep["steps"]

        def errs(es):
            return dict(max_abs_err=max(a for a, _r in es),
                        max_rel_err=max(r for _a, r in es))

        def item(name, source, replaces, n, r, es, **extra):
            return dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=n, **errs(es), rel_tol=REL_TOL,
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                launches_per_step=n / steps, shape=r["shape"], **extra)

        n_fp = launches["paged_prefill_attention"] + launches["flash_prefill"]
        kernels = [
            item("paged_decode_attention",
                 "src/repro_torch/csrc/paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:115",
                 launches["paged_decode_attention"], dec, dec["errs"]),
            item("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                 "src/repro/kernels/flash_prefill/kernel.py:87", n_fp, pfx,
                 pfx["errs"] + fla["errs"],
                 entries={
                     "paged_prefill_attention": dict(
                         launches=launches["paged_prefill_attention"],
                         **{k: pfx[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "shape")},
                         **errs(pfx["errs"])),
                     "flash_prefill": dict(
                         launches=launches["flash_prefill"],
                         **{k: fla[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "shape")},
                         **errs(fla["errs"]))}),
        ]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        rep.pop("launches")
        print(json.dumps({"serve": rep}), flush=True)
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
