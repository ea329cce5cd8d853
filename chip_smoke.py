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
     must be exactly 0; G = 1, 2, 4 and 8; hd 64 and 128; bf16 and
     fp32; G = 2 at hd 64 is the MoE serve's shape);
  3. dense decode attention (kernel #3, split-K over the cache) against
     its plain version: the padded plane's shape (4 rows of 1088,
     H=K=32, hd=128, mixed live lengths and an idle row) in bf16 and
     fp32, G=4 (H=32, K=8), and a wrapped sliding-window ring (pos > S,
     window = S) with a row that has no valid key; and at the split
     design's edges (S = 4096 with rows that end mid-split, a window
     whose edge falls inside a split, wrapped rings cut by the splits,
     one-token rows, an empty row that must be exactly 0; G = 1 and 4,
     hd 64 and 128, bf16 and fp32); and at head dim 120 (h2o-danube-3-4b,
     G = 4: the padded rows, a wrapped ring with a window smaller than
     S), timed at h2o-danube's decode step beside SDPA; and at the
     serving benchmark twin's padded step (granite-moe-1b-a400m, G = 2,
     hd 64, S = 160: one live row, then mixed live lengths and an idle
     row) in bf16 and fp32;
  4. flash prefill (kernel #2: tensor cores in bf16, FMA in fp32), both
     entries, against their plain versions: the paged entry with a chunk
     that starts mid-page over a prefix read through shared pages, the
     contiguous entry on packed segments with padding and at
     `attn_extend`'s shape (one 256-token chunk inside a 1088-long cache
     whose tail is empty); and at the tensor-core design's edges: ragged
     chunks of 117, 199 and 240 tokens, rows whose K/V tiles are all
     skipped (an all -1 table, an empty cache: exactly 0), wrapped
     sliding-window rings with a window, G = 1, 2 (the MoE serve's, at
     hd 64) and 4, hd 64 and 128, and packed segments that one warp or key tile spans while every
     key passes the position masks (448 one-token segments at position
     0; chunks that start at nonzero positions); the contiguous entry
     also at head dim 120 (G = 4: packed segments, attn_extend's chunk,
     a wrapped window-96 ring), timed at h2o-danube's prefill chunk
     beside SDPA;
  4b. kernel #2's contiguous entry as the full-sequence path calls it,
     in bf16 and fp32: not causal at whisper-large-v3's shapes (the
     encoder's self-attention, 4 x 1500 x 1500, 20 heads of 64;
     cross-attention of 1, 16 and 77 queries over 1500 encoder
     positions; a row whose keys are all padding, exactly 0), causal at
     internvl2-1b's G = 7 (14 heads over 2 KV heads of 64, 256 + 200
     tokens, a padded row and an all-pad row, exactly 0); kernel #3 at
     G = 7 over internvl2-1b's padded cache; #2 not causal timed at the
     encoder's shape and at the decode step's and the chunk's
     cross-attention (1 and 16 queries a row over 1500 keys) beside SDPA
     without a mask, each timed shape's plan (rows a CTA, key splits)
     printed;
  5. mixed serve: full-width deepseek-7b (random bf16 weights from a
     seed) behind `RealSBSServer` (unified mixed-batch plane, sbs-la, 2
     DP units, 16-token pages) answers 8 requests of 128-1024 prompt
     tokens and 16-32 new tokens, arriving at once and dispatched
     together, with step graphs (every decode step and prefill chunk
     replays a CUDA graph; the server serves the requests once first,
     capturing the chunk graphs they need), then again eagerly
     (`step_graphs=False`); every request must finish, the pools must
     drain, kernels #1 and #2 (paged entry) must have launched, each
     request's first-token logits must agree with a plain dense
     forward, and the two modes must run the same steps and chunks with
     the same launches per step and profiled device time within 5% of
     each other, as medians over two profiled runs of each mode made
     in turn, graph, eager, graph, eager (every graph run's trace must
     hold the graphs' kernels);
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
     tokens, sbs-la; requests 50 ms apart; every decode step and dense
     prefill chunk replays a CUDA graph: each server captures its decode
     steps and its full chunk when it is built, a prompt's shorter last
     chunk at its length's first use); the same checks, with kernels #3
     and #2 (contiguous entry) launched and no other, and every dense
     chunk replaying a graph; then the same serve eagerly
     (`step_graphs=False`: T_fwd, TTFT, ITL side by side), and the
     graphs-vs-eager A/B on the same 8 requests at t = 0 under
     `immediate` (chunk boundaries independent of step time): the same
     chunks, tokens and first-token logits, bit for bit;
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
     every dense chunk (kernel #4 inside) replays a graph; then eagerly;
  6c. SWA serve: h2o-danube-3-4b at full width, depth cut to SWA_LAYERS
     of its 24 layers (d 3840, 32
     heads over 8 KV heads of 120, window 4096; bf16 from seed 0) behind
     the P/D serve's deployment with its requests; the same checks at
     head dim 120: kernels #3 and #2 (contiguous entry) launch, #1, #2's
     paged entry and #4 do not; every dense chunk replays a graph; then
     eagerly;
  6d. shared-prefix P/D serve: full-width deepseek-7b (weights made
     again from seed 0) behind the P/D server on the paged plane with
     `prefix_cache=True` (page-native prefill, PageHandoff, prefix
     sharing; 1 prefill instance × 2 DP units with 256-token chunks, 1
     decode instance × 2 DP units of 16-token pages, sbs-la), two waves
     of the same 8 prompts on one server: six share a 512-token prefix,
     one is unrelated, one repeats the first.  Every request finishes;
     pages are reused on both planes (hit tokens, a full hit in wave 1,
     shared decode pages, copy-on-write copies); each computed prompt's
     first-token logits agree with a plain forward and each full hit
     replays its original's first token; kernels #1 and #2 (paged entry)
     launch and #2's contiguous entry and #3 do not; every pool is empty
     after its binder is evicted.  The server serves both waves once
     first (capturing its chunk graphs) and is evicted before the
     measured waves;
  6e. MoE serve: full-width granite-moe-1b-a400m (24 layers, d 1024, 16
     heads over 8 KV heads of 64, 32 experts top-8 of 512, capacity
     factor 1.25; random weights from seed 0 in MOE_CHECK_DTYPE) behind
     the unified plane as in phase 5 with the same 8 requests; the same
     checks, with kernels #1 and #2 (paged entry) launched at G = 2 and
     no other; the plain forward runs the MoE FFN once per prefill chunk
     the serve ran (expert capacity counts a call's tokens); then the
     routing flips between the served path and the plain forward, and
     the capacity drops of every chunk, each on a line of its own; and
     the eager A/B of phase 5;
  6f. MLA serve: minicpm3-4b at full width, depth cut to MLA_LAYERS of
     its 62 layers (d 2560, 40 heads,
     q_lora 768, kv_lora 256, rope 32; bf16 from seed 0) behind the
     shared-prefix P/D deployment of phase 6c with the same two waves:
     latent pages through page-native prefill, claims, `PageHandoff`,
     adoption and copy-on-write; the same checks, each computed prompt's
     logits against the NON-absorbed plain forward, and no kernel of the
     port launched (absorbed MLA runs as torch ops);
  6g. the sharded DP+EP plane on four logical shards of the card
     (`make_engine_mesh(4, devices=["cuda"] * 4)`): (a) the EP layer
     (`moe_block_ep`, explicit all-to-all, per-source capacity) at
     full-width granite-moe-1b-a400m's MoE shape in bf16 against its
     plain version (`moe_block_ep_reference`) at the merged decode
     step's 32 rows and a 256-token chunk, with its exchanges, bytes
     and times; (b) full-width granite-moe-1b-a400m (24 layers, bf16
     from seed 0) behind `RealSBSServer(mesh=...)`, P/D (2 prefill ×
     1 DP with 256-token dense chunks, 1 decode instance × 4 DP merged
     into one cache of 16-token pages, requests 50 ms apart) and
     unified (4 DP merged, the burst dispatched whole), sbs-la, with
     step graphs (one graph a merged decode step, a page-native chunk
     by shard, a dense chunk), 8 requests of the serves' traffic each:
     every request finishes, the merged caches drain, every step that
     decoded covered the merged slots and made EP exchanges, every step
     of the measured run replayed a graph, kernels #1 and #2
     (contiguous on P/D, paged on unified) launch and no other, counted
     through the replays, and first-token logits agree with a plain
     forward over the served chunks and the served expert sets; TTFT,
     ITL, step times, captures, replays and capture seconds, the EP
     exchanges and bytes per decode step and their device time from an
     eager probe step, on lines of their own; (c) the sharded P/D
     serve's graphs-vs-eager A/B on an `immediate` burst with the
     decode joins placed together, at SHARDED_BITS_LAYERS of the 24
     layers (width and traffic as above): chunks, tokens and
     first-token logits identical, bit for bit;
  6h. the hybrid: jamba-v0.1-52b at full width, depth cut to
     HYBRID_LAYERS of its 32 (one period: 7 SSM layers, 4 of them
     SSM_MOE with 16 experts top-2, 1 attention layer; bf16 from seed
     0, made on the card), (a) behind the P/D deployment of phase 6 on
     the paged plane with 16-token pages: the dense chunks run #4 in the
     SSM layers and #2's contiguous entry in the attention layer, the
     handoff joins pages and the slot's per-slot SSM state, decode runs
     #1; every request finishes, the pools drain, #1, #2 contiguous and
     #4 launch through replays and no other kernel, each first-token
     logits row equals the eager replay of the served chunks and the
     served expert sets bit for bit, and the same requests at t = 0
     under `immediate`, the decode joins placed together, give the same
     chunks, tokens and first-token logits with graphs and eagerly, bit
     for bit; (b) behind the sharded P/D deployment of phase 6g (four
     logical shards, EP over the 16 experts, four a shard), with step
     graphs: every request finishes, the merged cache drains, each
     merged decode step makes 8 exchanges (2 in each MoE layer), and the
     served logits equal the eager replay bit for bit; (c) with the
     servers freed and the weights widened to fp32 in place, each served
     prompt's eager replay (its served chunks and expert sets) in fp32
     agrees with a plain fp32 forward over the same within 1e-4 (the
     bf16 served-vs-plain distance, which depends on where SBS split a
     prompt, is printed, not checked);
  6i. the full-sequence path through the port's model-level entry
     points (the serving engines refuse these models: their requests
     carry no frame or patch embeddings): full-width whisper-large-v3
     (32 encoder + 32 decoder layers, 4 requests of 1500 stub frame
     embeddings and decoder prompts of 4, 17, 33 and 64 tokens) and
     internvl2-1b (24 layers, 256 stub patch embeddings, prompts of 16,
     77, 150 and 200 tokens), random bf16 weights from seed 0: `prefill`
     with per-row lengths into a dense cache (max_len 256 and 512), one
     16-token `prefill_chunk`, 32 greedy `decode_step`s; #2 (causal:
     the decoder's prefill and chunk; not causal: the encoder and every
     cross-attention) and #3 must launch exactly as the path calls
     them, and each request's logits after the prefill and after the
     chunk agree with a plain forward over the same tokens (encoder and
     cross-attention included); the phase's wall time on a line of its
     own; then whisper's paged leg: the 4 requests' dense rows joined
     into a paged cache of 16-token pages (each slot's encoder K/V
     beside the pages), 32 eager `paged_decode_step`s beside the dense
     steps on the same tokens, logits within 5e-2 of the largest at
     every step, #1 (self-attention over the pages) and #2 not causal
     (cross-attention over the slot's encoder K/V) launched once a layer
     a step and nothing else, and `paged_cache_clear_slot` leaving an
     empty table;
  6k. tensor parallelism inside a DP on the sharded plane, on a (2, 2)
     mesh of four logical shards of the card (2 DP units of 2 TP ranks):
     (a) full-width granite-moe-1b-a400m (bf16, seed 0) behind
     `RealSBSServer(mesh=make_engine_mesh(2, 2, devices=["cuda"] * 4))`,
     P/D on the paged plane with step graphs on phase 6g's 8 requests:
     phase 6g's checks, and every merged decode step's TP collectives
     as predicted (an all-gather of the d_model-split embedding, an
     all-reduce after each split attention, an all-gather of each MoE
     layer's rows, a reduce of the logits); its dense prefill chunks on
     DP 0's two ranks (each chunk's collectives as predicted: 1
     all-gather, 24 all-reduces, 24 broadcasts of the MoE, 1 reduce;
     #2's contiguous entry 48 times a chunk, each rank its heads); the
     `[tp weights]` check (each device's weight bytes by storage equal
     to what `tp_axis` gives, no whole copy of a split leaf); its
     graphs-vs-eager bit A/B on an `immediate` burst at
     SHARDED_BITS_LAYERS layers; its merged step p50 printed beside
     phase 6g's data-only one; (b) full-width deepseek-7b at 8 of 30
     layers: 8 prefilled requests joined into a paged cache of 2 DP
     units and the same cache merged over the mesh; the TP merged
     decode step's logits within 5e-2 of the unsharded paged step's on
     the same rows, its collectives as predicted, `[tp weights]`, both
     steps' p50 as step graphs; then the minicpm3-4b and jamba legs
     (jamba's dense chunks: #4 14 times a chunk at 64 of 128 heads, #2
     twice); then (c) full-width internvl2-1b on a (1, 4) mesh (its 14
     heads over 2 KV heads in the row-parallel form) and (d) full-width
     whisper-large-v3 on the (2, 2) mesh (cross-attention by heads over
     4 requests' encoder K/V split the same way), each a TP merged
     step against the unsharded paged step (logits within 5e-2;
     whisper, where bf16 misses, in fp32 within 1e-4), collectives as
     predicted, `[tp weights]`;
  6j. the training path: full-width minicpm-2b (40 layers, d 2304, 36
     heads of 64, 2.72 B parameters) in fp32, TF32 off, random weights
     from seed 0, one synthetic batch of 2 x 512 tokens: one step's loss
     and every gradient leaf through kernel #2's autograd Function
     against the same step with the plain attention under autograd
     (within 1e-3 of each leaf's largest), every parameter with a finite
     gradient; 8 AdamW steps of the `Trainer` with WSD (warmup 2) on that
     batch, loss and grad_norm finite and the last ce below the first,
     #2 launched 40 times a step (once a layer in the forward); step
     time, tokens/s, peak memory, a profiled step's idle share; one
     remat=True step (#2's 40 recomputations counted apart); #2 timed
     at the step's shape (fp32, causal) beside SDPA, its bound at the
     fp32 peak;
  7. the serving benchmark twin (`examples/serve_e2e_torch.py`, loaded
     by path): its six A/Bs through its CLI entry point at the flags of
     `scripts/ci.sh --real-smoke` (paged vs padded on granite-moe; the
     scheduler sweep, the prefix, overload and mixed A/Bs on
     deepseek-7b; the sharded A/B on granite-moe, on four logical
     shards of the card), in bf16 as the CLI serves them, every serve checked:
     every request finishes with its tokens, the decode rows and pools
     drain (prefix-cached pools after eviction), the plane's kernels
     launch and no other, each computed prompt's first-token logits agree
     with a plain forward over its chunks (granite-moe's with the expert
     sets the served chunks chose, taken from an eager replay of the
     served chunks, since a replayed graph calls no Python: bf16 rounding
     breaks near-ties of its random router apart), a full hit replays
     its prompt's first token, and on P/D with dense prefill every
     chunk replays a graph; then each A/B's structural counters (paged
     residency above padded; the cached leg's saved FLOPs, hits and
     shared pages; preemptions only with preemption; mixed steps only
     piggybacked; EP exchanges in every merged decode step of the
     sharded legs) and, printed but not checked, its timing gate's
     verdict; then the prefill-pass split of the overload A/B
     (`scripts/prefill_pass_split.py`, two more runs of it: pass wall,
     step_lock wait, token upload and host calls per pass with the
     wrappers alone, device time of the prefill workers under the
     profiler), each leg on a line of its own;
  8. report: one JSON line per serve (TTFT/ITL, launches per step, a
     profile of device time by kernel group with the device busy time
     and the idle share, the step graphs' counts: graphs captured,
     replays, capture seconds, graph-pool bytes), every serve's figures
     each on a line of its own (reuse counters and the card's peak
     memory where they apply; the A/B serves' graph and eager figures
     side by side), the `train` JSON line (phase 6j), one JSON line with
     the kernels (device and wall time per call, launches on their
     path's serve, bound; #3 and #2's contiguous entry also at head dim
     120; #2 not causal a row of its own, #2 in training a row of its
     own), the card's name and power limit, and the contract line last.

Launch counts are set to 0 just before each serve (each twin A/B) and
read just after, so each kernel's `launches` is its count on its own
path's serve, and `launches_twin` its count on each A/B.

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

import contextlib
import dataclasses
import gc
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor peak
FP32_FLOPS = 67e12                 # H100 SXM fp32 peak (no tensor cores)
TF32_FLOPS = 495e12                # H100 SXM dense TF32 tensor peak
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
# dtype of the MoE serve and of its logits check: the check holds in
# bf16 despite the routing flips bf16 causes (counts in PERF.md)
MOE_CHECK_DTYPE = "bfloat16"
# depth of earlier serves, cut (width, traffic and checks as before) so
# that the later phases (phase 6k's MLA and SSM legs, phase 6l) fit the
# smoke's time limit beside phase 7's prefill-pass split (160-250 s):
# h2o-danube-3-4b has 24 layers, minicpm3-4b 62, granite-moe-1b-a400m 24
# (phase 6d's unified MoE serve), deepseek-7b 30 (phases 6, 6b, 6c: the
# mixed, P/D and shared-prefix serves), mamba2-370m 48 (phase 6a)
SWA_LAYERS = 8
MLA_LAYERS = 16
MOE_LAYERS = 12
SERVE_LAYERS = 15
SSM_LAYERS = 24
# depth of the sharded P/D serve's graphs-vs-eager bit A/B (both legs;
# granite-moe-1b-a400m has 24 layers): its eager leg is host-bound, and
# the measured sharded serves stay at full depth
SHARDED_BITS_LAYERS = 8


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


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
            (32, 4, 128, bf16), (32, 4, 128, fp32), (16, 16, 64, bf16),
            (16, 8, 64, bf16))):                 # the last: the MoE serve's
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
        # head dim 120 (h2o-danube-3-4b: 32 heads over 8 KV heads): the
        # padded plane's rows, and a wrapped ring with a window smaller
        # than S and an empty row
        ("h2o-danube rows hd=120", 32, 8, S, main_pos, 0, (), bf16, 120),
        ("h2o-danube rows hd=120", 32, 8, S, main_pos, 0, (), fp32, 120),
        ("wrapped ring, window < S, hd=120", 32, 8, 520,
         [1500, 300, 519, 2047, 9], 100, (3,), bf16, 120),
        ("wrapped ring, window < S, hd=120", 32, 8, 520,
         [1500, 300, 519, 2047, 9], 100, (3,), fp32, 120),
        # the serving benchmark twin's padded plane (granite-moe-1b-a400m:
        # 16 heads over 8 KV heads of 64, max_len 160): its step's one
        # row per DP unit, and rows of mixed live lengths with an idle one
        ("twin padded step G=2 hd=64", 16, 8, 160, [88], 0, (), bf16, 64),
        ("twin padded step G=2 hd=64", 16, 8, 160, [88], 0, (), fp32, 64),
        ("twin padded rows G=2 hd=64", 16, 8, 160, [159, 57, 20, 40], 0,
         (3,), bf16, 64),
        ("twin padded rows G=2 hd=64", 16, 8, 160, [159, 57, 20, 40], 0,
         (3,), fp32, 64),
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
    # h2o-danube-3-4b's padded decode step: the same rows at hd 120, G = 4
    q, kc, vc, kvp, posn = dense_decode_case(32, 8, 120, S, main_pos,
                                             device, 41, bf16)
    kcs, vcs = copies(kc, n), copies(vc, n)
    h = out["hd120"] = {}
    h["ms"], h["wall_ms"] = time_ms(lambda i: decode_attention(
        q, kcs[i], vcs[i], kvp, posn), n, iters=50)
    h["plain_ms"], _ = time_ms(lambda i: decode_attention_plain(
        q, kcs[i], vcs[i], kvp, posn), n, iters=10)
    kt = [k.transpose(1, 2).contiguous() for k in kcs]
    vt = [v.transpose(1, 2).contiguous() for v in vcs]
    mask = dense_valid(kvp, posn, 0)[:, None, None, :]
    qs = q[:, :, None, :]
    h["library_ms"], h["library_wall_ms"] = time_ms(
        lambda i: sdpa(qs, kt[i], vt[i], attn_mask=mask, enable_gqa=True),
        n, iters=50)
    nbytes, flops = dense_decode_work(q.cpu(), kc, kvp.cpu(), posn.cpu(), 0)
    h["bound_ms"], h["bound_by"] = bound(nbytes, flops)
    h["shape"] = (f"B=4 S={S} H=32 K=8 hd=120 bf16, pos={main_pos} "
                  f"(h2o-danube-3-4b's padded decode step; SDPA with "
                  f"enable_gqa)")
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
            (199, 16, 4, 64, fp32),
            (240, 16, 8, 64, bf16))):            # the MoE serve's heads
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
    out["plan"] = flash_body(out["shape"], paged_prefill_attention)
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
    # head dim 120 (h2o-danube-3-4b, G = 4): packed segments with padding,
    # attn_extend's chunk, and a 117-token chunk over a wrapped window-96
    # ring of 128 whose second row is all empty (exactly 0)
    for dt in (bf16, fp32):
        q, k, v, pos, seg = packed_case(32, 8, 120, device, 120, dt)
        got = flash_prefill(q, k, v, pos, pos, seg, seg)
        ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos,
                                  seg, seg)
        tag = "[flash prefill] hd=120 H=32 K=8 packed 200+250+pad"
        check_zero(tag, got[seg < 0])
        compare(tag, got, ref, out["errs"])
        for Sc, p0, S, window in ((256, 512, MAX_LEN, 0),
                                  (117, 500, 128, 96)):
            q, k, v, qp, kvp, qs, ks = extend_case(
                device, 60 + Sc, dt, S=S, p0=p0, Sc=Sc, H=32, K=8, hd=120,
                B=2)
            kvp[1] = -1
            got = flash_prefill(q, k, v, qp, kvp, qs, ks, True, window)
            ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp,
                                      kvp, qs, ks, True, window)
            tag = (f"[flash prefill] hd=120 H=32 K=8 Sq={Sc} at {p0} over "
                   f"S={S} window={window}")
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
    out["plan"] = flash_body(out["shape"], flash_prefill)
    # h2o-danube-3-4b's prefill chunk on the padded plane: hd 120, G = 4
    q, k, v, qp, kvp, qs, ks = extend_case(device, 18, torch.bfloat16, H=32,
                                           K=8, hd=120)
    kk, vv = copies(k, n), copies(v, n)
    mask = build_mask(qp, kvp, qs, ks, True)
    live = int((kvp >= 0).sum())
    h = out["hd120"] = {}
    h["ms"], h["wall_ms"] = time_ms(lambda i: flash_prefill(
        q, kk[i], vv[i], qp, kvp, qs, ks), n, iters=30)
    h["plain_ms"], _ = time_ms(lambda i: flash_prefill_plain(
        q, kk[i], vv[i], qp, kvp, qs, ks), n, iters=10)
    kt = [t.transpose(1, 2).contiguous() for t in kk]
    vt = [t.transpose(1, 2).contiguous() for t in vv]
    qt = q.transpose(1, 2).contiguous()
    h["library_ms"], h["library_wall_ms"] = time_ms(
        lambda i: sdpa(qt, kt[i], vt[i], attn_mask=mask[:, None],
                       enable_gqa=True), n, iters=30)
    K, hd = k.shape[2], k.shape[3]
    nbytes, flops = attention_work(
        q, live * 2 * K * hd * esz, int(mask.sum()), q.numel() * esz,
        extra=4 * (2 * qp.numel() + 2 * kvp.numel()))
    h["bound_ms"], h["bound_by"] = bound(nbytes, flops)
    h["shape"] = ("B=1 Sq=256 at positions 512..767 over Skv=1088 (768 "
                  "live) H=32 K=8 hd=120 bf16 (h2o-danube-3-4b's prefill "
                  "chunk; SDPA with enable_gqa)")
    h["plan"] = flash_body(h["shape"], flash_prefill)
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
# phase 4b: #2's contiguous entry not causal (encoder self-attention,
# cross-attention) and at G = 7; #3 at G = 7
# ---------------------------------------------------------------------------

WHISPER_FRAMES = 1500              # whisper-large-v3's encoder positions


def full_case(B, Sq, Skv, H, K, hd, device, seed, dt, encoder=False):
    """q (B, Sq, H, hd) over K/V (B, Skv, K, hd) as the full-sequence
    path calls #2: `encoder` (or a causal prefill) numbers the positions
    0 .. S-1 on both sides (Sq = Skv); cross-attention has every
    position and segment 0.  Segments all 0."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, Sq, H, hd, generator=g) * 0.5).to(dt)
    k = (torch.randn(B, Skv, K, hd, generator=g) * 0.5).to(dt)
    v = (torch.randn(B, Skv, K, hd, generator=g) * 0.5).to(dt)
    if encoder:
        qp = torch.arange(Sq, dtype=torch.int32).repeat(B, 1)
        kp = torch.arange(Skv, dtype=torch.int32).repeat(B, 1)
    else:
        qp = torch.zeros(B, Sq, dtype=torch.int32)
        kp = torch.zeros(B, Skv, dtype=torch.int32)
    qs = torch.zeros(B, Sq, dtype=torch.int32)
    ks = torch.zeros(B, Skv, dtype=torch.int32)
    return [t.to(device) for t in (q, k, v, qp, kp, qs, ks)]


def check_flash_full(device):
    """Phase 4b: kernel #2's contiguous entry as the full-sequence path
    calls it, against its plain version in bf16 and fp32: not causal at
    whisper-large-v3's shapes (the encoder's self-attention, 4 x 1500 x
    1500, 20 heads of 64; cross-attention of 1, 16 and 77 queries over
    the 1500 encoder positions; a row whose keys are all padding, exactly
    0), and causal at internvl2-1b's G = 7 (14 heads over 2 KV heads of
    64: 256 patch + 200 text tokens, a row padded after 300 tokens, an
    all-pad row, exactly 0); kernel #3 at G = 7 over internvl2-1b's
    padded cache (S = 512, an empty row exactly 0); then #2 not causal
    timed at the encoder's shape beside SDPA, and at the cross-attention
    of whisper's decode step and chunk (B = 4, 1 and 16 queries over 1500
    keys, bound by K/V's bytes) beside SDPA.  Returns the kernel-line
    figures of the non-causal row ("errs"), with "errs_g7" (#2 causal at
    G = 7), "errs_dense_g7" (#3), "plan" and "cross" (per query count:
    the figures of its row, its errors among "errs")."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    out = {"errs": [], "errs_g7": [], "errs_dense_g7": [],
           "errs_cross": {1: [], 16: []}}
    F = WHISPER_FRAMES
    for dt in (torch.bfloat16, torch.float32):
        for tag, B, Sq, enc in (("encoder self-attention", 4, F, True),
                                ("cross-attention Sq=1", 4, 1, False),
                                ("cross-attention Sq=16", 4, 16, False),
                                ("cross-attention Sq=77", 4, 77, False),
                                ("cross-attention, row 1 all pad", 2, 77,
                                 False)):
            q, k, v, qp, kp, qs, ks = full_case(B, Sq, F, 20, 20, 64, device,
                                                B + Sq, dt, enc)
            if "all pad" in tag:
                ks[1] = -1
            got = flash_prefill(q, k, v, qp, kp, qs, ks, causal=False)
            ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp,
                                      kp, qs, ks, causal=False)
            label = (f"[flash prefill] not causal, {tag} Skv={F} H=K=20 "
                     f"hd=64")
            if "all pad" in tag:
                check_zero(label, got[1])
            compare(label, got, ref, out["errs"])
            if Sq in out["errs_cross"] and "all pad" not in tag:
                out["errs_cross"][Sq].append(out["errs"][-1])
        # internvl2-1b's causal prefill: G = 7 (one head a CTA: 7 does
        # not divide the 64 rows of a tile)
        S = 256 + 200
        q, k, v, pos, _kp, seg, _ks = full_case(3, S, S, 14, 2, 64, device,
                                                77, dt, encoder=True)
        seg[1, 300:] = -1
        seg[2] = -1
        got = flash_prefill(q, k, v, pos, pos, seg, seg, causal=True)
        ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos,
                                  seg, seg, causal=True)
        label = (f"[flash prefill] causal G=7 H=14 K=2 hd=64 S={S}, row 1 "
                 f"padded after 300, row 2 all pad")
        check_zero(label, got[2])
        check_zero(label, got[1, 300:])
        compare(label, got, ref, out["errs_g7"])
        q, kc, vc, kvp, posn = dense_decode_case(14, 2, 64, 512,
                                                 [471, 300, 257, 40], device,
                                                 70, dt, empty=(3,))
        got = decode_attention(q, kc, vc, kvp, posn)
        ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kvp,
                                     posn)
        label = "[dense decode] G=7 H=14 K=2 hd=64 S=512, row 3 empty"
        check_zero(label, got[3])
        compare(label, got, ref, out["errs_dense_g7"])
    # time the encoder's self-attention (bf16), inputs rotated over copies
    q, k, v, qp, kp, qs, ks = full_case(4, F, F, 20, 20, 64, device, 1,
                                        torch.bfloat16, encoder=True)
    n = 4
    kk, vv = copies(k, n), copies(v, n)
    out["ms"], out["wall_ms"] = time_ms(lambda i: flash_prefill(
        q, kk[i], vv[i], qp, kp, qs, ks, causal=False), n, iters=30)
    out["plain_ms"], _ = time_ms(lambda i: flash_prefill_plain(
        q, kk[i], vv[i], qp, kp, qs, ks, causal=False), n, iters=5)
    kt = [t.transpose(1, 2).contiguous() for t in kk]
    vt = [t.transpose(1, 2).contiguous() for t in vv]
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"], out["library_wall_ms"] = time_ms(
        lambda i: sdpa(qt, kt[i], vt[i]), n, iters=30)
    esz = q.element_size()
    nbytes, flops = attention_work(
        q, 2 * k.numel() * esz, 4 * F * F, q.numel() * esz,
        extra=4 * (2 * qp.numel() + 2 * kp.numel()))
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    out["shape"] = (f"B=4 Sq=Skv={F} H=K=20 hd=64 bf16, causal=False "
                    f"(whisper-large-v3's encoder self-attention; SDPA "
                    f"without a mask)")
    out["plan"] = flash_body(out["shape"], flash_prefill)
    # whisper's cross-attention: the decode step's (1 query a row) and the
    # chunk's (16), over the 1500 encoder positions; bound by K/V's bytes
    for Sq in (1, 16):
        q, k, v, qp, kp, qs, ks = full_case(4, Sq, F, 20, 20, 64, device,
                                            40 + Sq, torch.bfloat16)
        kk, vv = copies(k, n), copies(v, n)
        r = out.setdefault("cross", {})[Sq] = {
            "errs": out["errs_cross"][Sq]}
        r["ms"], r["wall_ms"] = time_ms(lambda i: flash_prefill(
            q, kk[i], vv[i], qp, kp, qs, ks, causal=False), n, iters=50)
        r["plain_ms"], _ = time_ms(lambda i: flash_prefill_plain(
            q, kk[i], vv[i], qp, kp, qs, ks, causal=False), n, iters=10)
        kt = [t.transpose(1, 2).contiguous() for t in kk]
        vt = [t.transpose(1, 2).contiguous() for t in vv]
        qt = q.transpose(1, 2).contiguous()
        r["library_ms"], r["library_wall_ms"] = time_ms(
            lambda i: sdpa(qt, kt[i], vt[i]), n, iters=50)
        nbytes, flops = attention_work(
            q, 2 * k.numel() * esz, 4 * Sq * F, q.numel() * esz,
            extra=4 * (2 * qp.numel() + 2 * kp.numel()))
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
        r["shape"] = (f"B=4 Sq={Sq} Skv={F} H=K=20 hd=64 bf16, causal=False "
                      f"(whisper-large-v3's "
                      f"{'decode step' if Sq == 1 else 'chunk'} "
                      f"cross-attention; SDPA without a mask)")
        r["plan"] = flash_body(r["shape"], flash_prefill)
        report_timing(f"[flash prefill cross Sq={Sq}]", r)
    return out


def flash_body(shape, wrapper):
    """The bf16 body's plan (rows a CTA, key splits) that `wrapper`'s last
    call, the timed one, passed to the kernel, printed beside its shape;
    None where that call took the plain version (a CPU rehearsal)."""
    if wrapper.last_plan is None:
        print(f"[flash prefill plan] {shape}: plain version, no kernel",
              flush=True)
        return None
    rows, n_split = wrapper.last_plan
    plan = dict(rows=rows, warpgroups=rows // 64, splits=n_split)
    print(f"[flash prefill plan] {shape}: wgmma body, {rows} (query, head) "
          f"rows a CTA ({rows // 64} consumer warpgroups), {n_split} "
          f"split(s) over the keys", flush=True)
    return plan


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

def free_device_memory():
    """Return the memory of everything dropped so far to the card: the
    engines' recording wrappers close reference cycles (engine → wrapper
    → engine) that hold a spec's weights and pools until the garbage
    collector runs, so collect before emptying the allocator's cache."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def make_requests(cfg, n, seed, lens=(128, 1024), outs=(16, 32),
                  burst=False):
    """n requests 50 ms apart (`burst`: all at t = 0), prompts of lens[0],
    lens[1] and n - 2 drawn between them."""
    from repro_torch.core.types import Request
    rng = random.Random(seed)
    plens = [lens[0], lens[1]] + [rng.randrange(lens[0], lens[1] + 1)
                                  for _ in range(n - 2)]
    reqs = []
    for i, L in enumerate(plens):
        reqs.append(Request(
            rid=i, arrival_time=0.0 if burst else 0.05 * i, input_len=L,
            output_len=rng.randrange(outs[0], outs[1] + 1),
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    return reqs


def _plain_mla(cfg, a, h, pos, mask):
    """MLA in the NON-absorbed form, as the reference's full-sequence
    `mla_full`: per-head k_nope and v materialised from the latent, the
    shared rope key broadcast over heads, masked einsum attention.  An
    independent check of the served absorbed form over latent pages."""
    import torch
    from repro_torch.models.attention import gqa_reference
    from repro_torch.models.layers import apply_rope, rms_norm
    m = cfg.mla
    S, H, dn = h.shape[1], cfg.num_heads, m.qk_nope_head_dim
    hq = (rms_norm(h @ a["w_dq"], a["q_norm"], cfg.norm_eps)
          if m.q_lora_rank else h)
    q = (hq @ a["w_uq"].reshape(hq.shape[-1], -1)).reshape(1, S, H, -1)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], pos,
                                           cfg.rope_theta)], dim=-1)
    ckv = rms_norm(h @ a["w_dkv"], a["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((h @ a["w_kr"])[:, :, None, :], pos, cfg.rope_theta)
    k_nope = torch.einsum("bsr,rhe->bshe", ckv, a["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", ckv, a["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(1, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    o = gqa_reference(q, k, v, mask)
    return o.reshape(1, S, -1) @ a["w_o"].reshape(H * m.v_head_dim, -1)


def dense_forward_logits(cfg, params, tokens, device, chunks=None,
                         moe_fn=None, embeds=None, at=None):
    """Last-position logits of a plain forward over the prompt: no pages,
    no kernels.  Attention is GQA (projections, RoPE, masked einsum) or
    MLA (`_plain_mla`) over the whole prompt: without a window ring it
    does not depend on prefill chunk boundaries.  An MoE FFN does: expert
    capacity counts the tokens of one call, so `moe_block` runs once per
    prefill chunk the serve used (`chunks`, lengths; None is one call
    over the prompt), as the served steps call it.  So does a hybrid's
    SSM layer (jamba): `mamba_forward` through `ssd_chunked` (the plain
    SSD scan) runs chunk by chunk, carrying its state and conv tails, as
    `ssm_forward_logits` does.  A sliding window
    masks as the reference's; a ring cache gives the same result only
    while the prompt fits the window (the serves' prompts do).
    `moe_fn(h, params, mc)` replaces `moe_block` for each chunk's MoE
    (the sharded unified plane's, `ep_chunk_moe`).  `embeds` is one
    request's stub embeddings: a VLM's patches (P, D), prepended to the
    tokens, or an encoder-decoder's frames (F, D), run through the
    encoder (sinusoidal positions, bidirectional attention without RoPE,
    `enc_ln_f`), whose output the decoder layers' cross-attention reads.
    `at` (positions) gives the logits at those positions instead."""
    import torch
    from repro_torch.config.base import AttentionKind
    from repro_torch.models.attention import build_mask, gqa_reference
    from repro_torch.models.layers import (
        apply_rope, rms_norm, sinusoid_pos_embedding, swiglu)
    from repro_torch.models.mamba import mamba_forward, ssd_chunked
    from repro_torch.models.model import logits_from_hidden
    from repro_torch.models.moe import moe_block
    moe_fn = moe_fn or moe_block
    D, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, eps = cfg.resolved_head_dim, cfg.norm_eps

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=device)[None]

    def attend(a, h, src, mask, pos=None):
        """GQA attention of `h` over `src`, with RoPE at `pos` unless
        None (the encoder and cross-attention)."""
        Sq, Sk = h.shape[1], src.shape[1]
        q = (h @ a["w_q"].reshape(D, -1)).reshape(1, Sq, H, hd)
        k = (src @ a["w_k"].reshape(D, -1)).reshape(1, Sk, K, hd)
        v = (src @ a["w_v"].reshape(D, -1)).reshape(1, Sk, K, hd)
        if pos is not None:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        o = gqa_reference(q, k, v, mask)
        return o.reshape(1, Sq, H * hd) @ a["w_o"].reshape(H * hd, D)

    def mlp(p, x):
        m = p["mlp"]
        return x + swiglu(rms_norm(x, p["ln2"], eps), m["w_gate"],
                          m["w_up"], m["w_down"])
    ids = torch.tensor([list(tokens)], dtype=torch.long, device=device)
    x = params["embed"][ids]
    enc = None
    if embeds is not None and cfg.is_encoder_decoder:
        F = embeds.shape[0]
        e = embeds[None].to(x.dtype) + sinusoid_pos_embedding(
            F, D, device)[None].to(x.dtype)
        fpos = arange(F)
        for p in params["encoder"]:
            h = rms_norm(e, p["ln1"], eps)
            e = mlp(p, e + attend(p["attn"], h, h, build_mask(
                fpos, fpos, causal=False)))
        enc = rms_norm(e, params["enc_ln_f"], eps)
    elif embeds is not None:
        x = torch.cat([embeds[None].to(x.dtype), x], dim=1)
    S = x.shape[1]
    pos = arange(S)
    window = (cfg.sliding_window if cfg.attention == AttentionKind.SWA
              else 0)
    mask = build_mask(pos, pos, causal=True, window=window)
    bounds = [0]
    for n in chunks or [S]:
        bounds.append(bounds[-1] + n)
    spans = list(zip(bounds, bounds[1:]))
    for p in params["layers"]:
        h = rms_norm(x, p["ln1"], eps)
        if "mamba" in p:
            ys, state = [], (None, None)
            for lo, hi in spans:
                y, state = mamba_forward(h[:, lo:hi], p["mamba"], cfg.ssm,
                                         *state, scan=ssd_chunked)
                ys.append(y)
            x = x + torch.cat(ys, 1)
        elif cfg.attention == AttentionKind.MLA:
            x = x + _plain_mla(cfg, p["attn"], h, pos, mask)
        else:
            x = x + attend(p["attn"], h, h, mask, pos)
        if "xattn" in p:
            h = rms_norm(x, p["ln_x"], eps)
            x = x + attend(p["xattn"], h, enc, build_mask(
                torch.zeros_like(pos), torch.zeros_like(arange(F)),
                causal=False))
        if "moe" in p:
            h = rms_norm(x, p["ln2"], eps)
            x = x + torch.cat([moe_fn(h[:, lo:hi], p["moe"], cfg.moe)[0]
                               for lo, hi in spans], 1)
        elif "mlp" in p:
            x = mlp(p, x)
    x = rms_norm(x, params["ln_f"], eps)
    return logits_from_hidden(cfg, params,
                              x[0, -1] if at is None else x[0, list(at)])


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
    grant order) for the grants that complete a prompt, and to note the
    chunk lengths each prompt was prefilled in.  Returns the dicts
    ({rid: logits}, {rid: [chunk lengths]}) it fills."""
    seen, chunks = {}, {}
    inner = engine.finish_step

    def finish_step(now, dp_states):
        cres = engine._chunk_result or {}
        for d, grants in engine._grants.items():
            for (req, use), (_tok, lg) in zip(grants, cres.get(d, [])):
                chunks.setdefault(req.rid, []).append(use)
                if engine._consumed[req.rid] + use >= req.input_len:
                    seen[req.rid] = lg
        return inner(now, dp_states)

    engine.finish_step = finish_step
    return seen, chunks


def percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    k = (len(xs) - 1) * q
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def record_prefill_logits(srv):
    """Observe, without changing the engines, the logits each request's
    first token is sampled from on the P/D plane with dense prefill: the
    spec's `dense_prefill` (a chunk's graph replay, or its eager step)
    is wrapped to keep each chunk's logits on its worker thread and to
    count the dense chunks and those that replayed a graph, and each
    prefill engine's `_run_chunk` to take the logits of the chunk that
    sets a request's first token, noting each request's chunk lengths.
    Each chunk's TP collectives are kept too (a replay adds its
    capture's).  Returns ({rid: logits}, {rid: [chunk lengths]},
    {"chunks": n, "replayed": n, "tp_calls": [each chunk's {kind:
    calls}]}, undo), undo removing every wrapper."""
    import threading
    from repro_torch.distributed.transfer import count_collectives
    seen, chunks = {}, {}
    counts = {"chunks": 0, "replayed": 0, "tp_calls": []}
    count_lock = threading.Lock()
    last = threading.local()
    spec = srv.spec
    inner_step = spec.dense_prefill

    def dense_prefill(graphs, tokens, cache, row, at, work=None):
        before = None if graphs is None else graphs.replays
        with count_collectives() as st:
            logits = inner_step(graphs, tokens, cache, row, at, work)
        with count_lock:
            counts["chunks"] += 1
            counts["tp_calls"].append(dict(st.calls))
            if before is not None and graphs.replays == before + 1:
                counts["replayed"] += 1
        last.logits = logits[0]
        return logits

    for eng in srv.engines:
        def run_chunk(req, tok, _eng=eng, _inner=eng._run_chunk):
            ctx = _eng._ctx.get(req.rid)
            had = ctx is not None and ctx.first_token is not None
            last.logits = None
            out = _inner(req, tok)
            if tok:
                chunks.setdefault(req.rid, []).append(tok)
            ctx = _eng._ctx.get(req.rid)
            if not had and ctx is not None and ctx.first_token is not None:
                seen[req.rid] = last.logits
            return out
        eng._run_chunk = run_chunk
    spec.dense_prefill = dense_prefill

    def undo():
        del spec.dense_prefill
        for eng in srv.engines:
            del eng._run_chunk
    return seen, chunks, counts, undo


def check_replayed(tag, spec, counts, device):
    """With step graphs on the card, every dense prefill chunk of a serve
    must have replayed a graph (`record_prefill_logits`' counts)."""
    print(f"{tag} dense prefill chunks: {counts['chunks']}, replayed a "
          f"graph: {counts['replayed']}", flush=True)
    if (device != "cpu" and spec.step_graphs
            and counts["replayed"] != counts["chunks"]):
        raise AssertionError(f"{tag}: {counts['chunks'] - counts['replayed']}"
                             f" dense prefill chunks ran eagerly with step "
                             f"graphs on")


def replay_routes(cfg, params, prompt, chunks, max_len, device, spec=None):
    """The expert ids the served dense prefill of `prompt` chose, chunk-
    major (each chunk's MoE calls in layer order), and its last chunk's
    logits: an eager `prefill_chunk` over the served chunk boundaries
    into a fresh batch-1 cache (on a TP `spec`, the served form: its
    placed params over a row split over DP 0's ranks).  A served chunk
    replays a CUDA graph, whose `route` calls ran at its capture only; a
    replay computes what the eager step computes.  The kernel wrappers'
    launch counts are restored afterwards: these calls are not the
    serve's."""
    from repro_torch.models import moe
    out, inner = [], moe.route

    def route(x2d, p, mc):
        r = inner(x2d, p, mc)
        out.append(r[1])
        return r
    moe.route = route
    try:
        lg = eager_chunks_logits(cfg, params, prompt, chunks, max_len,
                                 device, spec)
    finally:
        moe.route = inner
    return out, lg


@contextlib.contextmanager
def uncounted():
    """Within it, the kernel wrappers' launches are not counted: their
    counts are restored on the way out (calls made to check a serve are
    not the serve's)."""
    from repro_torch.serving.step_graphs import _wrappers
    counters = _wrappers()
    launches = [w.launches for w in counters]
    try:
        yield
    finally:
        for w, n in zip(counters, launches):
            w.launches = n


def eager_chunks_logits(cfg, params, prompt, chunks, max_len, device,
                        spec=None):
    """The last chunk's last-position logits of an eager `prefill_chunk`
    over `chunks` (lengths) of `prompt` into a fresh batch-1 dense cache
    in the weights' dtype (a TP `spec`: the spec's placed params over
    its split row, `spec.request_cache`, as a TP prefill engine runs
    it), uncounted."""
    import torch
    from repro_torch.models.model import init_cache, prefill_chunk
    with uncounted():
        if spec is not None and spec.tp > 1:
            params, cache = spec.params, spec.request_cache(1)
        else:
            cache = init_cache(cfg, 1, max_len,
                               dtype=params["embed"].dtype, device=device)
        at = 0
        for n in chunks:
            ids = torch.tensor([list(prompt[at:at + n])], dtype=torch.int32,
                               device=device)
            lg, cache = prefill_chunk(cfg, params, ids, cache)
            at += n
    return lg[0]


def check_served(cfg, params, spec, srv, reqs, gens, first_logits, device,
                 tag, forward=dense_forward_logits, chunks=None,
                 info_forward=None, prefilled_before=0, prefix_cached=False,
                 routes=False, memo=None, exact_replay=None):
    """Every request finished with its tokens, the decode caches drained,
    and each first-token logits agree with a plain forward (`forward`,
    over the chunk boundaries `chunks` the serve used; with `routes`, a
    dense P/D serve of an MoE model, over the served expert sets, see
    `compare_first_logits`; with `exact_replay`, a hybrid's serve, the
    chain described there).  `info_forward`, if given, is another
    reference whose error is printed and returned, not checked.  With
    `prefix_cached` the pools keep published pages until they are
    evicted (`drain_prefix_pools`) and a prompt found whole in the cache
    runs no chunk: only the prompts with recorded logits are compared,
    and the prefilled tokens are not counted.  `memo` (a dict) keeps the
    plain references by (prompt, chunks) across the serves of one A/B.
    Returns (worst max|d|/max|ref|, argmax agreements, the worst error
    against `info_forward` or None)."""
    done = {g.rid: g for g in gens}
    if sorted(done) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{tag}: unfinished requests: {len(gens)} of "
                             f"{len(reqs)} finished")
    for r in reqs:
        if len(done[r.rid].tokens) != spec.target_len(r):
            raise AssertionError(f"{tag} request {r.rid}: "
                                 f"{len(done[r.rid].tokens)} tokens, "
                                 f"expected {spec.target_len(r)}")
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            if spec.paged:
                st.pool.check()
                if st.pool.used_count != 0 and not prefix_cached:
                    raise AssertionError(f"{tag}: the block pools did not "
                                         f"drain")
            if st.occupied():
                raise AssertionError(f"{tag}: the decode slots did not drain")
    if prefix_cached:
        reqs = [r for r in reqs if r.rid in first_logits]
    elif prefilled_tokens(srv) - prefilled_before != sum(r.input_len
                                                         for r in reqs):
        raise AssertionError(f"{tag}: prefill token count mismatch")
    return compare_first_logits(cfg, params, reqs, first_logits, device, tag,
                                forward, chunks, info_forward,
                                spec.max_len if routes else None, memo,
                                exact_replay, spec)


def prefilled_tokens(srv):
    """Prompt tokens the server's engines have prefilled so far."""
    return (sum(e.tokens_processed for e in srv.engines) if srv.engines
            else sum(e.prefill_tokens for e in srv.decode_engines))


def graph_stats(srv):
    """The compiled-step counters of every engine of `srv`, summed:
    graphs captured, replays, seconds spent capturing, bytes of the
    graphs' memory pools (None on the eager path)."""
    st = [e.graphs.stats() for e in [*srv.engines, *srv.decode_engines]
          if e.graphs is not None]
    if not st:
        return None
    return {k: sum(x[k] for x in st) for k in st[0]}


def graphs_report(srv, before):
    """`graph_stats` now, with the graphs captured and the replays made
    since `before` (the measured run's)."""
    now = graph_stats(srv)
    if now is None:
        return None
    return dict(now, graphs_in_run=now["graphs"] - before["graphs"],
                replays_in_run=now["replays"] - before["replays"],
                capture_s_in_run=now["capture_s"] - before["capture_s"])


@contextlib.contextmanager
def forced_routes(routes, n_chunks, n_moe, slices=None, chunk_major=False):
    """Within it, the calls of `repro_torch.models.moe.route` that a plain
    forward over `n_chunks` chunks makes (layer-major: each MoE layer's
    chunks in order; with `chunk_major`, each chunk's MoE layers in
    order, as an eager chunked prefill makes them) return the expert ids
    the served path chose in the same call (`routes`, chunk-major, as
    `replay_routes` returns them), weighted by this call's own router as
    `route` weights its own choice.  `slices[c]` is the number of `route`
    calls one MoE layer makes for chunk c (its token slices on the EP
    path; default 1).  Yields {"flips": (token, layer) pairs whose
    served expert set differs from this router's own, "pairs": pairs
    compared}."""
    import torch
    from repro_torch.models import moe
    slices = slices or [1] * n_chunks
    if len(routes) != sum(slices) * n_moe:
        raise AssertionError(f"{len(routes)} MoE calls recorded for "
                             f"{n_chunks} chunks of {n_moe} MoE layers")
    at = [sum(slices[:c]) * n_moe for c in range(n_chunks)]
    order = iter(routes if chunk_major else
                 [routes[at[c] + layer * slices[c] + j]
                  for layer in range(n_moe) for c in range(n_chunks)
                  for j in range(slices[c])])
    count = {"flips": 0, "pairs": 0}
    inner = moe.route

    def route(x2d, p, mc):
        _w, own, probs = inner(x2d, p, mc)
        top_e = next(order)
        top_w = torch.gather(probs, -1, top_e)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if mc.score_fn == "sigmoid":
            top_w = top_w * mc.routed_scaling
        count["flips"] += int((own.sort(-1).values != top_e.sort(-1).values)
                              .any(-1).sum())
        count["pairs"] += top_e.shape[0]
        return top_w, top_e, probs
    moe.route = route
    try:
        yield count
    finally:
        moe.route = inner


def compare_first_logits(cfg, params, reqs, first_logits, device, tag,
                         forward=dense_forward_logits, chunks=None,
                         info_forward=None, routes_max_len=None, memo=None,
                         exact_replay=None, spec=None):
    """Each request's first-token logits against a plain forward (see
    `check_served`); raises past LOGITS_REL_TOL.  With `routes_max_len`
    (the spec's max_len of a dense P/D serve of an MoE model), the plain
    forward's MoE layers use the served path's expert sets
    (`replay_routes`, then `forced_routes`), so that a near-tie the two
    routers break apart moves no logit; the flips this hides are
    printed, and how far the served logits lie from the eager replay's.
    With `exact_replay` (a list; a hybrid's serve, whose bf16 distance
    to the plain forward depends on where SBS split each prompt, PERF.md
    §6) the check is a chain instead: the served logits must
    equal that eager replay bit for bit, each (prompt, chunks, routes)
    is appended to the list for `check_fp32_replay` (the replay in fp32
    against the plain fp32 forward), and the bf16 distance to the plain
    forward is printed, not checked.  `memo` (a dict) keeps each
    (prompt, chunk lengths)'s plain reference (and replay) for later
    calls: the same prompt over the same chunks has the same reference.
    `spec`, a TP spec, makes the eager replay the served TP chunk.
    Returns (worst max|d|/max|ref|, argmax agreements, the worst error
    against `info_forward` or None)."""
    import torch
    worst, worst_at = 0.0, None
    agree = 0
    info = None if info_forward is None else 0.0
    chunks = chunks or {}
    n_moe = sum("moe" in p for p in params["layers"])
    flips = {"flips": 0, "pairs": 0}
    replay_d = 0.0
    memo = {} if memo is None else memo
    for r in reqs:
        got = first_logits.get(r.rid)
        prompt = r.tokens[:r.input_len]
        key = (tuple(prompt), tuple(chunks.get(r.rid) or ()))
        if key not in memo:
            if routes_max_len is None:
                memo[key] = (forward(cfg, params, prompt, device,
                                     chunks.get(r.rid)), None, None)
            else:
                routes, eager = replay_routes(cfg, params, prompt,
                                              chunks[r.rid], routes_max_len,
                                              device, spec)
                with forced_routes(routes, len(chunks[r.rid]), n_moe) as n:
                    ref = forward(cfg, params, prompt, device, chunks[r.rid])
                memo[key] = (ref, eager, dict(n))
                if exact_replay is not None:
                    exact_replay.append((prompt, list(chunks[r.rid]),
                                         routes))
        ref, eager, n = memo[key]
        if routes_max_len is not None:
            if got is not None:
                replay_d = max(replay_d, float((got.float() - eager.float())
                                               .abs().max()))
                if exact_replay is not None and not torch.equal(got, eager):
                    raise AssertionError(
                        f"{tag} request {r.rid}: served first-token logits "
                        f"differ from the eager replay of the served chunks "
                        f"(max|d|={replay_d!r})")
            flips = {k: flips[k] + n[k] for k in flips}
        if got is None or got.shape != (cfg.vocab_size,) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"{tag} request {r.rid}: bad first-token "
                                 f"logits")
        rel = float((got.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
        if rel >= worst:
            worst_at = f"request {r.rid}, chunks {chunks.get(r.rid)}"
        worst = max(worst, rel)
        agree += int(int(got.argmax()) == int(ref.argmax()))
        if info_forward is not None:
            alt = info_forward(cfg, params, prompt, device).float()
            info = max(info, float((got.float() - alt).abs().max()
                                   / alt.abs().max()))
    limit = ("not checked: the check is the bit-exact replay, then the "
             "fp32 replay" if exact_replay is not None
             else f"tol {LOGITS_REL_TOL}")
    print(f"{tag} first-token logits vs plain forward: worst "
          f"max|d|/max|ref|={worst:.3e} ({worst_at}; {limit}),"
          f" argmax agrees on {agree}/{len(reqs)}", flush=True)
    if routes_max_len is not None:
        print(f"{tag} the plain forward replayed the served expert sets: "
              f"{flips['flips']} of {flips['pairs']} (token, layer) pairs "
              f"differ from its own router's choice; served first-token "
              f"logits vs the eager replay of the served chunks: max|d|="
              f"{replay_d!r}", flush=True)
    if info is not None:
        print(f"{tag} (not checked) vs {info_forward.__name__}: worst "
              f"max|d|/max|ref|={info:.3e}", flush=True)
    if exact_replay is not None:
        print(f"{tag} served first-token logits equal the eager replay of "
              f"the served chunks bit for bit: True", flush=True)
    elif not worst <= LOGITS_REL_TOL:
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


def pd_scfg(block_size=0):
    """The P/D serve's deployment (`block_size` > 0: on the paged plane).
    SBS's flow control rejects a prompt
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
        max_batch_per_dp=MAX_BATCH, block_size=block_size, n_limit=64)


def dispatch_bursts_whole(srv, n):
    """Hold the decode scheduler's first dispatch of every run until all
    `n` requests of the burst are buffered: they arrive at the same
    instant but as one event each, and SBS would otherwise place the
    first alone and the rest a batching window later, at a step count
    that depends on step time.  So every run admits the same set at
    once, and the unified engine's steps (grants formed step by step,
    FIFO) are the same whatever a step costs."""
    sched = srv.dsched
    inner = sched.poll

    def poll(now):
        if sched._last == -math.inf and len(sched.buffer) < n:
            return None
        return inner(now)
    sched.poll = poll


def serve(cfg, params, device, counters, n_requests=N_REQUESTS,
          lens=(128, 1024), outs=(16, 32), tag="[serve]", step_graphs=True,
          profile=True):
    """Drive the unified mixed-batch plane with 8 requests arriving at
    once; returns the serve report.  The burst, dispatched whole
    (`dispatch_bursts_whole`), makes the engine's step sequence
    independent of how long a step takes, so a run with step graphs and
    one without (`step_graphs=False`) do the same work.  With step graphs the
    measured server first serves the same requests once, capturing
    the chunk graphs this traffic needs; the measured and the profiled
    runs replay them.  `counters` are the kernel wrappers whose launch
    counts the run reads (set to 0 just before the measured run).  The
    first-token logits are held against `dense_forward_logits` over the
    chunks the serve ran (they matter for an MoE model's expert
    capacity).  The size arguments let the same code rehearse on the
    CPU with a reduced config.  With `profile=False` the report's
    "profile" is None and "profile_run" a function that makes one
    profiled run on the same server (`serve_modes` interleaves them)."""
    import torch
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    scfg = mixed_scfg()
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=BLOCK,
                      decode_slots=scfg.resolved_decode_slots, device=device,
                      step_graphs=step_graphs)

    def requests():
        return make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs,
                             burst=True)
    t0 = time.monotonic()
    srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec)
    build_s = time.monotonic() - t0
    dispatch_bursts_whole(srv, n_requests)
    # warm-up run: cuBLAS handles, the allocator and, with step graphs,
    # the chunk graphs of this traffic
    srv.serve(requests(), timeout=600)
    eng = srv.decode_engines[0]
    mark = (eng.steps, len(eng.itl), len(eng.step_samples), eng.mixed_steps,
            prefilled_tokens(srv))
    g0 = graph_stats(srv)
    first_logits, chunks = record_first_logits(eng)
    reqs = requests()
    if device != "cpu":
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    gens = srv.serve(reqs, timeout=600)
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    graphs = graphs_report(srv, g0)
    worst, agree, _ = check_served(cfg, params, spec, srv, reqs, gens,
                                   first_logits, device, tag,
                                   chunks=chunks, prefilled_before=mark[4])
    ttft = [g.ttft for g in gens]
    steps = eng.steps - mark[0]
    itl = eng.itl[mark[1]:]
    durs = [d for d, _a, _r in eng.step_samples[mark[2]:]]
    prefill_chunks = {r.rid: list(chunks.get(r.rid) or []) for r in reqs}

    def profile_run():
        return profile_serve(lambda: srv, cfg, None, None, None, device,
                             waves=lambda: [requests()])
    rep = {
        "plane": "unified mixed-batch, paged", "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "mode": "step graphs" if step_graphs else "eager",
        "traffic": "8 requests at t = 0",
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens], "wall_s": wall,
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(itl, 0.5),
        "itl_p99_s": percentile(itl, 0.99),
        "steps": steps, "mixed_steps": eng.mixed_steps - mark[3],
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "logits_rel_err": worst, "argmax_agree": agree,
        "peak_memory_bytes": peak, "server_build_s": build_s,
        "graphs": graphs,
        "prefill_chunks": prefill_chunks,
        "profile": profile_run() if profile else None,
    }
    if not profile:
        rep["profile_run"] = profile_run
    return rep


def serve_modes(cfg, params, device, counters, tag, runs=2):
    """The graphs-vs-eager A/B of a unified serve: `serve` with step
    graphs and eagerly, each on its own server after its own warm-up and
    measured run, then their profiled runs interleaved (graph, eager,
    graph, eager, ...: `runs` of each), so that both modes meet the
    card in the same states; `compare_modes` holds the medians.  Each
    report's "profile" is its mode's last run.  Returns (graph report,
    eager report)."""
    graph = serve(cfg, params, device, counters, tag=tag, profile=False)
    eager = serve(cfg, params, device, counters, tag=f"{tag[:-1]} eager]",
                  step_graphs=False, profile=False)
    prof = {True: [], False: []}
    if device != "cpu":             # "cpu": a rehearsal, no profile
        for _ in range(runs):
            for mode, rep in ((True, graph), (False, eager)):
                prof[mode].append(rep["profile_run"]())
    for mode, rep in ((True, graph), (False, eager)):
        del rep["profile_run"]
        rep["profile"] = prof[mode][-1] if prof[mode] else None
    graph["ab"] = compare_modes(tag, graph, eager, device,
                                runs=(prof[True], prof[False]))
    return graph, eager


def serve_pd(cfg, params, device, counters, n_requests=N_REQUESTS,
             lens=(128, 1024), outs=(16, 32), tag="[pd serve]",
             forward=dense_forward_logits, info_forward=None,
             launched=("decode_attention", "flash_prefill"),
             step_graphs=True, scheduler="sbs-la", burst=False,
             profile=True, keep=None, block_size=0, routes=False,
             hold=False, exact_replay=None):
    """Drive the P/D-separated deployment on the padded plane, or with
    `block_size` > 0 on the paged plane (requests 50 ms apart, or with
    `burst` all at t = 0, with `hold` the decode joins placed together,
    `hold_handoffs_whole`); returns the serve report (as `serve`).  With `step_graphs` every decode step and dense
    prefill chunk replays a graph (each server captures its decode
    steps and its full 256-token chunk when it is built, a chunk of
    another length at its first use), and every dense chunk must have
    replayed one; `step_graphs=False` serves eagerly.  The measured
    server first serves the same requests once (cuBLAS handles, the
    allocator and the chunk lengths this traffic gives; which lengths
    the measured run gives depends on step times, and the graphs it
    still captures are reported), and the profiled run is a third serve
    of them on the same server.
    `forward` is the plain reference of the first-token logits, run
    over the serve's chunk boundaries; `info_forward` an unchecked
    second one (see `check_served`).  On the card every wrapper named in
    `launched` must run and every other one of `counters` must not.
    `profile=False` skips the profiled second run; `keep`, a dict,
    receives the first-token logits by rid; `routes` replays the served
    expert sets in the plain forward (an MoE model, `check_served`);
    `exact_replay`, a list, makes the logits check a hybrid's chain
    (`compare_first_logits`)."""
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    scfg = pd_scfg(block_size)
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=block_size,
                      decode_slots=(scfg.resolved_decode_slots
                                    if block_size else 0),
                      device=device, step_graphs=step_graphs)

    def requests():
        return make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs,
                             burst=burst)
    t0 = time.monotonic()
    srv = RealSBSServer(cfg, params, scfg, scheduler=scheduler, spec=spec)
    build_s = time.monotonic() - t0
    if hold:
        hold_handoffs_whole(srv, n_requests)
    srv.serve(requests(), timeout=600)
    eng = srv.decode_engines[0]
    mark = (eng.steps, len(eng.itl), len(eng.step_samples),
            sum(e.passes for e in srv.engines), prefilled_tokens(srv))
    g0 = graph_stats(srv)
    first_logits, chunks, counts, undo = record_prefill_logits(srv)
    reqs = requests()
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    try:
        gens = srv.serve(reqs, timeout=600)
    finally:
        undo()
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    graphs = graphs_report(srv, g0)
    worst, agree, info = check_served(cfg, params, spec, srv, reqs, gens,
                                      first_logits, device, tag, forward,
                                      chunks, info_forward,
                                      prefilled_before=mark[4],
                                      routes=routes,
                                      exact_replay=exact_replay)
    check_replayed(tag, spec, counts, device)
    for name, n in launches.items():
        if name in launched and device != "cpu" and n <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
        if name not in launched and n != 0:
            raise AssertionError(f"{tag}: {name} launched {n} times")
    if keep is not None:
        keep.update(first_logits)
    steps = eng.steps - mark[0]
    itl = eng.itl[mark[1]:]
    passes = sum(e.passes for e in srv.engines) - mark[3]
    ttft = [g.ttft for g in gens]
    durs = [d for d, _a, _r in eng.step_samples[mark[2]:]]
    rows = [{"rows": e.rows.n * len(e.rows.caches), "grown": e.rows.grown,
             "pool_bytes": e.rows.nbytes()} for e in srv.engines]
    t_fwd = srv.state.interval.t_fwd
    prof = None
    if profile:
        prof = profile_serve(lambda: srv, cfg, None, None, None, device,
                             waves=lambda: [requests()])
    return {
        "plane": "P/D, paged decode" if block_size else "P/D, padded decode",
        "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "mode": "step graphs" if step_graphs else "eager",
        "scheduler": scheduler,
        "traffic": (f"{n_requests} requests at t = 0" if burst
                    else f"{n_requests} requests 50 ms apart"),
        "graphs": graphs, "server_build_s": build_s,
        "prefill_graph_stats": [e.graphs.stats() for e in srv.engines
                                if e.graphs is not None],
        "dense_rows": rows, "dense_chunks": counts,
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens], "wall_s": wall,
        "tokens": {g.rid: g.tokens for g in gens},
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(itl, 0.5),
        "itl_p99_s": percentile(itl, 0.99),
        "t_fwd_s": t_fwd,
        "decode_steps": steps, "prefill_passes": passes,
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "launches": launches,
        "decode_attention_per_decode_step":
            launches.get("decode_attention", 0) / max(steps, 1),
        "flash_prefill_per_prefill_pass":
            launches.get("flash_prefill", 0) / max(passes, 1),
        "ssd_chunk_per_prefill_pass":
            launches.get("ssd_chunk", 0) / max(passes, 1),
        "logits_rel_err": worst, "argmax_agree": agree,
        "logits_checked_by": ("replay" if exact_replay is not None
                              else "plain forward"),
        "logits_rel_err_unchecked_reference": info,
        "prefill_chunks": {r.rid: chunks.get(r.rid) for r in reqs},
        "profile": prof,
    }


def report_pd_modes(tag, graph, eager):
    """T_fwd, TTFT and ITL of a P/D serve with step graphs and eagerly,
    side by side (the same traffic; its chunks depend on step times)."""
    for key in ("t_fwd_s", "wall_s", "ttft_p50_s", "ttft_p99_s",
                "itl_p50_s", "itl_p99_s", "step_p50_s", "step_p99_s"):
        print(f"{tag} graphs vs eager {key}: graphs={graph[key]!r} "
              f"eager={eager[key]!r}", flush=True)
    print(f"{tag} prefill engines with graphs: "
          f"{graph['prefill_graph_stats']!r}; dense rows "
          f"{graph['dense_rows']!r}", flush=True)


def serve_pd_bits(cfg, params, device, counters, tag="[pd serve bits]",
                  **kw):
    """The graphs-vs-eager A/B of the P/D serve: its 8 requests all at
    t = 0 under `immediate`, so that every arrival is bound to a prefill
    instance at once and each pass takes its queue in order (the chunk
    boundaries do not depend on step times; the padded decode rows never
    interact; rows whose MoE layers share expert capacity in a paged
    decode step need `hold=True`), served with step graphs and eagerly.
    Every request's chunks, tokens and first-token logits must be
    identical, bit for bit.  `kw` goes to `serve_pd`.  Returns the A/B's
    report."""
    import torch
    reps, logits = {}, {}
    for graphs in (True, False):
        logits[graphs] = {}
        reps[graphs] = serve_pd(
            cfg, params, device, counters,
            tag=f"{tag[:-1]} {'graphs' if graphs else 'eager'}]",
            step_graphs=graphs, scheduler="immediate", burst=True,
            profile=False, keep=logits[graphs], **kw)
        if device != "cpu":
            free_device_memory()
    g, e = reps[True], reps[False]
    same_chunks = g["prefill_chunks"] == e["prefill_chunks"]
    same_tokens = g["tokens"] == e["tokens"]
    diff = max(float((logits[True][r] - logits[False][r]).abs().max())
               for r in logits[True])
    same_logits = all(torch.equal(logits[True][r], logits[False][r])
                      for r in logits[True])
    print(f"{tag} graphs vs eager on the same chunks: chunks "
          f"equal {same_chunks}, tokens equal {same_tokens}, first-token "
          f"logits bit-identical {same_logits} (max|d|={diff!r}); wall "
          f"graphs={g['wall_s']!r} eager={e['wall_s']!r}; ttft_p99 "
          f"graphs={g['ttft_p99_s']!r} eager={e['ttft_p99_s']!r}",
          flush=True)
    if not (same_chunks and same_tokens and same_logits):
        raise AssertionError(f"{tag}: the graph and eager serves differ")
    return {"same_chunks": same_chunks, "same_tokens": same_tokens,
            "same_first_logits": same_logits, "max_abs_logit_diff": diff,
            "graphs": {k: g[k] for k in ("wall_s", "ttft_p50_s",
                                         "ttft_p99_s", "itl_p99_s",
                                         "dense_chunks", "graphs")},
            "eager": {k: e[k] for k in ("wall_s", "ttft_p50_s", "ttft_p99_s",
                                        "itl_p99_s", "dense_chunks")}}


def prefix_scfg():
    """The shared-prefix P/D serve's deployment: one prefill instance
    (SBS staggers windows per instance, so with one instance a repeat
    lands on the binder that holds its pages) × 2 DP units, 256-token
    chunks; one decode instance × 2 DP units of 16-token pages; n_limit
    as in `pd_scfg`."""
    from repro_torch.config.base import ServingConfig
    return ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=PD_CHUNK, t_default=0.05, l_net=0.001,
        max_batch_per_dp=MAX_BATCH, block_size=BLOCK, n_limit=64)


def make_prefix_waves(cfg, seed, prefix=512, suffixes=(64, 448),
                      unrelated=1024, outs=(16, 32)):
    """Two waves of 8 requests, 50 ms apart: six prompts sharing a
    `prefix`-token system prompt with distinct suffixes (the first, and
    shortest, of `suffixes[0]` tokens, the rest drawn from the range),
    one unrelated prompt of `unrelated` tokens, and an exact repeat of
    the first prompt.  Wave 2 repeats wave 1's prompts (rids 8-15).
    The first prompt's request is interactive (priority 0), the rest
    priority 1: PBAA grants chunks by priority, then longest remaining
    prompt first, so at one priority the shortest prompt's last chunks
    wait behind the backlog's longer prompts and its repeat is
    dispatched before it completes: wave 1 would have no full hit once
    passes are slower than the arrivals.  Returns a function of the
    wave index (fresh Request objects)."""
    from repro_torch.core.types import Request
    rng = random.Random(seed)
    lens = [suffixes[0]] + [rng.randrange(suffixes[0], suffixes[1] + 1)
                            for _ in range(5)]
    new = [rng.randrange(outs[0], outs[1] + 1) for _ in range(8)]
    head = [rng.randrange(cfg.vocab_size) for _ in range(prefix)]
    prompts = [head + [rng.randrange(cfg.vocab_size) for _ in range(n)]
               for n in lens]
    prompts.append([rng.randrange(cfg.vocab_size) for _ in range(unrelated)])
    prompts.append(list(prompts[0]))

    def wave(w):
        return [Request(rid=8 * w + i, arrival_time=0.05 * i,
                        input_len=len(p), output_len=new[i], tokens=tuple(p),
                        priority=0 if i == 0 else 1)
                for i, p in enumerate(prompts)]
    return wave


def record_paged_prefill_logits(srv):
    """The page-native counterpart of `record_prefill_logits`: wraps the
    spec's `paged_prefill` (a chunk's graph replay, or its eager step)
    to keep the last chunk's logits and each prefill engine's
    `_run_chunk` to take them for the chunk that sets a request's first
    token (a full hit runs no chunk and records none), noting each
    request's chunk lengths.  Returns ({rid: logits}, {rid: [chunk
    lengths]}, undo)."""
    seen, chunks, last = {}, {}, {}
    spec = srv.spec
    inner_step = spec.paged_prefill

    def paged_prefill(graphs, tokens, cache, slot, unit=0):
        logits, new = inner_step(graphs, tokens, cache, slot, unit)
        last["logits"] = logits[0]
        return logits, new

    for eng in srv.engines:
        def run_chunk(req, tok, _eng=eng, _inner=eng._run_chunk):
            ctx = _eng._pctx[req.rid]
            had = ctx.first_token is not None
            last.pop("logits", None)
            out = _inner(req, tok)
            if tok:
                chunks.setdefault(req.rid, []).append(tok)
            if not had and ctx.first_token is not None:
                seen[req.rid] = last["logits"]
            return out
        eng._run_chunk = run_chunk
    spec.paged_prefill = paged_prefill

    def undo():
        del spec.paged_prefill
        for eng in srv.engines:
            del eng._run_chunk
    return seen, chunks, undo


def stats_since(now, base):
    """`prefix_stats()` counted from the snapshot `base` on."""
    out = {k: v - base[k] for k, v in now.items() if k != "prefix_hit_rate"}
    seen = out["prefix_seen_tokens"]
    out["prefix_hit_rate"] = out["prefix_hit_tokens"] / seen if seen else 0.0
    return out


def drain_prefix_pools(srv, tag):
    """Evict every binder of `srv`; every prefill and decode pool must
    then pass its conservation check and hold no page."""
    pools = [(e.binder, e.pool) for e in srv.engines]
    pools += [(st.binder, st.pool) for e in srv.decode_engines
              for st in e._dp.values()]
    for binder, pool in pools:
        binder.ensure_free(pool.num_blocks - 1)
        pool.check()
        if pool.used_count != 0:
            raise AssertionError(f"{tag}: {pool.used_count} pages still held "
                                 f"after eviction")
    return len(pools)


def serve_pd_prefix(cfg, params, device, counters, prefix=512,
                    suffixes=(64, 448), unrelated=1024, outs=(16, 32),
                    tag="[pd prefix serve]",
                    launched=("paged_decode_attention",
                              "paged_prefill_attention")):
    """Drive the P/D deployment on the paged plane with prefix_cache=True
    under sbs-la: two waves (`make_prefix_waves`) on one server.  Checks
    that all 16 requests finish, that pages are reused on both planes
    (hit tokens, a full hit in wave 1, shared decode pages, copy-on-write
    copies) and wave 2 runs no chunk, the first-token logits of every
    computed prompt against a plain forward, each full hit's replayed
    first token against its original's, launches (on the card every
    wrapper named in `launched` runs — for a GQA model #1 and #2's paged
    entry — and every other one of `counters` does not) and that every
    pool empties after eviction.  Returns the serve report."""
    import torch
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    scfg = prefix_scfg()
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=BLOCK,
                      decode_slots=scfg.resolved_decode_slots, device=device)
    waves = make_prefix_waves(cfg, 7, prefix, suffixes, unrelated, outs)
    srv = RealSBSServer(cfg, params, scfg, scheduler="sbs-la", spec=spec,
                        prefix_cache=True)
    # warm-up: both waves once (cuBLAS handles, the allocator and the
    # chunk graphs of this traffic), then every binder evicted, so the
    # measured waves start from empty prefix caches and pools, as on a
    # new server
    for w in (0, 1):
        srv.serve(waves(w), timeout=600)
    drain_prefix_pools(srv, tag)
    if device != "cpu":
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
    eng = srv.decode_engines[0]
    mark = (eng.steps, len(eng.itl), len(eng.step_samples),
            sum(e.passes for e in srv.engines))
    base = srv.prefix_stats()
    g0 = graph_stats(srv)
    first_logits, chunks, undo = record_paged_prefill_logits(srv)
    reqs = [waves(0), waves(1)]
    gens, walls, stats = [], [], []
    for w in counters:
        w.launches = 0
    try:
        for wave in reqs:
            t0 = time.monotonic()
            gens.append(srv.serve(wave, timeout=600))
            walls.append(time.monotonic() - t0)
            stats.append(stats_since(srv.prefix_stats(), base))
    finally:
        undo()
    launches = {w.__name__: w.launches for w in counters}
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else None)
    graphs = graphs_report(srv, g0)
    flat = [r for wave in reqs for r in wave]
    done = {g.rid: g for wave in gens for g in wave}
    if sorted(done) != [r.rid for r in flat]:
        raise AssertionError(f"{tag}: unfinished requests: {len(done)} of "
                             f"{len(flat)} finished")
    for r in flat:
        if len(done[r.rid].tokens) != spec.target_len(r):
            raise AssertionError(f"{tag} request {r.rid}: "
                                 f"{len(done[r.rid].tokens)} tokens, "
                                 f"expected {spec.target_len(r)}")
    s1, s2 = stats
    if not (s2["prefix_hit_tokens"] > 0 and s1["prefill_full_hits"] >= 1
            and s2["decode_blocks_shared"] > 0
            and s2["decode_cow_copies"] > 0):
        raise AssertionError(f"{tag}: no page reuse: wave 1 {s1}, "
                             f"after wave 2 {s2}")
    for eng in srv.decode_engines:
        for st in eng._dp.values():
            if st.occupied():
                raise AssertionError(f"{tag}: the decode slots did not "
                                     f"drain")
    # a full hit ran no chunk: its first token is the one its prompt's
    # original produced (wave 1's first prompt for the repeat, index 7)
    computed = [r for r in flat if r.rid in first_logits]
    hits = [r for r in flat if r.rid not in first_logits]
    for r in hits:
        if chunks.get(r.rid):
            raise AssertionError(f"{tag} request {r.rid}: chunks ran but no "
                                 f"first-token logits were recorded")
        i = r.rid % 8
        orig = 0 if i == 7 else i
        if done[r.rid].tokens[0] != done[orig].tokens[0]:
            raise AssertionError(f"{tag} request {r.rid}: replayed first "
                                 f"token {done[r.rid].tokens[0]} != "
                                 f"{done[orig].tokens[0]}")
    if len(hits) != s2["prefill_full_hits"]:
        raise AssertionError(f"{tag}: {len(hits)} requests ran no chunk, "
                             f"{s2['prefill_full_hits']} full hits counted")
    ran = [r.rid for r in reqs[1] if chunks.get(r.rid)]
    if ran:
        raise AssertionError(f"{tag}: wave 2 ran chunks for {ran}")
    worst, agree, _ = compare_first_logits(cfg, params, computed,
                                           first_logits, device, tag)
    n_pools = drain_prefix_pools(srv, tag)
    for name, n in launches.items():
        if name in launched and device != "cpu" and n <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
        if name not in launched and n != 0:
            raise AssertionError(f"{tag}: {name} launched {n} times")
    steps = eng.steps - mark[0]
    itl = eng.itl[mark[1]:]
    passes = sum(e.passes for e in srv.engines) - mark[3]
    durs = [d for d, _a, _r in eng.step_samples[mark[2]:]]
    ttft = [[done[r.rid].ttft for r in wave] for wave in reqs]
    profile = profile_serve(lambda: srv, cfg, None, None, None, device,
                            waves=lambda: [waves(0), waves(1)])
    drain_prefix_pools(srv, tag)
    return {
        "plane": "P/D, paged, prefix_cache", "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "mode": "step graphs", "graphs": graphs,
        "traffic": "two waves of 8 requests 50 ms apart",
        "requests": len(flat), "prompt_tokens": [r.input_len for r in flat],
        "new_tokens": [len(done[r.rid].tokens) for r in flat],
        "wall_s": sum(walls), "wall_s_per_wave": walls,
        "ttft_p50_s_per_wave": [percentile(t, 0.5) for t in ttft],
        "ttft_p99_s_per_wave": [percentile(t, 0.99) for t in ttft],
        "itl_p50_s": percentile(itl, 0.5),
        "itl_p99_s": percentile(itl, 0.99),
        "decode_steps": steps, "prefill_passes": passes,
        "step_p50_s": percentile(durs, 0.5), "step_p99_s": percentile(durs, 0.99),
        "prefix_stats_wave1": s1, "prefix_stats": s2,
        "computed_prompts": len(computed), "full_hits": len(hits),
        "pools_emptied": n_pools, "peak_memory_bytes": peak,
        "launches": launches,
        "paged_decode_attention_per_decode_step":
            launches["paged_decode_attention"] / max(steps, 1),
        "paged_prefill_attention_per_prefill_pass":
            launches["paged_prefill_attention"] / max(passes, 1),
        "logits_rel_err": worst, "argmax_agree": agree,
        "prefill_chunks": {r.rid: chunks.get(r.rid) for r in flat},
        "profile": profile,
    }


def route_flips(cfg, params, reqs, chunks, device):
    """Expert routing of each prompt on the served path and on the plain
    forward: replays the prompt's prefill chunks (`chunks`, the lengths
    the serve ran) through `paged_prefill_step` on a fresh paged cache
    (the step the unified plane runs for a granted chunk, through kernel
    #2's paged entry) and runs `dense_forward_logits` over the same
    chunks, with `repro_torch.models.moe.route` wrapped to keep each
    call's expert ids.  Returns (flips: (token, layer) pairs whose expert
    sets differ, pairs compared, per prompt the dropped (token, expert)
    pairs of each chunk summed over layers on the served path, and on
    the plain path)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import init_paged_cache, paged_prefill_step
    E = cfg.moe.num_experts
    n_moe = sum("moe" in p for p in params["layers"])
    nbt = MAX_LEN // BLOCK
    calls = []
    inner = moe.route

    def route(x2d, p, mc):
        out = inner(x2d, p, mc)
        calls.append(out[1].sort(dim=-1).values)
        return out

    def drops(top_e, C):
        n = torch.bincount(top_e.reshape(-1), minlength=E)
        return int((n - C).clamp_min(0).sum())

    flips = pairs = 0
    served_drops, plain_drops = {}, {}
    moe.route = route
    try:
        for r in reqs:
            ch = chunks[r.rid]
            cache = init_paged_cache(cfg, 1, nbt + 1, MAX_LEN, BLOCK,
                                     dtype=params["embed"].dtype,
                                     device=device)
            cache["block_tab"] = torch.arange(
                1, nbt + 1, dtype=torch.int32, device=device)[None]
            at = 0
            for n in ch:
                ids = torch.tensor([r.tokens[at:at + n]], dtype=torch.int32,
                                   device=device)
                _lg, cache = paged_prefill_step(cfg, params, ids, cache, 0)
                at += n
            served = calls[:]
            calls.clear()
            dense_forward_logits(cfg, params, r.tokens[:r.input_len], device,
                                 ch)
            plain = calls[:]
            calls.clear()
            sd, pd = [0] * len(ch), [0] * len(ch)
            for c, n in enumerate(ch):
                C = moe.capacity(n, cfg.moe)
                for l in range(n_moe):
                    a = served[c * n_moe + l]         # chunk-major
                    b = plain[l * len(ch) + c]        # layer-major
                    flips += int((a != b).any(dim=-1).sum())
                    pairs += n
                    sd[c] += drops(a, C)
                    pd[c] += drops(b, C)
            served_drops[r.rid], plain_drops[r.rid] = sd, pd
    finally:
        moe.route = inner
    return flips, pairs, served_drops, plain_drops


def report_serve(tag, rep):
    """The serve's end-to-end figures, each on a line of its own."""
    prof = rep["profile"] or {}
    ttft = (f"ttft_p50_s={rep['ttft_p50_s']!r} "
            f"ttft_p99_s={rep['ttft_p99_s']!r}" if "ttft_p50_s" in rep else
            " ".join(f"wave {w + 1}: ttft_p50_s={a!r} ttft_p99_s={b!r}"
                     for w, (a, b) in enumerate(zip(
                         rep["ttft_p50_s_per_wave"],
                         rep["ttft_p99_s_per_wave"]))))
    print(f"{tag} {ttft}", flush=True)
    print(f"{tag} itl_p50_s={rep['itl_p50_s']!r} "
          f"itl_p99_s={rep['itl_p99_s']!r}", flush=True)
    print(f"{tag} wall_s={rep['wall_s']!r}", flush=True)
    print(f"{tag} step_p50_s={rep['step_p50_s']!r} "
          f"step_p99_s={rep['step_p99_s']!r}", flush=True)
    print(f"{tag} device_busy_s={prof.get('device_busy_s')!r} "
          f"idle_share={prof.get('idle_share')!r} (profiled run, "
          f"wall_s={prof.get('wall_s')!r})", flush=True)
    print(f"{tag} device_s_by_group={prof.get('by_group_s')!r}", flush=True)
    print(f"{tag} peak_memory_bytes={rep.get('peak_memory_bytes')!r}",
          flush=True)
    print(f"{tag} launches={rep['launches']!r}", flush=True)
    print(f"{tag} mode={rep['mode']} graphs={rep['graphs']!r}", flush=True)


def compare_modes(tag, graph, eager, device="cuda", runs=None):
    """The A/B of one serve: its figures with step graphs and eagerly,
    side by side.  Both runs must have done the same work (the same
    steps and prefill chunks, which the burst traffic makes
    independent of step time), and their profiles must show that work
    whole: the trace must hold the kernels the graphs launch, else the
    graph run's idle share would read too high.  So the median over a
    mode's profiled runs (`runs`: the graph runs and the eager runs,
    which `serve_modes` interleaves; default each report's one profile)
    of the device time of the named groups (the matmuls and the repo's
    kernels, which run only inside graphs in graph mode) must be within
    5% of the eager one; every run's figures are printed.  The total busy time, the device op counts and the eager
    run's ten longest kernels in both runs are printed beside it but
    not held to 5%: the same launches of the small elementwise and copy
    kernels ("other") take a few percent less device time each replayed
    back to back than issued one by one with host gaps between them,
    and a graph run adds some copies into its static inputs."""
    same = (graph["steps"] == eager["steps"]
            and graph["prefill_chunks"] == eager["prefill_chunks"])
    for key in ("wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
                "itl_p99_s", "step_p50_s", "step_p99_s"):
        print(f"{tag} A/B {key}: graphs={graph[key]!r} eager={eager[key]!r}",
              flush=True)
    if runs is None:
        runs = tuple([r["profile"]] if r["profile"] else []
                     for r in (graph, eager))
    gp, ep = graph["profile"] or {}, eager["profile"] or {}

    def median(xs):
        return statistics.median(xs) if xs else None

    def named_s(p):
        return sum(v for k, v in p["by_group_s"].items() if k != "other")
    gb, eb = (median([p["device_busy_s"] for p in r]) for r in runs)
    for mode, r in zip(("graphs", "eager"), runs):
        for i, p in enumerate(r):
            print(f"{tag} A/B profiled run {i + 1} {mode}: device_busy_s="
                  f"{p['device_busy_s']!r} named groups device_s="
                  f"{named_s(p)!r} idle_share={p['idle_share']!r}",
                  flush=True)
    print(f"{tag} A/B device_busy_s (median of {len(runs[0])} and "
          f"{len(runs[1])} runs): graphs={gb!r} eager={eb!r}; "
          f"idle_share: graphs={gp.get('idle_share')!r} "
          f"eager={ep.get('idle_share')!r}; same steps and chunks: {same}",
          flush=True)
    # the trace's kernel groups: kernel #1, and #2 (both of its entries
    # share the kernel's name), in every graph run
    attn = ("paged_decode_attention", "flash_prefill")
    seen = bool(runs[0]) and all(p["by_group_s"].get(k, 0.0) > 0
                                 for p in runs[0] for k in attn)
    print(f"{tag} A/B the trace holds graph-launched kernels (attention "
          f"kernels run only inside graphs in graph mode): {seen}",
          flush=True)
    if not same:
        raise AssertionError(f"{tag}: the graph and eager runs did different "
                             f"work: steps {graph['steps']} vs "
                             f"{eager['steps']}")
    named = None
    if device != "cpu":                 # "cpu": a rehearsal, no profile
        if gb is None or eb is None:
            raise AssertionError(f"{tag}: a run's profile holds no device "
                                 f"time (graphs {gb}, eager {eb})")
        gn, en = (median([named_s(p) for p in r]) for r in runs)
        named = [gn, en]
        print(f"{tag} A/B device_s of the named groups (medians): graphs="
              f"{gn!r} eager={en!r}; of 'other' (last runs): graphs="
              f"{gp['by_group_s'].get('other')!r} "
              f"eager={ep['by_group_s'].get('other')!r}; device ops: "
              f"graphs={gp['device_ops']} eager={ep['device_ops']}",
              flush=True)
        gt = {k["name"]: k for k in gp["top_kernels"]}
        for k in ep["top_kernels"]:
            g = gt.get(k["name"], {})
            print(f"{tag} A/B kernel {k['name'][:60]}: calls graphs="
                  f"{g.get('calls')} eager={k['calls']}, device_s graphs="
                  f"{g.get('s')!r} eager={k['s']!r}", flush=True)
        if not abs(gn - en) <= 0.05 * en:
            raise AssertionError(f"{tag}: device time of the named groups "
                                 f"with graphs {gn} is not within 5% of "
                                 f"eager {en}")
        if not seen:
            raise AssertionError(f"{tag}: the profile holds no "
                                 f"graph-launched attention kernel")
    if graph["launches_per_step"] != eager["launches_per_step"]:
        raise AssertionError(f"{tag}: launches per step differ: "
                             f"{graph['launches_per_step']} vs "
                             f"{eager['launches_per_step']}")
    return {"same_work": same, "device_busy_s": [gb, eb],
            "busy_rel_diff": abs(gb - eb) / eb if gb and eb else None,
            "named_groups_device_s": named, "graph_kernels_seen": seen,
            "runs": {mode: [{"device_busy_s": p["device_busy_s"],
                             "named_groups_device_s": named_s(p),
                             "idle_share": p["idle_share"]} for p in r]
                     for mode, r in zip(("graphs", "eager"), runs)}}


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


def _device_events(prof):
    """The device-side events (kernels, copies, sets) of a finished
    profile, read from the raw trace.  Their durations are what
    `key_averages()` reports as self device time, without the CPU op tree
    it builds first (minutes for a serve of a 62-layer model)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                and not e.is_user_annotation()):
            yield e


def profile_serve(make_server, cfg, n_requests, lens, outs, device,
                  waves=None):
    """Where the device time of the same serve goes: a second run of the
    measured requests under torch.profiler (a fresh server, so the
    measured run above carries no profiler cost; `waves`, if given,
    returns the lists of requests served one after another).  Returns
    device time by kernel group and the device's idle share of the
    serve's wall time, or None when the profiler records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device == "cpu":
        return None
    srv = make_server()
    runs = (waves() if waves is not None else
            [make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs)])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for reqs in runs:
            srv.serve(reqs, timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return device_profile(prof, wall)


def device_profile(prof, wall):
    """Device time by kernel group of a finished profile over `wall`
    seconds, the device's idle share of them and the top kernels; None
    when the profiler recorded no device time."""
    groups, by_name = {}, {}
    for e in _device_events(prof):
        s, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (s + e.duration_ns() / 1e9, n + 1)
    top = []
    for name, (sec, n) in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + sec
        top.append((sec, n, name[:90]))
    busy = sum(groups.values())
    if busy <= 0:
        return None
    top.sort(reverse=True)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "by_group_s": groups,
            "device_ops": sum(n for _s, n in by_name.values()),
            "top_kernels": [{"s": t, "calls": c, "name": n}
                            for t, c, n in top[:10]]}


# ---------------------------------------------------------------------------
# phase 7: the serving benchmark twin's A/Bs (examples/serve_e2e_torch.py)
# ---------------------------------------------------------------------------

# (phase, flags of the twin's CLI: the reference's scripts/ci.sh
# --real-smoke commands, and the sweep at its defaults; the section the
# CLI writes)
TWIN_PHASES = [
    ("sweep_paged_vs_padded",
     ["--arch", "granite-moe-1b-a400m", "--requests", "10", "--max-new",
      "12", "--max-batch-per-dp", "1", "--arrival-spacing", "0",
      "--schedulers", "sbs-la", "--timeout", "110", "--compare-padded"],
     "real_plane"),
    ("sweep", [], "real_plane"),
    ("prefix", ["--requests", "10", "--max-new", "4", "--timeout", "150",
                "--prefix-bench"], "real_plane_prefix"),
    ("overload", ["--timeout", "150", "--overload-bench"],
     "real_plane_overload"),
    ("mixed", ["--timeout", "150", "--mixed-bench"], "real_plane_mixed"),
    # the sharded A/B on four logical shards of the card ("{device}" is
    # the phase's device)
    ("sharded", ["--arch", "granite-moe-1b-a400m", "--timeout", "150",
                 "--sharded-bench", "--mesh-devices", "{device}x4"],
     "real_plane_sharded"),
]


def load_twin():
    """`examples/serve_e2e_torch.py` as a module (loaded by path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_e2e_torch", os.path.join(ROOT, "examples", "serve_e2e_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_plane(srv):
    """(label, the wrappers a serve of `srv` launches): the unified plane
    and page-native prefill run #1 and #2's paged entry; P/D with dense
    prefill runs #2's contiguous entry beside #1 (paged) or #3 (padded)."""
    s = srv.scfg
    if s.mixed_batch:
        return (f"unified {'piggyback' if s.mixed_piggyback else 'disjoint'}",
                {"paged_decode_attention", "paged_prefill_attention"})
    if srv.prefix_cache:
        return ("P/D paged prefix_cache",
                {"paged_decode_attention", "paged_prefill_attention"})
    pre = " preemption" if s.preemption else ""
    if srv.spec.sharded:
        pre += f" sharded over {srv.spec.n_dp} DP"
    if s.block_size:
        return (f"P/D paged{pre}", {"paged_decode_attention", "flash_prefill"})
    return "P/D padded", {"decode_attention", "flash_prefill"}


def record_twin_logits(srv):
    """The recorder of first-token logits for `srv`'s plane (see
    `record_first_logits`, `record_prefill_logits`,
    `record_paged_prefill_logits`): ({rid: logits}, {rid: [chunk
    lengths]}, whether the check replays the served expert sets, the
    dense prefill chunk counts or None, undo).  The expert sets are
    replayed on P/D with dense prefill where the model has MoE
    layers."""
    if srv.scfg.mixed_batch:
        eng = srv.decode_engines[0]
        seen, chunks = record_first_logits(eng)
        return (seen, chunks, False, None,
                lambda: eng.__dict__.pop("finish_step"))
    if srv.prefix_cache:
        seen, chunks, undo = record_paged_prefill_logits(srv)
        return seen, chunks, False, None, undo
    routes = any("moe" in p for p in srv.spec.params["layers"])
    seen, chunks, counts, undo = record_prefill_logits(srv)
    return seen, chunks, routes, counts, undo


def checked_twin_server(tag, counters, device, log, servers):
    """The port's `RealSBSServer`, checked after every serve the twin
    makes (`check_served`): every request finished with its tokens, the
    decode rows and (without a prefix cache) the pools drained, each
    computed prompt's first-token logits within LOGITS_REL_TOL of a plain
    forward over the chunks it ran (an MoE model's with the served expert
    sets, `forced_routes`); besides, the plane's kernels launched and no
    other (on the card), and each full hit's replayed first token equals
    that of its computed twin in the same serve.  Appends the serve's
    figures to `log` and each server to `servers`."""
    from repro_torch.serving.server import RealSBSServer
    memo = {}       # plain references: the A/B serves the same prompts

    class Checked(RealSBSServer):
        def __init__(self, *args, scheduler="sbs", **kw):
            super().__init__(*args, scheduler=scheduler, **kw)
            self.scheduler_name = scheduler
            servers.append(self)

        def serve(self, requests, timeout=120.0):
            label, launched = twin_plane(self)
            stag = f"{tag} serve {len(log) + 1} ({self.scheduler_name}, {label})"
            seen, chunks, routes, counts, undo = record_twin_logits(self)
            before = {w.__name__: w.launches for w in counters}
            g0 = graph_stats(self)
            prefilled = prefilled_tokens(self)
            t0 = time.monotonic()
            try:
                gens = super().serve(requests, timeout=timeout)
            finally:
                undo()
            wall = time.monotonic() - t0
            launches = {w.__name__: w.launches - before[w.__name__]
                        for w in counters}
            graphs = graphs_report(self, g0)
            worst, agree, _ = check_served(
                self.cfg, self.spec.params, self.spec, self, requests, gens,
                seen, device, stag, chunks=chunks,
                prefilled_before=prefilled, prefix_cached=self.prefix_cache,
                routes=routes, memo=memo)
            if counts is not None:
                check_replayed(stag, self.spec, counts, device)
            for name, n in launches.items():
                if name in launched and device != "cpu" and n <= 0:
                    raise AssertionError(f"{stag}: {name} never launched")
                if name not in launched and n != 0:
                    raise AssertionError(f"{stag}: {name} launched {n} times")
            done = {g.rid: g for g in gens}
            computed = [r for r in requests if r.rid in seen]
            first = {r.tokens[:r.input_len]: done[r.rid].tokens[0]
                     for r in computed}
            for r in requests:
                if r.rid in seen:
                    continue
                if chunks.get(r.rid):
                    raise AssertionError(f"{stag} request {r.rid}: chunks "
                                         f"ran but no first-token logits "
                                         f"were recorded")
                want = first.get(r.tokens[:r.input_len])
                if want is not None and done[r.rid].tokens[0] != want:
                    raise AssertionError(f"{stag} request {r.rid}: first "
                                         f"token differs from its prompt's")
            ttft = [g.ttft for g in gens]
            log.append({
                "serve": len(log) + 1, "scheduler": self.scheduler_name,
                "plane": label, "requests": len(requests),
                "computed_prompts": len(computed), "wall_s": wall,
                "ttft_p50_s": percentile(ttft, 0.5),
                "ttft_p99_s": percentile(ttft, 0.99),
                "ttft_s": {g.rid: g.ttft for g in gens},
                "e2e_s": {r.rid: r.finish_time - r.arrival_time
                          for r in requests},
                "graphs_in_run": graphs and graphs["graphs_in_run"],
                "capture_s_in_run": graphs and graphs["capture_s_in_run"],
                "launches": launches, "logits_rel_err": worst,
                "argmax_agree": agree, "dense_chunks": counts,
                "expert_sets_replayed": routes})
            return gens
    return Checked


def twin_verdicts(phase, s):
    """The hard structural checks of a twin section, and the printed
    verdicts of its timing gates (measurements, not checks).  Returns
    {gate: holds}."""
    tag = f"[twin {phase}]"
    if phase == "sweep_paged_vs_padded":
        p, q = (s["peak_decode_resident"][k]["sbs-la"]
                for k in ("paged", "padded"))
        print(f"{tag} peak_decode_resident paged={p} padded={q}", flush=True)
        if not p > q:
            raise AssertionError(f"{tag}: paged peak residency {p} is not "
                                 f"above padded {q}")
        return {}
    if phase == "sweep":
        print(f"{tag} peak_decode_resident="
              f"{s['peak_decode_resident']!r}", flush=True)
        return {}
    if phase == "prefix":
        c, u = s["cached"], s["uncached"]
        if not (c["prefill_flops_saved"] > 0 and c["prefix_hit_rate"] > 0
                and c["decode_blocks_shared"] > 0):
            raise AssertionError(f"{tag}: the cached leg reused nothing: {c}")
        if u["prefill_chunks_run"] or u["decode_blocks_shared"]:
            raise AssertionError(f"{tag}: the uncached leg shared pages: {u}")
        gates = {"cached ttft_p99 < uncached":
                 c["ttft_p99"] < u["ttft_p99"]}
        print(f"{tag} timing gate cached ttft_p99 < uncached: cached="
              f"{c['ttft_p99']!r} uncached={u['ttft_p99']!r} (all requests: "
              f"{c['ttft_p99_all']!r} vs {u['ttft_p99_all']!r}; hit rate "
              f"{c['prefix_hit_rate']!r}, flops saved "
              f"{c['prefill_flops_saved']!r}) -> "
              f"{'holds' if gates['cached ttft_p99 < uncached'] else 'FAILS'}",
              flush=True)
        return gates
    if phase == "overload":
        d, p = s["drain_only"], s["preempt"]
        if not (p["preemptions"] > 0 and d["preemptions"] == 0):
            raise AssertionError(f"{tag}: preemptions {p['preemptions']} "
                                 f"(preempt) and {d['preemptions']} "
                                 f"(drain-only)")
        gates = {"preempt goodput > drain-only": p["goodput"] > d["goodput"]}
        print(f"{tag} timing gate preempt goodput > drain-only: preempt="
              f"{p['goodput']!r} drain_only={d['goodput']!r} (interactive "
              f"e2e s: {p['e2e_interactive']!r} vs {d['e2e_interactive']!r};"
              f" {p['preemptions']} preemptions) -> "
              f"{'holds' if gates['preempt goodput > drain-only'] else 'FAILS'}",
              flush=True)
        return gates
    if phase == "sharded":
        i, b = s["immediate"], s["sbs-la"]
        if not (s["ep_all_to_all_active"] and i["runs"] == b["runs"] == 5
                and i["ep_exchanges_per_step"] > 0
                and b["ep_exchanges_per_step"] > 0):
            raise AssertionError(f"{tag}: no EP exchange in the merged "
                                 f"steps, or a leg ran short: {s}")
        key = "sbs-la ttft_p99 < immediate at >= 0.95 of its throughput"
        gates = {key: (b["ttft_p99"] < i["ttft_p99"]
                       and b["throughput"] >= 0.95 * i["throughput"])}
        print(f"{tag} mesh {s['mesh_devices']!r}; per-step sync "
              f"t_step_sharded_ms={s['t_step_sharded_ms']!r} "
              f"t_step_local_ms={s['t_step_local_ms']!r}", flush=True)
        for leg, f in (("immediate", i), ("sbs-la", b)):
            print(f"{tag} {leg}: {json.dumps(f)}", flush=True)
        print(f"{tag} timing gate {key}: ttft_p99 sbs-la={b['ttft_p99']!r} "
              f"immediate={i['ttft_p99']!r}; throughput sbs-la="
              f"{b['throughput']!r} immediate={i['throughput']!r} tok/s -> "
              f"{'holds' if gates[key] else 'FAILS'}", flush=True)
        return gates
    p, d = s["piggyback"], s["disjoint"]
    if not (p["mixed_steps"] > 0 and d["mixed_steps"] == 0
            and p["runs"] == d["runs"] == 3):
        raise AssertionError(f"{tag}: mixed_steps {p['mixed_steps']} "
                             f"(piggyback) and {d['mixed_steps']} (disjoint)")
    key = "piggyback itl_p99 < disjoint at >= 0.95 of its throughput"
    gates = {key: (p["itl_p99"] < d["itl_p99"]
                   and p["throughput"] >= 0.95 * d["throughput"])}
    print(f"{tag} timing gate {key}: itl_p99 piggyback={p['itl_p99']!r} "
          f"disjoint={d['itl_p99']!r}; throughput piggyback="
          f"{p['throughput']!r} disjoint={d['throughput']!r} tok/s -> "
          f"{'holds' if gates[key] else 'FAILS'}", flush=True)
    return gates


def twin_phase(twin, phase, flags, key, counters, device, bench,
               reduced=False):
    """One A/B of the twin through its CLI entry point (`main`), every
    serve checked (`checked_twin_server`); launch counts set to 0 just
    before and read just after.  The CLI writes its section `key` to the
    file `bench`, which this call owns: it is removed before and after.
    Returns the phase report: the section, the CLI's exit code, the
    structural checks' and timing gates' outcome, each serve's figures
    and the launches."""
    tag = f"[twin {phase}]"
    log, servers = [], []
    Checked = checked_twin_server(tag, counters, device, log, servers)
    flags = [f.format(device=device) for f in flags]
    argv = flags + ["--device", device, "--bench-json", bench]
    if reduced:
        argv.append("--reduced")
    if os.path.exists(bench):
        os.remove(bench)
    inner = twin.RealSBSServer
    twin.RealSBSServer = Checked
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    try:
        twin.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code or 0
    finally:
        twin.RealSBSServer = inner
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    with open(bench) as f:
        section = json.load(f)[key]
    os.remove(bench)
    for srv in servers:
        if srv.prefix_cache:
            drain_prefix_pools(srv, tag)
    servers.clear()
    for e in log:
        print(f"{tag} serve {e['serve']} ({e['scheduler']}, {e['plane']}): "
              f"{e['requests']} finished, wall_s={e['wall_s']!r} "
              f"ttft_p50_s={e['ttft_p50_s']!r} ttft_p99_s={e['ttft_p99_s']!r} "
              f"graphs captured in the serve={e['graphs_in_run']} "
              f"({e['capture_s_in_run']!r} s) logits_rel_err="
              f"{e['logits_rel_err']:.3e}", flush=True)
    gates = twin_verdicts(phase, section)
    print(f"{tag} exit code of the twin's CLI: {code} (1 = a timing gate "
          f"failed; every request finished and every structural check "
          f"held)", flush=True)
    print(f"{tag} launches={launches!r} wall_s={wall!r}", flush=True)
    return {"flags": flags, "dtype": "float32" if reduced else "bfloat16",
            "section": section, "exit_code": code,
            "timing_gates": gates, "serves": log, "launches": launches,
            "wall_s": wall}


def prefill_split(device, reduced=False):
    """The prefill-pass split of the twin's overload A/B
    (`scripts/prefill_pass_split.py`, loaded by path: pass wall, lock
    wait, token upload, host calls, device time of the prefill
    workers), on runs of their own after phase 7's: one with the
    wrappers alone (the host parts) and, on the card, one under the
    profiler (the device part).  Prints each leg on a line of its own
    and returns {"host": legs, "device": legs}."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "prefill_pass_split",
        os.path.join(ROOT, "scripts", "prefill_pass_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {"host": mod.measure(ROOT, device, reduced)}
    if device != "cpu":
        free_device_memory()
        out["device"] = mod.measure(ROOT, device, reduced, profiled=True)
        free_device_memory()
    for part, legs in out.items():
        for leg, f in legs.items():
            print(f"[prefill split] {part} {leg}: {json.dumps(f)}",
                  flush=True)
    return out


def serve_twin(counters, device, reduced=False, elapsed=None):
    """Phase 7: the twin's six A/Bs (`TWIN_PHASES`) at published width
    in bf16 (`reduced`: the reference's reduced configs in fp32, for a
    CPU rehearsal), each writing its section to a file of its own under
    build/.  Returns {phase: report}."""
    twin = load_twin()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = {}
    for phase, flags, key in TWIN_PHASES:
        bench = os.path.join(ROOT, "build",
                             f"chip_smoke_twin_{phase}_{os.getpid()}.json")
        out[phase] = twin_phase(twin, phase, flags, key, counters, device,
                                bench, reduced)
        if device != "cpu":
            free_device_memory()
        if elapsed is not None:
            elapsed(f"twin {phase}")
    return out


# ---------------------------------------------------------------------------

def kernel_items(dec, dense, pfx, fla, ssd, mixed, pd, ssm, pd_prefix,
                 moe_serve, swa, twin, sharded, hybrid, full, encdec, train,
                 tp, launch=None):
    """The kernels line: every kernel of the port with its measurements
    and its launches on its own path's serve (#1 and #2's paged entry
    also on the shared-prefix P/D serve and the MoE serve; #3 and #2's
    contiguous entry also on the SWA serve, with their figures at its
    head dim 120; #1, #2's contiguous entry and #4 also on the hybrid's
    paged and sharded P/D serves; #2's contiguous entry, causal, and #3
    also on phase 6i's whisper and internvl2-1b runs, with their errors
    at G = 7), and on each A/B of the serving benchmark twin
    (`launches_twin`); then #2's contiguous entry not causal, a row of
    its own, measured at whisper's encoder shape, its launches on phase
    6i's whisper run; then #2's contiguous entry in the training forward
    (fp32, causal), a row of its own, measured at phase 6j's shape, its
    launches over phase 6j's Trainer steps (forward only: the backward
    is torch ops) and, apart, the remat step's recomputations.  #2's
    contiguous row also carries `launches_train` (a training step's).
    #1 and #2's contiguous entry also carry their launches on phase 6k's
    TP P/D serve (and #1 on its deepseek-7b step check), #1 and #2 not
    causal theirs on phase 6i's paged whisper leg; #1, #2's contiguous
    entry and #4 theirs on phase 6k's jamba leg (#1 also in its step
    check; the minicpm3-4b leg launches none), #3 and #2's contiguous
    entry theirs on phase 6l's launch/serve.py run."""
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
            launches_twin={phase: rep_["launches"][name]
                           for phase, rep_ in twin.items()},
            **extra)

    def on_encdec(name, errs_g7):
        return {"launches_encdec_serve": {
                    arch: rep["launches_by_mode"][name]
                    for arch, rep in encdec.items()}} | {
            f"g7_{k}": v for k, v in errs(errs_g7).items()}

    def hd120(r, name):
        h = r["hd120"]
        return {f"hd120_{k}": v for k, v in h.items()} | {
            "launches_swa_serve": swa["launches"][name],
            "launches_per_decode_step_swa_serve":
                swa["launches"][name] / swa["decode_steps"]}

    csrc = "src/repro_torch/csrc/"
    dec_k = "src/repro/kernels/decode_attention/kernel.py"
    fp_k = "src/repro/kernels/flash_prefill/kernel.py:87"
    on_prefix = pd_prefix["launches"]
    on_moe = moe_serve["launches"]

    def on_sharded(name):
        out = {f"launches_sharded_{k}_serve": sharded[k]["launches"][name]
               for k in ("pd", "unified")
               if sharded[k]["launches"][name]}
        if name in HYBRID_KERNELS:
            out.update({f"launches_hybrid_{k}_serve":
                        hybrid[k]["launches"][name]
                        for k in ("pd", "sharded")})
        if tp["pd"]["launches"][name]:
            out["launches_tp_pd_serve"] = tp["pd"]["launches"][name]
        for leg in ("mla", "hybrid"):
            if leg in tp:
                out[f"launches_tp_{leg}_pd_serve"] = tp[leg]["launches"][
                    name]
        # a dense chunk on DP 0's ranks: each rank its heads
        for key, leg in (("pd", tp.get("pd")), ("hybrid", tp.get("hybrid"))):
            per = ((leg or {}).get("dense_chunk") or {}).get(
                "launches_per_chunk", {})
            if name in per:
                out[f"launches_tp_{key}_per_dense_chunk"] = per[name]
        if launch is not None:
            out["launches_launch_serve"] = launch["serve"]["launches"][name]
        if name == "paged_decode_attention":
            out["launches_tp_step_check"] = tp["step"][
                "paged_decode_attention_launches"]
            for leg in ("mla", "hybrid"):
                if leg in tp:
                    out[f"launches_tp_{leg}_step_check"] = tp[leg]["step"][
                        "paged_decode_attention_launches"]
            for leg in ("internvl", "whisper"):
                if leg in tp:
                    out[f"launches_tp_{leg}_step_check"] = tp[leg][
                        "paged_decode_attention_launches"]
            out["launches_paged_encdec"] = encdec["whisper-large-v3"][
                "paged"]["launches"]["paged_decode_attention"]
        return out
    return [
        item("paged_decode_attention", csrc + "paged_decode_attention.cu",
             dec_k + ":115", mixed, dec, "mixed serve",
             launches_pd_prefix_serve=on_prefix["paged_decode_attention"],
             launches_per_decode_step_pd_prefix_serve=pd_prefix[
                 "paged_decode_attention_per_decode_step"],
             launches_moe_serve=on_moe["paged_decode_attention"],
             launches_per_step_moe_serve=on_moe["paged_decode_attention"]
             / moe_serve["steps"], **on_sharded("paged_decode_attention")),
        item("paged_prefill_attention", csrc + "flash_prefill.cu", fp_k,
             mixed, pfx, "mixed serve", plan=pfx["plan"],
             launches_pd_prefix_serve=on_prefix["paged_prefill_attention"],
             launches_per_prefill_pass_pd_prefix_serve=pd_prefix[
                 "paged_prefill_attention_per_prefill_pass"],
             launches_moe_serve=on_moe["paged_prefill_attention"],
             launches_per_step_moe_serve=on_moe["paged_prefill_attention"]
             / moe_serve["steps"], **on_sharded("paged_prefill_attention")),
        item("flash_prefill", csrc + "flash_prefill.cu", fp_k, pd, fla,
             "P/D serve", plan=fla["plan"], **hd120(fla, "flash_prefill"),
             **on_sharded("flash_prefill"),
             **on_encdec("flash_prefill_causal", full["errs_g7"]),
             launches_train=train["flash_prefill_per_step"],
             launches_train_remat_recomputed=train["remat"]["recomputed"]),
        item("decode_attention", csrc + "decode_attention.cu",
             dec_k + ":166", pd, dense, "P/D serve",
             **hd120(dense, "decode_attention"),
             **on_encdec("decode_attention", full["errs_dense_g7"]),
             **({"launches_launch_serve": launch["serve"]["launches"][
                 "decode_attention"]} if launch is not None else {})),
        dict(name="flash_prefill (causal=False)", route="cuda",
             source=csrc + "flash_prefill.cu", replaces=fp_k,
             launches=encdec["whisper-large-v3"]["launches_by_mode"][
                 "flash_prefill_noncausal"], **errs(full["errs"]),
             rel_tol=REL_TOL, ms=full["ms"], wall_ms=full["wall_ms"],
             plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
             bound_by=full["bound_by"], library_ms=full["library_ms"],
             library_wall_ms=full["library_wall_ms"],
             path="phase 6i, whisper-large-v3 (encoder self-attention and "
                  "cross-attention)",
             launches_per_decode_step=encdec["whisper-large-v3"][
                 "noncausal_per_decode_step"],
             shape=full["shape"],
             launches_encdec_serve={
                 arch: rep["launches_by_mode"]["flash_prefill_noncausal"]
                 for arch, rep in encdec.items()},
             launches_paged_encdec=encdec["whisper-large-v3"]["paged"][
                 "launches"]["flash_prefill_noncausal"], plan=full["plan"]),
        *[dict(name=f"flash_prefill (cross-attention Sq={sq})", route="cuda",
               source=csrc + "flash_prefill.cu", replaces=fp_k,
               launches=encdec["whisper-large-v3"]["launches_by_mode"][
                   f"flash_prefill_noncausal_{part}"],
               **errs(r["errs"]), rel_tol=REL_TOL, ms=r["ms"],
               wall_ms=r["wall_ms"], plain_ms=r["plain_ms"],
               bound_ms=r["bound_ms"], bound_by=r["bound_by"],
               library_ms=r["library_ms"],
               library_wall_ms=r["library_wall_ms"],
               path=f"phase 6i, whisper-large-v3's {what} cross-attention",
               shape=r["shape"], plan=r["plan"], **extra)
          for sq, part, what, extra in (
              (1, "decode", "decode steps'",
               {"launches_paged_encdec": encdec["whisper-large-v3"][
                   "paged"]["launches"]["flash_prefill_noncausal"]}),
              (16, "chunk", "chunk's", {}))
          for r in (full["cross"][sq],)],
        dict(name="flash_prefill (training, fp32 causal)", route="cuda",
             source=csrc + "flash_prefill.cu", replaces=fp_k,
             launches=sum(train["launches"]),
             **errs(train["kernel"]["errs"]), rel_tol=REL_TOL,
             ms=train["kernel"]["ms"], wall_ms=train["kernel"]["wall_ms"],
             plain_ms=train["kernel"]["plain_ms"],
             bound_ms=train["kernel"]["bound_ms"],
             bound_by=train["kernel"]["bound_by"],
             bound_peak="3xTF32 at 495 TFLOP/s",
             bound_fma_ms=train["kernel"]["bound_fma_ms"],
             library_ms=train["kernel"]["library_ms"],
             library_wall_ms=train["kernel"]["library_wall_ms"],
             backward_ms=train["kernel"]["backward_ms"],
             path=f"phase 6j, {train['model']} training steps (forward; the "
                  f"backward is torch ops)",
             launches_per_step=train["flash_prefill_per_step"],
             launches_remat_step=train["remat"]["flash_prefill"],
             shape=train["kernel"]["shape"]),
        item("ssd_chunk", csrc + "ssd_chunk.cu",
             "src/repro/kernels/ssd_scan/kernel.py:54", ssm, ssd,
             "SSM serve (P/D, padded)",
             launches_per_prefill_pass=ssm["ssd_chunk_per_prefill_pass"],
             **on_sharded("ssd_chunk"),
             **({f"tp_rank_share_{k}": tp["hybrid"]["ssd_rank_shape"][k]
                 for k in ("max_rel_err", "bit_identical")}
                if "hybrid" in tp else {}),
             library_note="none: no single PyTorch call computes the SSD "
                          "intra-chunk term"),
    ]


def serve_moe(counters, device, n_layers=None):
    """Phase 6d: full-width granite-moe-1b-a400m on the unified plane
    (`serve`) in MOE_CHECK_DTYPE, then its routing flips and capacity
    drops (`route_flips`).  `n_layers` cuts depth (MOE_LAYERS on the
    card; fewer for a CPU rehearsal).  Returns the serve report."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    cfg = get_arch("granite-moe-1b-a400m")
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    dt = getattr(torch, MOE_CHECK_DTYPE)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=dt, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    print(f"[init] {cfg.name} {dt} weights in {time.monotonic() - t0:.1f} s",
          flush=True)
    rep, eager = serve_modes(cfg, params, device, counters, "[moe serve]")
    for name, n in rep["launches"].items():
        on_path = name in ("paged_decode_attention", "paged_prefill_attention")
        if on_path and device != "cpu" and n <= 0:
            raise AssertionError(f"[moe serve] {name} never launched")
        if not on_path and n != 0:
            raise AssertionError(f"[moe serve] {name} launched {n} times")
    reqs = make_requests(cfg, N_REQUESTS, seed=1)
    flips, pairs, sdrops, pdrops = route_flips(
        cfg, params, reqs, rep["prefill_chunks"], device)
    rep.update(route_flips=flips, route_pairs=pairs,
               capacity_drops_per_chunk=sdrops,
               capacity_drops_per_chunk_plain=pdrops,
               check_dtype=rep["dtype"])
    print(f"[moe serve] logits check in {rep['dtype']}: worst "
          f"max|d|/max|ref|={rep['logits_rel_err']!r} (limit "
          f"{LOGITS_REL_TOL})", flush=True)
    print(f"[moe serve] routing flips (served vs plain forward, all "
          f"prompts' prefill chunks): {flips} of {pairs} (token, layer) "
          f"pairs", flush=True)
    print(f"[moe serve] capacity drops per chunk (served, summed over "
          f"layers): {sdrops!r}", flush=True)
    print(f"[moe serve] capacity drops per chunk (plain forward): "
          f"{pdrops!r}", flush=True)
    report_serve("[moe serve]", rep)
    report_serve("[moe serve eager]", eager)
    rep["eager"] = {k: v for k, v in eager.items() if k != "prefill_chunks"}
    return rep


def serve_swa(counters, device, n_layers=None):
    """Phase 6c: full-width h2o-danube-3-4b (24 layers, d 3840, 32 heads
    over 8 KV heads of 120, window 4096; bf16 from seed 0) behind the
    P/D deployment on the padded plane (`serve_pd`, the P/D serve's
    requests): kernels #3 and #2's contiguous entry at head dim 120, and
    no other.  Prompts (at most 1024 tokens) stay inside the window, so
    the ring does not wrap; the kernel phases hold the wrapped ring at
    hd 120.  `n_layers` cuts depth for a CPU rehearsal.  Returns the
    serve report."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    cfg = get_arch("h2o-danube-3-4b")
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    print(f"[init] {cfg.name} bf16 weights in {time.monotonic() - t0:.1f} s",
          flush=True)
    rep = serve_pd(cfg, params, device, counters, tag="[swa serve]")
    report_serve("[swa serve]", rep)
    if device != "cpu":
        free_device_memory()
    rep["eager"] = serve_pd(cfg, params, device, counters,
                            tag="[swa serve eager]", step_graphs=False,
                            profile=False)
    report_pd_modes("[swa serve]", rep, rep["eager"])
    print(f"[swa serve] launches per decode step: decode_attention="
          f"{rep['decode_attention_per_decode_step']!r}, per prefill pass: "
          f"flash_prefill={rep['flash_prefill_per_prefill_pass']!r} "
          f"(decode_steps={rep['decode_steps']}, "
          f"prefill_passes={rep['prefill_passes']})", flush=True)
    return rep


def serve_mla(counters, device, n_layers=None):
    """Phase 6e: full-width minicpm3-4b (MLA, bf16) behind the P/D
    deployment on the paged plane with prefix_cache=True
    (`serve_pd_prefix`); no kernel of the port lies on its path, so every
    counter must stay 0.  Returns the serve report."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    cfg = get_arch("minicpm3-4b")
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    print(f"[init] {cfg.name} bf16 weights in {time.monotonic() - t0:.1f} s",
          flush=True)
    rep = serve_pd_prefix(cfg, params, device, counters, tag="[mla serve]",
                          launched=())
    print(f"[mla serve] logits vs the non-absorbed plain forward: worst "
          f"max|d|/max|ref|={rep['logits_rel_err']!r} (limit "
          f"{LOGITS_REL_TOL})", flush=True)
    print(f"[mla serve] prefix_stats wave 1: {rep['prefix_stats_wave1']!r}",
          flush=True)
    print(f"[mla serve] prefix_stats after wave 2: {rep['prefix_stats']!r} "
          f"(computed prompts {rep['computed_prompts']}, full hits "
          f"{rep['full_hits']}, {rep['pools_emptied']} pools empty after "
          f"eviction)", flush=True)
    report_serve("[mla serve]", rep)
    return rep


# ---------------------------------------------------------------------------
# phase 6g: the sharded DP+EP plane on four logical shards of the card
# ---------------------------------------------------------------------------

N_SHARDS = 4                       # data ranks (decode DP units) of the mesh


def shard_mesh(device):
    """Four logical shards of one device: the mesh the sharded serves run
    on (the twin's A/B also runs on four cards, cuda:0..3)."""
    from repro_torch.launch.mesh import make_engine_mesh
    return make_engine_mesh(N_SHARDS, devices=[device] * N_SHARDS)


def check_ep_layer(device):
    """Phase 6g (a): the EP layer (`moe_block_ep`) at full-width
    granite-moe-1b-a400m's MoE shape (d 1024, 32 experts top-8 of 512,
    capacity factor 1.25: it binds) in bf16 on four logical shards of
    the card, against its plain version (`moe_block_ep_reference`, the
    same per-source capacity on one device) on the same inputs: the
    merged decode step's rows (4 DP units × 8 slots) and a 256-token
    prefill chunk.  Prints each shape's exchanges, bytes between EP
    ranks and their device time, and the layer's and the plain version's
    time per call.  Returns {"errs", "shapes": {T: figures}}."""
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.moe import init_moe_params
    from repro_torch.models.moe_ep import (
        count_exchanges, moe_block_ep, moe_block_ep_reference,
    )
    cfg = get_arch("granite-moe-1b-a400m")
    mc = cfg.moe
    g = torch.Generator(device=device)
    g.manual_seed(0)
    p = init_moe_params(g, cfg.d_model, mc, torch.bfloat16)
    mesh = shard_mesh(device)
    out = {"errs": [], "shapes": {}}
    for T in (N_SHARDS * 2 * MAX_BATCH, PD_CHUNK):
        xs = [(torch.randn(T, cfg.d_model,
                           generator=torch.Generator().manual_seed(T + i))
               * 0.5).to(device, torch.bfloat16) for i in range(4)]

        def ep(i):
            return moe_block_ep(xs[i], p, mc, mesh, ("data",),
                                ("data", "model"))[0]

        def ref(i):
            return moe_block_ep_reference(xs[i], p, mc, N_SHARDS)[0]
        with count_exchanges(timed=device != "cpu") as st:
            got = ep(0)
        compare(f"[ep layer] T={T}", got, ref(0), out["errs"])
        f = {"exchanges": st.exchanges, "bytes": st.bytes,
             "exchange_ms": (st.seconds() * 1e3 if device != "cpu"
                             else None)}
        if device != "cpu":
            f["ms"], f["wall_ms"] = time_ms(ep, len(xs))
            f["plain_ms"], f["plain_wall_ms"] = time_ms(ref, len(xs))
        out["shapes"][T] = f
        print(f"[ep layer] T={T} on {N_SHARDS} logical shards: "
              f"{json.dumps(f)}", flush=True)
    return out


def sharded_scfg(mixed, n_dp=N_SHARDS):
    """The sharded serves' deployments: the unified plane of phase 6e or
    the P/D deployment of phase 6, with `n_dp` decode DP units merged on
    the mesh (16-token pages)."""
    from repro_torch.config.base import ServingConfig
    if mixed:
        return ServingConfig(
            num_prefill_instances=1, prefill_dp_per_instance=1,
            num_decode_instances=1, decode_dp_per_instance=n_dp,
            chunk_size=256, t_default=0.05, l_net=0.001,
            max_batch_per_dp=MAX_BATCH, block_size=BLOCK,
            mixed_batch=True, mixed_chunk=256)
    return ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=n_dp,
        chunk_size=PD_CHUNK, t_default=0.05, l_net=0.001,
        max_batch_per_dp=MAX_BATCH, block_size=BLOCK, n_limit=64)


def ep_chunk_moe(n_slices):
    """The MoE of one prefill chunk as the sharded unified plane runs it
    (`moe_fn` of `dense_forward_logits`): per-source capacity over
    `n_slices` token slices where the chunk's tokens divide over them
    (the EP path), the single-program `moe_block` otherwise."""
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_ep import moe_block_ep_reference

    def fn(h, p, mc):
        if (h.numel() // h.shape[-1]) % n_slices == 0:
            return moe_block_ep_reference(h, p, mc, n_slices)
        return moe_block(h, p, mc)
    return fn


def replay_sharded_routes(spec, prompt, chunks):
    """The expert ids the sharded unified plane chose for `prompt`, chunk-
    major (each chunk's MoE layers in order, each layer's token slices in
    order): its chunks through the spec's page-native step (the step a
    granted chunk runs, under the mesh context) into a fresh merged
    cache.  A chunk's step depends only on its own pages and tokens, so
    this recomputes what the serve computed.  Launch counts are
    restored: these calls are not the serve's."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import paged_install_row
    from repro_torch.serving.step_graphs import _wrappers
    out, inner = [], moe.route
    counters = _wrappers()
    launches = [w.launches for w in counters]

    def route(x2d, p, mc):
        r = inner(x2d, p, mc)
        out.append(r[1])
        return r
    moe.route = route
    try:
        cache = spec.merged_paged_cache()
        cache = paged_install_row(cache, 0, torch.arange(
            1, spec.nbt + 1, dtype=torch.int32, device=spec.device), 0)
        at = 0
        for n in chunks:
            ids = torch.tensor([list(prompt[at:at + n])], dtype=torch.int32,
                               device=spec.device)
            _lg, cache = spec.prefill_fn(cache, ids, 0)
            at += n
    finally:
        moe.route = inner
        for w, n in zip(counters, launches):
            w.launches = n
    return out


def hold_handoffs_whole(srv, n):
    """Place the P/D burst's decode joins all at once, in rid order: the
    decode scheduler (`immediate`) holds each KV handoff of a run until
    all `n` have arrived and then places them one by one as it would
    have.  The merged cache's rows share each MoE layer's expert
    capacity, so a row's tokens depend on which rows decode beside it;
    held this way, every run steps the same rows, whatever a step
    costs."""
    sched = srv.dsched
    inner = sched.on_handoff
    held = []

    def on_handoff(req, now):
        held.append(req)
        if len(held) < n:
            return None
        out = {}
        for r in sorted(held, key=lambda r: r.rid):
            for d, reqs in (inner(r, now) or {}).items():
                out.setdefault(d, []).extend(reqs)
        held.clear()
        return out
    sched.on_handoff = on_handoff


def probe_exchange_ms(spec, device):
    """Device time of the EP exchanges of one EAGER merged decode step
    (CUDA events around each exchange; a replayed graph records none):
    the second of two eager steps on a fresh merged cache.  Returns
    (ms, exchanges); ms None on the CPU.  Launch counts are restored:
    these calls are not the serve's."""
    import torch
    from repro_torch.models.moe_ep import count_exchanges
    from repro_torch.serving.step_graphs import _wrappers
    wrappers = _wrappers()
    launches = [w.launches for w in wrappers]
    cache = spec.merged_paged_cache()
    toks = [torch.zeros((spec.paged_slots, 1), dtype=torch.int32, device=d)
            for d in spec.mesh.devices]
    try:
        for _ in range(2):
            with count_exchanges(timed=device != "cpu") as ep:
                _lg, cache = spec.decode_fn(cache, toks)
            secs = ep.seconds()
    finally:
        for w, n in zip(wrappers, launches):
            w.launches = n
    return (None if secs is None else secs * 1e3), ep.exchanges


def serve_sharded(cfg, params, device, counters, mixed,
                  n_requests=N_REQUESTS, lens=(128, 1024), outs=(16, 32),
                  step_graphs=True, scheduler="sbs-la", burst=None,
                  tag=None, keep=None, exact_replay=None, mesh=None):
    """Phase 6g (b): `cfg` behind `RealSBSServer(mesh=...)` on four
    logical shards of the card (or on `mesh`: phase 6k's (2, 2) mesh,
    two DP units of two tensor-parallel ranks each, whose every merged
    decode step must also make the TP collectives `expected_tp_calls`
    says) (sbs-la; the unified plane with the burst
    dispatched whole, or P/D with requests 50 ms apart, or with `burst`
    at t = 0 and the decode joins held until all are handed off), with
    step graphs (every merged decode step, dense or page-native chunk
    replays one) or eagerly.  The measured server first serves the same
    requests once.  Checks: every request finishes and the merged
    caches drain; every step that decoded rows covered the merged slot
    axis and made EP exchanges (on P/D 2 in each MoE layer, dispatch and
    combine); with graphs on the card, every step of
    the measured run replayed (the merged engine's replays equal its
    decode steps plus, unified, its chunks; every dense chunk replayed);
    #1 and #2 (the paged entry on the unified plane, the contiguous one
    for P/D's dense prefill) launch and nothing else; each first-token
    logits row agrees with a plain forward over the served chunks and
    the served expert sets (P/D: `replay_routes`; the unified plane:
    `replay_sharded_routes`, with each chunk's MoE under the per-source
    capacity the EP path gives it).  The exchanges' device time comes
    from `probe_exchange_ms` (an eager step).  `keep`, a dict, receives
    the first-token logits by rid; `exact_replay`, a list, makes the P/D
    logits check a hybrid's chain (`compare_first_logits`).  Returns the
    serve report."""
    import torch
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.server import RealSBSServer
    burst = mixed if burst is None else burst
    tag = tag or f"[sharded {'unified' if mixed else 'pd'} serve]"
    mesh = mesh or shard_mesh(device)
    n_model = mesh.shape.get("model", 1)
    scfg = sharded_scfg(mixed, mesh.shape["data"])
    spec = EngineSpec(cfg, params, max_len=MAX_LEN, max_batch=MAX_BATCH,
                      max_new=outs[1], block_size=BLOCK,
                      decode_slots=scfg.resolved_decode_slots, mesh=mesh,
                      step_graphs=step_graphs)

    def requests():
        return make_requests(cfg, n_requests, seed=1, lens=lens, outs=outs,
                             burst=burst)
    t0 = time.monotonic()
    srv = RealSBSServer(cfg, params, scfg, scheduler=scheduler, spec=spec,
                        mesh=mesh)
    build_s = time.monotonic() - t0
    if mixed:
        dispatch_bursts_whole(srv, n_requests)
    elif burst:
        hold_handoffs_whole(srv, n_requests)
    srv.serve(requests(), timeout=600)
    eng = srv.decode_engines[0]
    mark = (eng.steps, len(eng.itl), len(eng.step_samples),
            prefilled_tokens(srv),
            eng.graphs.replays if eng.graphs is not None else 0)
    g0 = graph_stats(srv)
    if mixed:
        first_logits, chunks = record_first_logits(eng)
        counts = None
        undo = lambda: eng.__dict__.pop("finish_step")      # noqa: E731
    else:
        first_logits, chunks, counts, undo = record_prefill_logits(srv)
    reqs = requests()
    for w in counters:
        w.launches = 0
    t0 = time.monotonic()
    try:
        gens = srv.serve(reqs, timeout=600)
    finally:
        undo()
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    graphs = graphs_report(srv, g0)
    samples = eng.step_samples[mark[2]:]
    ep = eng.ep_samples[mark[2]:]
    tp = eng.tp_samples[mark[2]:]
    rows = len(eng._group.slots)
    n_moe = sum("moe" in p for p in params["layers"])
    want_tp = (expected_tp_calls(cfg, n_model, spec.paged_slots)
               if n_model > 1 and not mixed else None)
    for (_d, active, r), (ex, _b, _s), (calls, _tb) in zip(samples, ep,
                                                           tp):
        if want_tp is not None and active and calls != want_tp:
            raise AssertionError(f"{tag}: a merged decode step made the "
                                 f"TP collectives {calls}, not {want_tp}")
        if r != rows:
            raise AssertionError(f"{tag}: a step covered {r} rows, the "
                                 f"merged cache has {rows}")
        if active and n_moe and ex <= 0:
            raise AssertionError(f"{tag}: a merged decode step made no EP "
                                 f"exchange")
        # a P/D step decodes only: dispatch and combine in each MoE layer
        if active and not mixed and ex != 2 * n_moe:
            raise AssertionError(f"{tag}: a merged decode step made {ex} "
                                 f"EP exchanges, not 2 in each of its "
                                 f"{n_moe} MoE layers")
    decode = [(d, x) for (d, a, _r), x in zip(samples, ep) if a]
    tp_decode = [x for (_d, a, _r), x in zip(samples, tp) if a]
    n_chunks = sum(len(v) for v in chunks.values()) if mixed else 0
    replays = (eng.graphs.replays - mark[4]) if eng.graphs is not None \
        else None
    if counts is not None:
        check_replayed(tag, spec, counts, device)
    dense_chunk = weights = None
    if n_model > 1:
        weights = check_tp_weights(tag, cfg, params, spec.params, mesh,
                                   spec.parallel)
    if n_model > 1 and counts is not None:
        dense_chunk = check_tp_chunks(tag, cfg, params, counts, launches,
                                      n_model, device)
    print(f"{tag} merged engine: {replays} replays for {len(decode)} "
          f"decode steps and {n_chunks} chunks; graphs {graphs!r}",
          flush=True)
    if (device != "cpu" and step_graphs
            and replays != len(decode) + n_chunks):
        raise AssertionError(f"{tag}: {len(decode) + n_chunks - replays} "
                             f"steps of the measured run ran eagerly")
    launched = ({"paged_decode_attention", "paged_prefill_attention"}
                if mixed else {"paged_decode_attention", "flash_prefill"})
    if cfg.attention.name == "MLA":
        launched = set()                    # MLA runs torch ops
    if any("mamba" in p for p in params["layers"]):
        launched.add("ssd_chunk")           # a hybrid's SSM prefill
    for name, n in launches.items():
        if name in launched and device != "cpu" and n <= 0:
            raise AssertionError(f"{tag}: {name} never launched")
        if name not in launched and n != 0:
            raise AssertionError(f"{tag}: {name} launched {n} times")
    flips = {"flips": 0, "pairs": 0}
    forward = dense_forward_logits
    if mixed:
        def forward(cfg_, params_, prompt, device_, ch):
            routes = replay_sharded_routes(spec, prompt, ch)
            slices = [N_SHARDS if n % N_SHARDS == 0 else 1 for n in ch]
            with forced_routes(routes, len(ch), n_moe, slices) as n:
                ref = dense_forward_logits(cfg_, params_, prompt, device_,
                                           ch, moe_fn=ep_chunk_moe(N_SHARDS))
            flips["flips"] += n["flips"]
            flips["pairs"] += n["pairs"]
            return ref
    worst, agree, _ = check_served(cfg, params, spec, srv, reqs, gens,
                                   first_logits, device, tag, forward,
                                   chunks, prefilled_before=mark[3],
                                   routes=not mixed,
                                   exact_replay=exact_replay)
    if mixed:
        print(f"{tag} the plain forward replayed the served expert sets: "
              f"{flips['flips']} of {flips['pairs']} (token, layer) pairs "
              f"differ from its own router's choice", flush=True)
    if keep is not None:
        keep.update(first_logits)
    ep_ms, ep_probe_ex = probe_exchange_ms(spec, device)
    ttft = [g.ttft for g in gens]
    itl = eng.itl[mark[1]:]
    n = max(len(decode), 1)
    return {
        "plane": ("unified mixed-batch, sharded" if mixed
                  else "P/D, sharded paged decode"),
        "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "mesh": [str(d) for d in mesh.devices],
        "mode": "step graphs" if step_graphs else "eager",
        "scheduler": scheduler,
        "traffic": (f"{n_requests} requests at t = 0" if burst
                    else f"{n_requests} requests 50 ms apart"),
        "requests": len(reqs), "prompt_tokens": [r.input_len for r in reqs],
        "new_tokens": [len(g.tokens) for g in gens], "wall_s": wall,
        "tokens": {g.rid: g.tokens for g in gens},
        "server_build_s": build_s, "graphs": graphs,
        "merged_replays": replays,
        "dense_chunks": counts,
        "ttft_p50_s": percentile(ttft, 0.5),
        "ttft_p99_s": percentile(ttft, 0.99),
        "itl_p50_s": percentile(itl, 0.5),
        "itl_p99_s": percentile(itl, 0.99),
        "steps": eng.steps - mark[0], "decode_steps": len(decode),
        "merged_rows": rows,
        "step_p50_s": percentile([d for d, _a, _r in samples], 0.5),
        "step_p99_s": percentile([d for d, _a, _r in samples], 0.99),
        "decode_step_p50_s": percentile([d for d, _x in decode], 0.5),
        "ep_exchanges_per_decode_step": sum(x[0] for _d, x in decode) / n,
        "ep_bytes_per_decode_step": sum(x[1] for _d, x in decode) / n,
        "ep_ms_per_decode_step_eager_probe": ep_ms,
        "ep_exchanges_eager_probe": ep_probe_ex,
        "model_ranks": n_model,
        "tp_calls_per_decode_step": (
            {k: sum(c.get(k, 0) for c, _b in tp_decode) / n
             for k in sorted({k for c, _b in tp_decode for k in c})}
            if n_model > 1 else None),
        "tp_bytes_per_decode_step": (
            sum(b for _c, b in tp_decode) / n if n_model > 1 else None),
        "tp_calls_expected": want_tp,
        "dense_chunk": dense_chunk,
        "weights": weights,
        "mixed_steps": getattr(eng, "mixed_steps", None),
        "launches": launches,
        "launches_per_decode_step": {
            k: v / n for k, v in launches.items()},
        "logits_rel_err": worst, "argmax_agree": agree,
        "logits_checked_by": ("replay" if exact_replay is not None
                              else "plain forward"),
        "expert_sets_replayed": True,
        "route_flips_hidden": flips if mixed else None,
        "prefill_chunks": {r.rid: chunks.get(r.rid) for r in reqs},
    }


def check_tp_chunks(tag, cfg, params, counts, launches, M, device):
    """A TP P/D serve's dense chunks ran on DP 0's M model ranks: every
    chunk made the collectives `expected_tp_chunk_calls` says, and on
    the card #2's contiguous entry launched M times a GQA attention
    layer a chunk and #4 M times an SSM layer a chunk (each rank its
    heads).  Returns the chunks' report."""
    from repro_torch.config.base import LayerKind
    want = expected_tp_chunk_calls(cfg, M)
    calls = counts["tp_calls"]
    kinds = cfg.layer_kinds()
    n_attn = (0 if cfg.attention.name == "MLA" else
              sum(k in (LayerKind.DENSE, LayerKind.MOE) for k in kinds))
    n_ssm = sum(k in (LayerKind.SSM, LayerKind.SSM_MOE) for k in kinds)
    n = max(counts["chunks"], 1)
    per = {"flash_prefill": launches.get("flash_prefill", 0) / n}
    if n_ssm:
        per["ssd_chunk"] = launches.get("ssd_chunk", 0) / n
    pred = {k: {"flash_prefill": M * n_attn, "ssd_chunk": M * n_ssm}[k]
            for k in per}
    distinct = [dict(t) for t in sorted({tuple(sorted(c.items()))
                                         for c in calls})]
    print(f"{tag} dense chunks on DP 0's {M} model ranks: "
          f"{counts['chunks']} chunks, collectives a chunk {distinct!r} "
          f"(expected {want!r}); launches a chunk {per!r} (predicted "
          f"{pred!r})", flush=True)
    if any(c != want for c in calls):
        raise AssertionError(f"{tag}: a dense chunk made the collectives "
                             f"{next(c for c in calls if c != want)}, not "
                             f"{want}")
    if device != "cpu":
        for k, v in per.items():
            if v != pred[k]:
                raise AssertionError(f"{tag}: {k} launched {v} times a "
                                     f"dense chunk, not {pred[k]}")
    return {"chunks": counts["chunks"], "tp_calls": distinct,
            "tp_calls_expected": want, "launches_per_chunk": per,
            "launches_predicted": pred}


def serve_sharded_bits(cfg, params, device, counters, n_requests=N_REQUESTS,
                       lens=(128, 1024), outs=(16, 32), mesh=None,
                       tag="[sharded pd bits]"):
    """The graphs-vs-eager A/B of the sharded P/D serve: its requests all
    at t = 0 under `immediate` (each pass takes its queue in order, so
    the chunk boundaries do not depend on step times) with the decode
    joins placed together (`hold_handoffs_whole`: the merged rows share
    expert capacity), served with step graphs and eagerly.  Every
    request's chunks, tokens and first-token logits must be identical,
    bit for bit.  `mesh` as `serve_sharded`'s.  Returns the A/B's
    report."""
    import torch
    reps, logits = {}, {}
    for graphs in (True, False):
        logits[graphs] = {}
        reps[graphs] = serve_sharded(
            cfg, params, device, counters, False, n_requests=n_requests,
            lens=lens, outs=outs, step_graphs=graphs,
            scheduler="immediate", burst=True,
            tag=f"{tag[:-1]} {'graphs' if graphs else 'eager'}]",
            keep=logits[graphs], mesh=mesh)
        if device != "cpu":
            free_device_memory()
    g, e = reps[True], reps[False]
    same_chunks = g["prefill_chunks"] == e["prefill_chunks"]
    same_tokens = g["tokens"] == e["tokens"]
    diff = max(float((logits[True][r] - logits[False][r]).abs().max())
               for r in logits[True])
    same_logits = all(torch.equal(logits[True][r], logits[False][r])
                      for r in logits[True])
    print(f"{tag} graphs vs eager on the same chunks: chunks "
          f"equal {same_chunks}, tokens equal {same_tokens}, first-token "
          f"logits bit-identical {same_logits} (max|d|={diff!r}); wall "
          f"graphs={g['wall_s']!r} eager={e['wall_s']!r}; decode step p50 "
          f"graphs={g['decode_step_p50_s']!r} "
          f"eager={e['decode_step_p50_s']!r}; ttft_p99 "
          f"graphs={g['ttft_p99_s']!r} eager={e['ttft_p99_s']!r}",
          flush=True)
    if not (same_chunks and same_tokens and same_logits):
        raise AssertionError(f"{tag}: the graph and eager serves differ")
    keys = ("wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p99_s",
            "decode_step_p50_s", "dense_chunks", "graphs")
    return {"same_chunks": same_chunks, "same_tokens": same_tokens,
            "same_first_logits": same_logits, "max_abs_logit_diff": diff,
            "graphs": {k: g[k] for k in keys},
            "eager": {k: e[k] for k in keys if k != "graphs"}}


def report_sharded(tag, rep):
    """A sharded serve's figures, each on a line of its own."""
    print(f"{tag} ttft_p50_s={rep['ttft_p50_s']!r} "
          f"ttft_p99_s={rep['ttft_p99_s']!r}", flush=True)
    print(f"{tag} itl_p50_s={rep['itl_p50_s']!r} "
          f"itl_p99_s={rep['itl_p99_s']!r}", flush=True)
    print(f"{tag} wall_s={rep['wall_s']!r} steps={rep['steps']} "
          f"decode_steps={rep['decode_steps']} merged_rows="
          f"{rep['merged_rows']}", flush=True)
    print(f"{tag} step_p50_s={rep['step_p50_s']!r} "
          f"step_p99_s={rep['step_p99_s']!r} decode_step_p50_s="
          f"{rep['decode_step_p50_s']!r}", flush=True)
    print(f"{tag} ep per decode step: exchanges="
          f"{rep['ep_exchanges_per_decode_step']!r} bytes="
          f"{rep['ep_bytes_per_decode_step']!r} exchange_ms (eager probe)="
          f"{rep['ep_ms_per_decode_step_eager_probe']!r}", flush=True)
    print(f"{tag} mode={rep['mode']} graphs={rep['graphs']!r} merged "
          f"replays={rep['merged_replays']!r} server_build_s="
          f"{rep['server_build_s']!r}", flush=True)
    limit = ("not checked: served = eager replay, then fp32"
             if rep["logits_checked_by"] == "replay" else
             f"limit {LOGITS_REL_TOL}")
    print(f"{tag} launches={rep['launches']!r} logits_rel_err="
          f"{rep['logits_rel_err']!r} ({limit})", flush=True)


def serve_sharded_phase(counters, device, n_layers=None):
    """Phase 6g: the EP layer against its plain version, then full-width
    granite-moe-1b-a400m (bf16 from seed 0) behind the sharded P/D and
    unified deployments on four logical shards of the card, with step
    graphs, and the sharded P/D serve's graphs-vs-eager bit A/B
    (`serve_sharded_bits`, at SHARDED_BITS_LAYERS of the 24 layers: the
    first layers of the same weights).  `n_layers` cuts depth for a CPU
    rehearsal.
    Returns {"ep_layer", "pd" (with "bits"), "unified"}."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    out = {"ep_layer": check_ep_layer(device)}
    cfg = get_arch("granite-moe-1b-a400m")
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    for key, mixed in (("pd", False), ("unified", True)):
        rep = serve_sharded(cfg, params, device, counters, mixed)
        report_sharded(f"[sharded {key} serve]", rep)
        out[key] = rep
        if device != "cpu":
            free_device_memory()
    bits_layers = n_layers or SHARDED_BITS_LAYERS
    out["pd"]["bits"] = serve_sharded_bits(
        dataclasses.replace(cfg, num_layers=bits_layers),
        dict(params, layers=params["layers"][:bits_layers]), device,
        counters)
    return out


# ---------------------------------------------------------------------------
# phase 6h: a hybrid's per-slot SSM state beside paged K/V (jamba)
# ---------------------------------------------------------------------------

# jamba-v0.1-52b's depth on one card: one period of the published 32
# layers (7 SSM layers, 4 of them SSM_MOE with 16 experts top-2, and 1
# attention layer; 13.27 B parameters, 26.5 GB in bf16); the 32 layers
# (102.9 GB) run on four cards in `scripts/jamba_four_cards.py`
HYBRID_LAYERS = 8
HYBRID_KERNELS = ("paged_decode_attention", "flash_prefill", "ssd_chunk")


def serve_hybrid_phase(counters, device, cfg=None, params=None,
                       n_requests=N_REQUESTS, lens=(128, 1024),
                       outs=(16, 32)):
    """Phase 6h: jamba-v0.1-52b at full width, HYBRID_LAYERS of its 32
    layers (random bf16 weights from seed 0, made on the card), (a)
    behind the P/D server on the paged plane (dense prefill: #4 in the
    SSM layers, #2's contiguous entry in the attention layer; the
    handoff joined into pages and the slot's SSM rows; paged decode: #1),
    with step graphs: every request finishes, the pools drain, #1, #2
    contiguous and #4 launch through replays and nothing else, and each
    first-token logits row equals the eager replay of the served chunks
    and expert sets bit for bit; then its graphs-vs-eager bit A/B on an
    `immediate` burst with the decode joins placed together; (b) behind
    the sharded P/D plane on four logical shards of the card
    (`serve_sharded`: 1 decode × 4 DP merged, EP over the 16 experts,
    four a shard), with step graphs: every request finishes, the merged
    cache drains, every merged decode step makes 2 exchanges in each of
    the 4 MoE layers, and the served logits equal the eager replay bit
    for bit; (c) with the servers gone, the weights widened to fp32 in
    place (`widen_params`, layer by layer: 53 GB, which could not sit
    beside the bf16 copy and a server), each served prompt's eager
    replay over its served chunks and expert sets in fp32 against the
    plain fp32 forward over the same (`check_fp32_replay`, within
    REL_TOL["float32"]).  The bf16 served-vs-plain distance is printed,
    not checked: it depends on where SBS splits a prompt (0.84e-2 to
    3.95e-2 over 13 chunkings of each prompt, 6.015e-2 once; PERF.md
    §6).  `cfg`, `params` and the sizes let a CPU rehearsal pass a
    reduced model; `params` are widened in place.  Returns {"pd" (with
    "bits"), "sharded"}, each with "fp32_replay_rel_err"."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    if cfg is None:
        cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"),
                                  num_layers=HYBRID_LAYERS)
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
        torch.cuda.synchronize()
        print(f"[init] {cfg.name} at {cfg.num_layers} of 32 layers, bf16 "
              f"weights in {time.monotonic() - t0:.1f} s", flush=True)
    size = dict(n_requests=n_requests, lens=lens, outs=outs)
    cases = {"pd": [], "sharded": []}
    pd = serve_pd(cfg, params, device, counters, tag="[hybrid pd serve]",
                  launched=HYBRID_KERNELS, block_size=BLOCK, routes=True,
                  exact_replay=cases["pd"], **size)
    replays = (pd["graphs"] or {}).get("replays_in_run", 0)
    if device != "cpu" and replays <= 0:
        raise AssertionError("[hybrid pd serve]: no step replayed a graph")
    report_serve("[hybrid pd serve]", pd)
    print(f"[hybrid pd serve] launches per decode step: "
          f"paged_decode_attention="
          f"{pd['launches']['paged_decode_attention'] / max(pd['decode_steps'], 1)!r}"
          f", per prefill pass: flash_prefill="
          f"{pd['flash_prefill_per_prefill_pass']!r} ssd_chunk="
          f"{pd['ssd_chunk_per_prefill_pass']!r} (decode_steps="
          f"{pd['decode_steps']}, prefill_passes={pd['prefill_passes']}, "
          f"replays in the measured run {replays})", flush=True)
    if device != "cpu":
        free_device_memory()
    pd["bits"] = serve_pd_bits(cfg, params, device, counters,
                               tag="[hybrid pd bits]",
                               launched=HYBRID_KERNELS, block_size=BLOCK,
                               routes=True, hold=True, **size)
    if device != "cpu":
        free_device_memory()
    sharded = serve_sharded(cfg, params, device, counters, False,
                            tag="[hybrid sharded pd serve]",
                            exact_replay=cases["sharded"], **size)
    report_sharded("[hybrid sharded pd serve]", sharded)
    if device != "cpu":
        free_device_memory()
    widen_params(params)
    if device != "cpu":
        free_device_memory()
    for key, tag, rep in (("pd", "[hybrid pd serve]", pd),
                          ("sharded", "[hybrid sharded pd serve]", sharded)):
        rep["served_equals_eager_replay"] = True
        rep["fp32_replay_rel_err"] = check_fp32_replay(
            cfg, params, cases[key], MAX_LEN, device, tag)
    return {"pd": pd, "sharded": sharded}


def widen_params(params):
    """Widen every floating-point weight of `params` to fp32 in place,
    leaf by leaf, so that at most one leaf exists in both dtypes."""
    import torch

    def walk(node):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node))
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                walk(v)
            elif v.is_floating_point() and v.dtype != torch.float32:
                node[k] = v.float()
    walk(params)


def check_fp32_replay(cfg, params, cases, max_len, device, tag):
    """Each served prompt's eager replay (`eager_chunks_logits` over its
    served chunks, the served expert sets forced in chunk order) against
    the plain forward over the same chunks and expert sets
    (`dense_forward_logits`), both in the weights' dtype (fp32 after
    `widen_params`); raises past REL_TOL["float32"].  `cases`: (prompt,
    chunks, routes) as `compare_first_logits` records them.  Returns the
    worst max|d|/max|ref|."""
    n_moe = sum("moe" in p for p in params["layers"])
    worst = 0.0
    for prompt, chunks, routes in cases:
        with forced_routes(routes, len(chunks), n_moe, chunk_major=True):
            got = eager_chunks_logits(cfg, params, prompt, chunks, max_len,
                                      device)
        with forced_routes(routes, len(chunks), n_moe):
            ref = dense_forward_logits(cfg, params, prompt, device, chunks)
        worst = max(worst, float((got.float() - ref.float()).abs().max()
                                 / ref.float().abs().max()))
    print(f"{tag} fp32 eager replay of the served chunks and expert sets "
          f"vs the plain fp32 forward over the same: worst max|d|/max|ref|="
          f"{worst!r} over {len(cases)} prompts (tol "
          f"{REL_TOL['float32']})", flush=True)
    if not worst <= REL_TOL["float32"]:
        raise AssertionError(f"{tag}: the fp32 replay disagrees with the "
                             f"plain fp32 forward: {worst}")
    return worst


# ---------------------------------------------------------------------------
# phase 6i: the full-sequence path on whisper-large-v3 and internvl2-1b
# ---------------------------------------------------------------------------

# (arch, prompt lengths, cache length): whisper's decoder prompts after
# its 1500 stub frame embeddings, internvl2-1b's text prompts after its
# 256 stub patch embeddings (256 + 200 + 16 + 32 = 504 of 512)
ENCDEC_SERVES = (("whisper-large-v3", (4, 17, 33, 64), 256),
                 ("internvl2-1b", (16, 77, 150, 200), 512))
ENCDEC_CHUNK = 16
ENCDEC_STEPS = 32


def serve_encdec(cfg, params, device, counters, lens, max_len, tag):
    """One model's full-sequence serve through the port's entry points:
    `prefill` of len(lens) requests (prompts of `lens` tokens, with stub
    frame or patch embeddings of 0.1 · N(0, 1) from seed 7), one
    ENCDEC_CHUNK-token `prefill_chunk`, then ENCDEC_STEPS greedy
    `decode_step`s.  Launch counts are set to 0 just before and read
    just after; on the card #2 (causal and not) and #3 must have
    launched exactly as the path calls them.  Each request's logits
    after the prefill and after the chunk are held against a plain
    forward over the same tokens (`dense_forward_logits`) within
    LOGITS_REL_TOL; every logit finite, every token in the vocabulary."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.model import decode_step, prefill, prefill_chunk
    B, S, C = len(lens), max(lens), ENCDEC_CHUNK
    g = torch.Generator(device="cpu").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + C), generator=g)
    n_emb = (cfg.encoder_seq_len if cfg.is_encoder_decoder
             else cfg.num_patch_tokens)
    embeds = (torch.randn(B, n_emb, cfg.d_model, generator=g) * 0.1).to(
        device=device, dtype=params["embed"].dtype)
    n_pre = 0 if cfg.is_encoder_decoder else n_emb
    chunk = torch.stack([tokens[b, n:n + C] for b, n in enumerate(lens)])
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def run():
        """prefill -> chunk -> decode steps; (prefill and chunk logits,
        generated tokens, all logits finite, #2's non-causal launches
        in the decode steps, [t0, t1, t2, t3])."""
        sync()
        ts = [time.monotonic()]
        lg_p, cache = prefill(cfg, params, tokens[:, :S].to(device),
                              embeds=embeds, lengths=lengths,
                              max_len=max_len)
        sync()
        ts.append(time.monotonic())
        ncc = flash_prefill.launches_noncausal
        lg_c, cache = prefill_chunk(cfg, params, chunk.to(device), cache)
        sync()
        ncc = flash_prefill.launches_noncausal - ncc
        ts.append(time.monotonic())
        nxt = lg_c.argmax(-1)[:, None]
        gen, finite = [nxt], bool(torch.isfinite(lg_p).all()
                                  and torch.isfinite(lg_c).all())
        nc0 = flash_prefill.launches_noncausal
        for _ in range(ENCDEC_STEPS):
            lg, cache = decode_step(cfg, params, nxt, cache)
            finite = finite and bool(torch.isfinite(lg).all())
            nxt = lg.argmax(-1)[:, None]
            gen.append(nxt)
        sync()
        ts.append(time.monotonic())
        return (lg_p, lg_c, torch.cat(gen, 1), finite,
                (flash_prefill.launches_noncausal - nc0, ncc), ts)
    for w in counters:
        w.launches = 0
    flash_prefill.launches_noncausal = 0
    lg_p, lg_c, gen, finite, (nc_decode, nc_chunk), (t0, t1, t2, t3) = run()
    launches = {w.__name__: w.launches for w in counters}
    noncausal = flash_prefill.launches_noncausal
    if not finite or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"{tag}: non-finite logits or bad tokens")
    L = cfg.num_layers
    n_enc = cfg.num_encoder_layers if cfg.is_encoder_decoder else 0
    n_x = L if cfg.is_encoder_decoder else 0
    expected = {"flash_prefill_causal": 2 * L,
                "flash_prefill_noncausal": n_enc + n_x * (2 + ENCDEC_STEPS),
                "flash_prefill_noncausal_decode": n_x * ENCDEC_STEPS,
                "flash_prefill_noncausal_chunk": n_x,
                "decode_attention": L * ENCDEC_STEPS}
    got = {"flash_prefill_causal": launches["flash_prefill"] - noncausal,
           "flash_prefill_noncausal": noncausal,
           "flash_prefill_noncausal_decode": nc_decode,
           "flash_prefill_noncausal_chunk": nc_chunk,
           "decode_attention": launches["decode_attention"]}
    others = {k: n for k, n in launches.items()
              if k not in ("flash_prefill", "decode_attention") and n}
    print(f"{tag} launches {got!r} (the path's calls: {expected!r}), "
          f"other kernels {others!r}", flush=True)
    if device != "cpu" and (got != expected or others):
        raise AssertionError(f"{tag}: launches {got} {others}, the path "
                             f"calls {expected}")
    worst = [0.0, 0.0]              # after the prefill, after the chunk
    agree = 0
    for b, n in enumerate(lens):
        ref = dense_forward_logits(
            cfg, params, tokens[b, :n + C].tolist(), device,
            embeds=embeds[b], at=(n_pre + n - 1, n_pre + n + C - 1)).float()
        for i, lg_ in enumerate((lg_p, lg_c)):
            worst[i] = max(worst[i], float((lg_[b].float() - ref[i]).abs()
                                           .max() / ref[i].abs().max()))
            agree += int(int(lg_[b].argmax()) == int(ref[i].argmax()))
    worst_p, worst_c = worst
    print(f"{tag} logits vs plain forward: after prefill max|d|/max|ref|="
          f"{worst_p:.3e}, after the chunk {worst_c:.3e} (tol "
          f"{LOGITS_REL_TOL}), argmax agrees on {agree}/{2 * B}", flush=True)
    if not max(worst_p, worst_c) <= LOGITS_REL_TOL:
        raise AssertionError(f"{tag}: logits disagree: {worst_p} {worst_c}")
    rep = dict(arch=cfg.name, layers=L, encoder_layers=n_enc,
               prompt_lens=list(lens), embeds=n_emb, chunk=C,
               decode_steps=ENCDEC_STEPS, wall_s=t3 - t0, prefill_s=t1 - t0,
               chunk_s=t2 - t1, decode_step_ms=(t3 - t2) * 1e3
               / ENCDEC_STEPS, logits_rel_err_prefill=worst_p,
               logits_rel_err_chunk=worst_c, argmax_agree=agree,
               launches=launches, launches_by_mode=got, expected=expected,
               noncausal_per_decode_step=nc_decode / ENCDEC_STEPS,
               profile=None)
    print(f"{tag} wall_s={rep['wall_s']!r} (prefill {rep['prefill_s']!r} s, "
          f"chunk {rep['chunk_s']!r} s, decode step "
          f"{rep['decode_step_ms']!r} ms)", flush=True)
    if device != "cpu":
        # where the device time goes: the same run again, profiled
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            *_out, ts = run()
        rep["profile"] = prof_ = device_profile(prof, ts[3] - ts[0])
        if prof_ is not None:
            print(f"{tag} profiled run: wall_s={prof_['wall_s']!r} "
                  f"device_busy_s={prof_['device_busy_s']!r} idle_share="
                  f"{prof_['idle_share']!r} by group "
                  f"{prof_['by_group_s']!r}", flush=True)
    return rep


def serve_encdec_phase(counters, device, reduced=False):
    """Phase 6i: full-width whisper-large-v3 (32 encoder + 32 decoder
    layers, 1500 stub frames a request) and internvl2-1b (24 layers, 256
    stub patches a request), random bf16 weights from seed 0, each
    through `serve_encdec`: 4 requests of ENCDEC_SERVES' prompts, one
    chunk, ENCDEC_STEPS decode steps; whisper also through its paged leg
    (`paged_encdec`, report key "paged").  `reduced` rehearses it on the CPU
    at the reduced configs (fp32; prompts cut to their cache).  Returns
    {arch: report}."""
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    out = {}
    for arch, lens, max_len in ENCDEC_SERVES:
        cfg = get_arch(arch, reduced=reduced)
        if reduced:
            lens = tuple(min(n, cfg.max_seq_len // 8) for n in lens)
            max_len = 128
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.float32 if reduced
                             else torch.bfloat16, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        print(f"[init] {cfg.name} weights in {time.monotonic() - t0:.1f} s",
              flush=True)
        out[arch] = serve_encdec(cfg, params, device, counters, lens,
                                 max_len, f"[encdec serve] {cfg.name}")
        if cfg.is_encoder_decoder:
            out[arch]["paged"] = paged_encdec(cfg, params, device, counters,
                                              lens, max_len, ENCDEC_STEPS)
        del params
        if device != "cpu":
            free_device_memory()
    return out


# the paged leg of phase 6i (whisper-large-v3): 16-token pages over the
# dense run's 256-token rows
ENCDEC_PAGED_BLOCK = 16


def paged_encdec(cfg, params, device, counters, lens, max_len, steps):
    """Phase 6i's paged leg (an encoder-decoder's paged cache): `prefill`
    of len(lens) requests into a dense cache (the stub frames and prompts
    of `serve_encdec`), each request's row joined into a paged cache of
    ENCDEC_PAGED_BLOCK-token pages (`paged_cache_join`: its K/V into
    pages, its encoder K/V beside them in its slot), then `steps` eager
    `paged_decode_step`s beside the dense `decode_step`s, both fed the
    dense step's greedy tokens.  Checks: the paged logits agree with the
    dense ones within LOGITS_REL_TOL of the largest at every step; on the
    card each paged step launches #1 once a layer (self-attention over
    the pages) and #2 not causal once a layer (cross-attention over the
    slot's encoder K/V) and nothing else; `paged_cache_clear_slot` of
    every slot leaves an empty table.  Returns the leg's report."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.model import (
        cache_take, decode_step, init_paged_cache, paged_cache_clear_slot,
        paged_cache_join, paged_decode_step, prefill)
    B, S = len(lens), max(lens)
    g = torch.Generator(device="cpu").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    embeds = (torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=g)
              * 0.1).to(device=device, dtype=params["embed"].dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    lg, dense = prefill(cfg, params, tokens.to(device), embeds=embeds,
                        lengths=lengths, max_len=max_len)
    nbt = max_len // ENCDEC_PAGED_BLOCK
    paged = init_paged_cache(cfg, B, 1 + B * nbt, max_len,
                             ENCDEC_PAGED_BLOCK, dtype=params["embed"].dtype,
                             device=device)
    for b in range(B):
        tab = torch.arange(1 + b * nbt, 1 + (b + 1) * nbt,
                           dtype=torch.int32, device=device)
        paged = paged_cache_join(cfg, paged, cache_take(dense, b), b, tab)
    nxt = lg.argmax(-1)[:, None]
    worst, agree, got = 0.0, 0, {w.__name__: 0 for w in counters}
    noncausal = 0
    times = []
    for _ in range(steps):
        lg_d, dense = decode_step(cfg, params, nxt, dense)
        before = {w.__name__: w.launches for w in counters}
        nc0 = flash_prefill.launches_noncausal
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        lg_p, paged = paged_decode_step(cfg, params, nxt, paged)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        for w in counters:
            got[w.__name__] += w.launches - before[w.__name__]
        noncausal += flash_prefill.launches_noncausal - nc0
        ref = lg_d.float()
        worst = max(worst, float((lg_p.float() - ref).abs().max()
                                 / ref.abs().max()))
        agree += int((lg_p.argmax(-1) == lg_d.argmax(-1)).sum())
        nxt = lg_d.argmax(-1)[:, None]
    for b in range(B):
        paged = paged_cache_clear_slot(paged, b)
    cleared = bool((paged["block_tab"] == -1).all())
    L = cfg.num_layers
    expected = {"paged_decode_attention": L * steps,
                "flash_prefill_noncausal": L * steps}
    seen = {"paged_decode_attention": got.get("paged_decode_attention", 0),
            "flash_prefill_noncausal": noncausal}
    others = {k: n for k, n in got.items()
              if k not in ("paged_decode_attention", "flash_prefill") and n}
    tag = f"[encdec paged] {cfg.name}"
    print(f"{tag} {B} requests joined into {ENCDEC_PAGED_BLOCK}-token pages "
          f"(encoder K/V in their slots), {steps} paged decode steps beside "
          f"the dense ones: logits max|d|/max|dense|={worst!r} (tol "
          f"{LOGITS_REL_TOL}), argmax agrees on {agree}/{B * steps}; "
          f"launches in the paged steps {seen!r} (the path's calls: "
          f"{expected!r}), other kernels {others!r}; paged step p50 "
          f"{percentile(times, 0.5) * 1e3!r} ms; table empty after the "
          f"clears: {cleared}", flush=True)
    if device != "cpu" and (seen != expected or others):
        raise AssertionError(f"{tag}: launches {seen} {others}, the path "
                             f"calls {expected}")
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"{tag}: paged logits disagree: {worst}")
    if not cleared:
        raise AssertionError(f"{tag}: the table is not empty after the "
                             f"clears")
    return {"requests": B, "prompt_lens": list(lens), "max_len": max_len,
            "block_size": ENCDEC_PAGED_BLOCK, "steps": steps,
            "logits_rel_err": worst, "argmax_agree": agree,
            "tokens_equal": agree == B * steps, "table_cleared": cleared,
            "launches": seen, "expected": expected,
            "paged_step_p50_ms": percentile(times, 0.5) * 1e3}


# ---------------------------------------------------------------------------
# phase 6k: tensor parallelism inside a DP on the sharded plane
# ---------------------------------------------------------------------------

TP_DATA, TP_MODEL = 2, 2           # the (data, model) mesh of phase 6k
# deepseek-7b's depth in the TP step check: 8 of its 30 layers.  The
# check holds the unsharded step's whole weights and cache beside the
# ranks' pieces and the merged shards (the ranks hold no whole replica:
# the pieces are a second copy of the weights only while the caller
# keeps its tree), and its depth is cut for the smoke's time limit
TP_STEP_LAYERS = 8
TP_STEP_ITERS = 10


def tp_mesh(device):
    """Phase 6k's mesh: two DP units of two tensor-parallel ranks each,
    as four logical shards of one device."""
    from repro_torch.launch.mesh import make_engine_mesh
    return make_engine_mesh(TP_DATA, TP_MODEL,
                            devices=[device] * (TP_DATA * TP_MODEL))


def expected_tp_calls(cfg, M, rows=None):
    """The TP collectives of one merged decode step of `cfg` over M model
    ranks, with `rows` rows a DP (None: a dense prefill chunk on one
    DP's ranks, `expected_tp_chunk_calls`): the embedding's (an
    all-reduce over a vocabulary slice, an all-gather over a d_model
    slice), an all-reduce after each layer's split attention (GQA or
    MLA), split cross-attention and split dense FFN, the row-parallel
    attention's all-reduce of its q|k|v and all-gather of its output's
    d_model slices, two after each split SSM mixer (its gated norm's
    sums of squares, then its out_proj), an all-gather of each MoE
    layer's rows (where they split over the ranks; else, and in a
    chunk, rank 0's outputs are broadcast) and an all-reduce of its
    split shared experts, then the logits' gather (vocabulary slices)
    or reduce (d_model slices)."""
    from repro_torch.config.base import LayerKind
    from repro_torch.distributed.sharding import (
        attn_heads_split, row_parallel, ssm_split)
    V = cfg.vocab_size
    calls = {}

    def add(kind):
        calls[kind] = calls.get(kind, 0) + 1
    rows_split = cfg.attention.name != "MLA" and row_parallel(cfg, M)
    mc = cfg.moe
    shared = (mc is not None and mc.num_shared
              and (mc.num_shared * mc.d_shared) % M == 0)
    add("all_reduce" if V % M == 0 else "all_gather")
    for kind in cfg.layer_kinds():
        if kind in (LayerKind.SSM, LayerKind.SSM_MOE):
            if ssm_split(cfg, M):
                add("all_reduce")
                add("all_reduce")
        elif rows_split:
            add("all_reduce")
            add("all_gather")
        elif attn_heads_split(cfg, M):
            add("all_reduce")
        if cfg.is_encoder_decoder:
            add("all_reduce")               # split cross-attention
            if row_parallel(cfg, M):
                add("all_gather")
        if kind in (LayerKind.MOE, LayerKind.SSM_MOE) and \
                cfg.moe.num_experts:
            add("all_gather" if rows is not None and rows % M == 0
                else "broadcast")
            if shared:
                add("all_reduce")
        elif cfg.d_ff and cfg.d_ff % M == 0:
            add("all_reduce")
    add("gather" if V % M == 0 else "reduce")
    return calls


def expected_tp_chunk_calls(cfg, M):
    """The TP collectives of one dense prefill chunk of `cfg` on a DP's M
    model ranks (`models.model._tp_prefill_chunk`): as a decode step's,
    but each MoE layer runs once from rank 0's rows and is broadcast."""
    return expected_tp_calls(cfg, M, None)


def check_tp_weights(tag, cfg, params, placed, mesh, par):
    """The `[tp weights]` check of a TP leg: each device's weight bytes,
    counted by distinct storage, beside the count `tp_axis` gives
    (`distributed.sharding.tp_weight_report`), and the leaves `tp_axis`
    splits that a rank holds whole.  Raises when the bytes differ or a
    device holds a whole copy of a split leaf.  Returns the report."""
    from repro_torch.distributed.sharding import (
        param_leaves, tp_weight_report)
    rep = tp_weight_report(cfg, params, placed, mesh, par)
    held = {str(d): b for d, b in rep["held"].items()}
    want = {str(d): b for d, b in rep["expected"].items()}
    served = {k: params[k] for k in ("embed", "ln_f", "lm_head", "layers")
              if k in params}
    whole = sum(t.numel() * t.element_size() for t in param_leaves(served))
    print(f"[tp weights] {tag}: per-device weight bytes by storage "
          f"{held!r}, from tp_axis {want!r} (the unsplit tree: {whole} "
          f"bytes); whole copies of split leaves: {len(rep['whole'])}",
          flush=True)
    if held != want or rep["whole"]:
        raise AssertionError(f"[tp weights] {tag}: held {held}, expected "
                             f"{want}, whole copies {rep['whole'][:4]}")
    return {"held": held, "expected": want, "whole": rep["whole"],
            "unsplit_tree_bytes": whole}


def tp_step_check(device, cfg=None, params=None, lens=(128, 1024),
                  iters=TP_STEP_ITERS, mesh=None, tag=None,
                  logits_tol=LOGITS_REL_TOL, rows_per_dp=MAX_BATCH,
                  max_len=MAX_LEN):
    """Phase 6k (b): full-width deepseek-7b at TP_STEP_LAYERS of its 30
    layers (MHA, dense FFN, vocabulary-parallel `lm_head`; bf16 from seed
    0): a prompt for each row prefilled (`prefill`) and joined into a
    paged cache of the mesh's DP units (`rows_per_dp` rows of `max_len`
    each; 16-token pages), and the same cache merged over the mesh
    (`tp_mesh`: (2, 2)).  The TP
    merged decode step's logits must agree with the unsharded paged
    step's on the same rows within LOGITS_REL_TOL of the largest, and
    its collectives must be `expected_tp_calls`; then both steps are
    timed as step graphs (p50 over `iters` replays, each fed the
    previous step's tokens, every device synchronised).  `cfg`/`params`
    replace the model for a CPU rehearsal; `mesh` replaces `tp_mesh`
    (`scripts/tp_four_cards.py`: cuda:0..3, the weights and the
    unsharded cache on `device`, cuda:0; phase 6k's internvl2-1b check:
    a (1, 4) mesh), its (data, model) shape the check's.  An
    encoder-decoder's prompts are prefilled after stub frame embeddings
    of 0.1 · N(0, 1) (seed 7 + the row), so each slot carries its
    encoder K/V.  The placed weights pass `check_tp_weights`.  `tag`
    names another model's
    check (phase 6k's minicpm3-4b and jamba legs: #1 launches once a
    shard in each GQA attention layer, none in MLA or SSM layers);
    `logits_tol` None prints the logits' distance without checking it
    (the jamba leg's bf16 run; its fp32 run is the check).  Returns the
    check's report."""
    import dataclasses
    import torch
    from repro_torch.config.base import ParallelConfig, get_arch
    from repro_torch.distributed.sharding import (
        place_params, shard_paged_cache)
    from repro_torch.distributed.transfer import count_collectives
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.models.model import (
        cache_take, init_paged_cache, init_params, paged_cache_join,
        paged_decode_step, prefill)
    from repro_torch.serving.step_graphs import StepGraphs
    if cfg is None:
        cfg = dataclasses.replace(get_arch("deepseek-7b"),
                                  num_layers=TP_STEP_LAYERS)
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        print(f"[init] {cfg.name} at {cfg.num_layers} layers, bf16 weights "
              f"in {time.monotonic() - t0:.1f} s", flush=True)
    from repro_torch.config.base import LayerKind
    tag = tag or f"[tp step] {cfg.name} ({cfg.num_layers} layers)"
    if cfg.moe is not None and cfg.moe.num_experts:
        # the TP step routes each rank's rows through the EP layer (per-
        # source capacity), the unsharded step all rows at once: at the
        # published capacity they drop different (token, expert) pairs by
        # the reference's semantics, so the check runs the MoE at a
        # capacity that drops none (E / top_k: every token fits every
        # expert) and holds the TP arithmetic alone
        mc = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mc, capacity_factor=max(mc.capacity_factor,
                                    mc.num_experts / mc.top_k)))
        print(f"{tag}: MoE capacity factor {mc.capacity_factor} -> "
              f"{cfg.moe.capacity_factor} for the step check (no drops)",
              flush=True)
    n_gqa = (0 if cfg.attention.name == "MLA" else
             sum(k in (LayerKind.DENSE, LayerKind.MOE)
                 for k in cfg.layer_kinds()))
    mesh = mesh or tp_mesh(device)
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    S = rows_per_dp
    nbt = max_len // BLOCK
    Bd = S * nbt + 1                   # blocks a DP unit, block 0 null
    reqs = make_requests(cfg, n_data * S, seed=3, lens=lens)
    dtype = params["embed"].dtype
    glob = init_paged_cache(cfg, n_data * S, n_data * Bd, max_len, BLOCK,
                            dtype=dtype, device=device)
    first = torch.zeros((n_data * S, 1), dtype=torch.int32, device=device)
    for r in reqs:
        d, s = divmod(r.rid, S)
        toks = torch.tensor([list(r.tokens)], dtype=torch.int32,
                            device=device)
        embeds = None
        if cfg.is_encoder_decoder:
            g = torch.Generator(device="cpu").manual_seed(7 + r.rid)
            embeds = (torch.randn(1, cfg.encoder_seq_len, cfg.d_model,
                                  generator=g) * 0.1).to(device=device,
                                                         dtype=dtype)
        lg, c = prefill(cfg, params, toks, embeds=embeds, max_len=max_len)
        base = d * Bd + 1 + s * nbt
        tab = torch.arange(base, base + nbt, dtype=torch.int32,
                           device=device)
        glob = paged_cache_join(cfg, glob, cache_take(c, 0), r.rid, tab)
        first[r.rid, 0] = lg[0].argmax()
        del c
    merged = shard_paged_cache({k: v.clone() for k, v in glob.items()},
                               mesh, cfg)
    placed = place_params(cfg, params, mesh, ParallelConfig())
    weights = check_tp_weights(tag, cfg, params, placed, mesh,
                               ParallelConfig())
    # what each card holds now: the placed pieces and the merged shards
    # (the first card also the whole weights and the unsharded cache)
    memory = {str(d): torch.cuda.memory_allocated(d)
              for d in mesh.distinct if d.type == "cuda"}
    if memory:
        print(f"[tp memory] {tag}: torch.cuda.memory_allocated per card "
              f"after placement {memory!r}", flush=True)
    want = expected_tp_calls(cfg, n_model, S)
    paged_decode_attention.launches = 0
    with count_collectives() as st:
        lg_tp, merged = paged_decode_step(cfg, placed, first, merged)
    launches = paged_decode_attention.launches
    lg_1, glob = paged_decode_step(cfg, params, first, glob)
    ref = lg_1.float()
    err = float((lg_tp.float() - ref).abs().max() / ref.abs().max())
    agree = int((lg_tp.argmax(-1) == lg_1.argmax(-1)).sum())
    print(f"{tag} ({n_data}, {n_model}) TP merged decode step vs the "
          f"unsharded paged step "
          f"on the same {n_data * S} rows: logits max|d|/max|ref|={err!r} "
          f"({'tol ' + repr(logits_tol) if logits_tol else 'not checked'}"
          f"; {str(dtype).replace('torch.', '')}), argmax agrees on {agree}/"
          f"{n_data * S}; collectives {st.calls!r} (expected {want!r}), "
          f"{st.bytes} bytes between ranks; paged_decode_attention "
          f"launches {launches} (a shard a GQA layer: "
          f"{n_data * n_model * n_gqa})", flush=True)
    if logits_tol is not None and not err <= logits_tol:
        raise AssertionError(f"{tag}: TP logits disagree: {err}")
    if st.calls != want:
        raise AssertionError(f"{tag}: collectives {st.calls}, not {want}")
    if device != "cpu" and launches != n_data * n_model * n_gqa:
        raise AssertionError(f"{tag}: #1 launched {launches} times")
    # both steps as graphs (on the CPU: the same buffers, no capture)
    lock = __import__("threading").RLock()
    times = {}

    def sync():
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    for name, p_, cache, devs in (
            ("tp", placed, merged, mesh.distinct),
            ("unsharded", params, glob, [torch.device(device)])):
        runner = StepGraphs(p_, torch.device(device), lock, devices=devs)

        def fn(c, token, p_=p_):
            return paged_decode_step(cfg, p_, token, c)
        tok = lg_1.argmax(-1)[:, None].to(torch.int32)
        ts = []
        for _ in range(iters + 1):
            sync()
            t0 = time.monotonic()
            lg, cache = runner.run(("decode", name), fn, cache, token=tok)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            sync()
            ts.append(time.monotonic() - t0)
        times[name] = percentile(ts[1:], 0.5)       # the first captures
        del runner, cache
    print(f"{tag} decode step p50 as step graphs: TP ({n_data}, "
          f"{n_model}) merged on "
          f"{[str(d) for d in mesh.distinct]} {times['tp'] * 1e3!r} ms, "
          f"unsharded paged (one device, {n_data * S} rows) "
          f"{times['unsharded'] * 1e3!r} ms", flush=True)
    return {"model": cfg.name, "layers": cfg.num_layers,
            "mesh": [str(d) for d in mesh.devices], "rows": n_data * S,
            "logits_rel_err": err, "argmax_agree": agree,
            "tp_calls": st.calls, "tp_calls_expected": want,
            "tp_bytes": st.bytes, "paged_decode_attention_launches":
                launches,
            "tp_step_p50_s": times["tp"], "weights": weights,
            "memory_allocated_after_placement": memory,
            "unsharded_step_p50_s": times["unsharded"]}


def serve_tp_phase(counters, device, n_layers=None, step_cfg=None,
                   step_params=None, n_requests=N_REQUESTS,
                   lens=(128, 1024), outs=(16, 32)):
    """Phase 6k: tensor parallelism inside a DP on the sharded plane, on
    the (2, 2) mesh `tp_mesh` (four logical shards of the card):
    (a) full-width granite-moe-1b-a400m (24 layers, bf16 from seed 0;
    16 heads over 8 KV heads split 2 ways, 32 experts over the 4 EP
    ranks, the embedding over d_model: its vocabulary of 49155 is odd)
    behind `RealSBSServer(mesh=...)`, P/D as phase 6g's sharded P/D serve
    with 2 decode DP units, with step graphs, on phase 6g's 8 requests,
    with `serve_sharded`'s checks, every merged decode step's TP
    collectives as `expected_tp_calls` says, its dense chunks on DP 0's
    ranks as `check_tp_chunks` says and `check_tp_weights`; then its
    graphs-vs-eager bit
    A/B on an `immediate` burst at SHARDED_BITS_LAYERS layers; (b) the
    deepseek-7b step check (`tp_step_check`).  `n_layers`,
    `step_cfg`/`step_params` and the traffic arguments cut it for a CPU
    rehearsal.  Returns {"pd", "bits", "step"}."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    cfg = get_arch("granite-moe-1b-a400m")
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    mesh = tp_mesh(device)
    out = {}
    out["pd"] = rep = serve_sharded(cfg, params, device, counters, False,
                                    n_requests=n_requests, lens=lens,
                                    outs=outs, mesh=mesh,
                                    tag="[tp pd serve]")
    report_sharded("[tp pd serve]", rep)
    print(f"[tp pd serve] TP per merged decode step: collectives "
          f"{rep['tp_calls_per_decode_step']!r} (expected "
          f"{rep['tp_calls_expected']!r}), bytes "
          f"{rep['tp_bytes_per_decode_step']!r}", flush=True)
    if device != "cpu":
        free_device_memory()
    bits_layers = n_layers or SHARDED_BITS_LAYERS
    out["bits"] = serve_sharded_bits(
        dataclasses.replace(cfg, num_layers=bits_layers),
        dict(params, layers=params["layers"][:bits_layers]), device,
        counters, n_requests=n_requests, lens=lens, outs=outs, mesh=mesh,
        tag="[tp pd bits]")
    del params
    if device != "cpu":
        free_device_memory()
    out["step"] = tp_step_check(device, step_cfg, step_params)
    if device != "cpu":
        free_device_memory()
    return out


# phase 6k, MLA and SSM layers: minicpm3-4b at MLA_LAYERS of its 62
# layers (40 heads, 20 a rank; its latent pools whole on every rank) and
# jamba-v0.1-52b at HYBRID_LAYERS of 32 (one period: the attention
# layer's 32 heads over 8 KV heads, 16 and 4 a rank; 7 SSM layers of
# 128 heads of 64, 64 a rank; 4 MoE layers of 16 experts over the 4 EP
# ranks): 26.5 GB of bf16 weights held by the caller, the ranks' pieces
# of every leaf `tp_axis` splits (about 3.9 GB: the SSM layers, the
# attention, the dense FFNs, the embedding and head; the experts and
# every unsplit leaf are the caller's tensors) and four shards of pools
# and slot states


def check_ssd_rank_shape(device, cfg, M):
    """#4 at a tensor-parallel rank's share of `cfg`'s SSM heads (nh/M
    heads of hp, one chunk of Q tokens, bf16 inputs, fp32 outputs)
    against its plain version within REL_TOL["float32"], as phase 4
    holds #4 off its served shape: the kernel's contract (n_groups 1, hp
    32 or 64, Q up to 256) holds for the rank's piece.  Bit-identity is
    printed, not required: the plain version's products take another
    summation order at another head count; the served dense chunks run
    #4 at this share on each rank (`check_tp_chunks`).  Returns the
    check's report."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
    from repro_torch.models.mamba import ssm_dims
    sc = cfg.ssm
    _di, nh, _ = ssm_dims(cfg.d_model, sc)
    args = ssd_case(1, 1, sc.chunk_size, nh // M, sc.head_dim, sc.d_state,
                    device, 11, torch.bfloat16)
    with uncounted():
        y, st = ssd_chunk(*args)
    yp, sp = ssd_chunk_plain(*args)
    errs = []
    tag = (f"[tp hybrid] ssd_chunk at a rank's share ({nh // M} of {nh} "
           f"heads of {sc.head_dim}, Q {sc.chunk_size}, d_state "
           f"{sc.d_state}, bf16 in)")
    compare(tag + " y", y, yp, errs)
    compare(tag + " state", st, sp, errs)
    same = bool(torch.equal(y, yp) and torch.equal(st, sp))
    print(f"{tag}: bit-identical to the plain version: {same} (not "
          f"required off the served shape)", flush=True)
    return {"heads": nh // M, "of": nh, "bit_identical": same,
            "max_abs_err": max(a for a, _r in errs),
            "max_rel_err": max(r for _a, r in errs)}


def serve_tp_mla_ssm(counters, device, mla_cfg=None, mla_params=None,
                     hybrid_cfg=None, hybrid_params=None,
                     n_requests=N_REQUESTS, lens=(128, 1024),
                     outs=(16, 32)):
    """Phase 6k's MLA and SSM legs on the (2, 2) mesh `tp_mesh`: (a)
    full-width minicpm3-4b at MLA_LAYERS layers behind the TP P/D server
    with step graphs (`serve_sharded`: every merged decode step's TP
    collectives as `expected_tp_calls` says, logits against the
    non-absorbed plain forward; no kernel launches on MLA), its
    graphs-vs-eager bit A/B, and its TP merged step against the
    unsharded step (`tp_step_check`); (b) full-width jamba-v0.1-52b at
    HYBRID_LAYERS layers behind the TP P/D server (#1 a rank in the
    attention layer; #2 contiguous and #4 each rank its heads in the
    dense chunks on DP 0's ranks, 2 and 14 a chunk; the served logits
    equal the eager replay of the served chunks, on the ranks, and
    expert sets bit for bit), #4 at a rank's share of the SSM heads
    against its plain version (`check_ssd_rank_shape`), and its TP
    merged step against the unsharded step in bf16 (printed) and, the
    weights widened in place, in fp32 (within REL_TOL["float32"]).  The
    config and weight arguments cut it for a CPU rehearsal.  Returns {"mla":
    ..., "hybrid": ...}."""
    import dataclasses
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    mesh = tp_mesh(device)
    size = dict(n_requests=n_requests, lens=lens, outs=outs)
    out = {}
    for leg, arch, layers in (("mla", "minicpm3-4b", MLA_LAYERS),
                              ("hybrid", "jamba-v0.1-52b", HYBRID_LAYERS)):
        cfg, params = ((mla_cfg, mla_params) if leg == "mla"
                       else (hybrid_cfg, hybrid_params))
        if cfg is None:
            cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
            t0 = time.monotonic()
            params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                                 device=device)
            torch.cuda.synchronize()
            print(f"[init] {cfg.name} at {cfg.num_layers} layers, bf16 "
                  f"weights in {time.monotonic() - t0:.1f} s", flush=True)
        tag = f"[tp {leg} pd serve]"
        rep = serve_sharded(cfg, params, device, counters, False,
                            mesh=mesh, tag=tag,
                            exact_replay=[] if leg == "hybrid" else None,
                            **size)
        report_sharded(tag, rep)
        print(f"{tag} TP per merged decode step: collectives "
              f"{rep['tp_calls_per_decode_step']!r} (expected "
              f"{rep['tp_calls_expected']!r}), bytes "
              f"{rep['tp_bytes_per_decode_step']!r}; launches "
              f"{rep['launches']!r}", flush=True)
        if device != "cpu":
            free_device_memory()
        if leg == "mla":
            rep["bits"] = serve_sharded_bits(cfg, params, device, counters,
                                             mesh=mesh,
                                             tag="[tp mla pd bits]", **size)
        else:
            rep["ssd_rank_shape"] = check_ssd_rank_shape(device, cfg,
                                                         TP_MODEL)
        if device != "cpu":
            free_device_memory()
        step_tag = f"[tp {leg} step] {cfg.name} ({cfg.num_layers} layers)"
        if leg == "mla":
            rep["step"] = tp_step_check(device, cfg, params, lens=lens,
                                        tag=step_tag)
        else:
            # bf16: 7 SSM layers and 4 MoE routers over random weights
            # move the TP step's logits from the unsharded step's past
            # 5e-2 (0.136 at 8 layers on the card; 2.2e-2 at the reduced
            # width), as phase 6h's served-vs-plain distance: printed,
            # then the check in fp32 (`widen_params`, as phase 6h)
            rep["step_bf16"] = tp_step_check(device, cfg, params, lens=lens,
                                             tag=step_tag, logits_tol=None)
            if device != "cpu":
                free_device_memory()
            widen_params(params)
            if device != "cpu":
                free_device_memory()
            rep["step"] = tp_step_check(device, cfg, params, lens=lens,
                                        tag=step_tag + " fp32",
                                        logits_tol=REL_TOL["float32"])
        out[leg] = rep
        del params
        if device != "cpu":
            free_device_memory()
    return out


# phase 6k, the row-parallel form and the split cross-attention: full-width
# internvl2-1b (24 layers; 14 heads over 2 KV heads do not split 4 ways:
# the row-parallel form) on a (1, 4) mesh and full-width whisper-large-v3
# (32 decoder layers; cross-attention by heads over each slot's encoder
# K/V split the same way) on the (2, 2) mesh, each through `tp_step_check`
# (whisper's 4 requests: 2 rows a DP, 256-token rows)
TP_WHISPER_MAX_LEN = 256


def tp_share_checks(device, internvl=None, whisper=None, lens=(16, 200)):
    """Phase 6k's step checks of the splits TP holds only its shares of:
    internvl2-1b's text rows on a (1, 4) logical mesh of the card (the
    row-parallel attention: 48 all-reduces, 25 all-gathers, 1 reduce a
    step predicted) and whisper-large-v3 on the (2, 2) mesh (the split
    cross-attention over 4 requests' encoder K/V: 97 all-reduces, 1
    gather), random bf16 weights from seed 0, each TP merged step's
    logits against the unsharded paged step's within LOGITS_REL_TOL
    (whisper: where bf16 misses, printed, then checked in fp32 within
    REL_TOL["float32"], as the jamba leg), collectives as predicted,
    `[tp weights]` passing.  `internvl`/`whisper` ((cfg, params))
    replace the models for a CPU rehearsal.  Returns {"internvl": ...,
    "whisper": ...}."""
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.model import init_params
    out = {}
    for leg, arch, shape, given in (("internvl", "internvl2-1b", (1, 4),
                                     internvl),
                                    ("whisper", "whisper-large-v3", (2, 2),
                                     whisper)):
        if given is None:
            cfg = get_arch(arch)
            t0 = time.monotonic()
            params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                                 device=device)
            torch.cuda.synchronize()
            print(f"[init] {cfg.name}, bf16 weights in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        else:
            cfg, params = given
        mesh = make_engine_mesh(*shape, devices=[device] * 4)
        tag = f"[tp {leg} step] {cfg.name} ({cfg.num_layers} layers)"
        kw = dict(lens=lens, mesh=mesh, tag=tag)
        if leg == "internvl":
            out[leg] = tp_step_check(device, cfg, params, **kw)
        else:
            kw.update(rows_per_dp=2, max_len=TP_WHISPER_MAX_LEN)
            rep = tp_step_check(device, cfg, params, logits_tol=None, **kw)
            ok = rep["logits_rel_err"] <= LOGITS_REL_TOL
            print(f"{tag}: bf16 logits {rep['logits_rel_err']!r} against "
                  f"the limit {LOGITS_REL_TOL}: "
                  f"{'within' if ok else 'missed; checked in fp32'}",
                  flush=True)
            if not ok:
                if device != "cpu":
                    free_device_memory()
                widen_params(params)
                rep = dict(tp_step_check(
                    device, cfg, params, logits_tol=REL_TOL["float32"],
                    **dict(kw, tag=tag + " fp32")), bf16=rep)
            out[leg] = rep
        del params
        if device != "cpu":
            free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 6l: the launchers (launch/serve.py --mode real, the microbench twin)
# ---------------------------------------------------------------------------

def launch_phase(counters, device, requests=8):
    """Phase 6l: `python -m repro_torch.launch.serve --mode real --arch
    deepseek-7b --device <device>` as a user runs it (its `main`, in this
    process; the launcher's default arch, reduced deepseek-v3-671b, is
    MLA and runs no kernel): reduced deepseek-7b from seed 0 behind
    `RealSBSServer` in the reference launcher's defaults (the P/D plane on
    the padded cache: #3 and #2's contiguous entry), `requests` prompts of
    16-95 tokens 50 ms apart, 8 new tokens each; every request must finish
    with 8 tokens and the kernels of its plane must launch and no other.
    Then the microbench twin (`scripts/microbench_torch.py`, its `main` on
    `device`): every row.  Returns {"serve": ..., "microbench": rows}."""
    import contextlib
    import importlib.util
    import io
    import re
    from repro_torch.launch import serve as launcher
    for w in counters:
        w.launches = 0
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--mode", "real", "--arch", "deepseek-7b",
                       "--device", device, "--requests", str(requests)])
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in counters}
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[launch serve] {line}", flush=True)
    gens = [re.match(r"rid=(\d+) ttft=\s*([\d.]+)ms tokens=\[(.*)\]", l)
            for l in lines]
    gens = [g for g in gens if g]
    tokens = {int(g[1]): [int(t) for t in g[3].split(",")] for g in gens}
    ttft_ms = {int(g[1]): float(g[2]) for g in gens}
    print(f"[launch serve] launch/serve.py --mode real --device {device}: "
          f"wall_s={wall!r} (server build included), launches "
          f"{launches!r}", flush=True)
    if sorted(tokens) != list(range(requests)) or any(
            len(t) != 8 for t in tokens.values()):
        raise AssertionError(f"[launch serve] served {sorted(tokens)} of "
                             f"{requests} requests")
    launched = {"decode_attention", "flash_prefill"}
    for name, n in launches.items():
        if name in launched and device != "cpu" and n <= 0:
            raise AssertionError(f"[launch serve] {name} never launched")
        if name not in launched and n != 0:
            raise AssertionError(f"[launch serve] {name} launched {n} "
                                 f"times")
    spec = importlib.util.spec_from_file_location(
        "microbench_torch", os.path.join(ROOT, "scripts",
                                         "microbench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with uncounted():
        rows = mod.main(lambda line: print(f"[microbench] {line}",
                                           flush=True), device)
    for r in rows:
        print(f"[microbench] {r}", flush=True)
    if len(rows) != 11:
        raise AssertionError(f"[microbench] {len(rows)} rows, not 11")
    return {"serve": {"arch": "deepseek-7b[reduced]", "device": device,
                      "wall_s": wall, "tokens": tokens, "ttft_ms": ttft_ms,
                      "launches": launches},
            "microbench": rows}


# ---------------------------------------------------------------------------
# phase 6j: the training path on full-width minicpm-2b
# ---------------------------------------------------------------------------

# minicpm-2b (arXiv:2404.06395), the WSD schedule's own model, at full
# width and depth (40 layers, d 2304, 36 heads of 64, d_ff 5760, vocab
# 122753, tied embeddings; 2.72 B parameters), in fp32 as the reference's
# Trainer, without TF32; one batch of 2 × 512 tokens
TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 8
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
# a gradient leaf through #2's Function against the same leaf through the
# plain attention under autograd, max|d| / max|plain| (fp32, 40 layers)
GRAD_REL_TOL = 1e-3
# below this much free device memory at the no-remat peak, train with remat
TRAIN_MIN_FREE_BYTES = 8e9


@contextlib.contextmanager
def plain_training_attention():
    """Within it, the training forward's attention (`_flash_full` under
    autograd) runs `flash_prefill_plain` and autograd goes through its
    torch ops, instead of #2's Function."""
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.models import blocks
    inner = blocks.flash_prefill_train
    blocks.flash_prefill_train = flash_prefill_plain
    try:
        yield
    finally:
        blocks.flash_prefill_train = inner


def loss_and_grads(cfg, params, batch):
    """(loss, metrics, gradient of every leaf of `params` in
    `tree_leaves` order, None where the loss does not reach it) of
    `forward_train`, with the launches of #2 in the forward."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.model import forward_train
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    flash_prefill.launches = 0
    loss, metrics = forward_train(cfg, params, batch)
    launches = flash_prefill.launches
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), metrics, grads, launches


def time_flash_train(device, B=TRAIN_BATCH, S=TRAIN_SEQ, H=36, hd=64):
    """#2's contiguous entry at the training forward's shape (causal, fp32,
    H = K, one segment): the kernel against its plain version, its device
    and wall ms, the plain version's, SDPA's (causal, no mask), the
    backward's (`flash_prefill_backward`, torch ops) and the bound: the
    body's three TF32 products (3xTF32) over the TF32 tensor peak, or
    bytes over HBM; `bound_fma_ms` is the same work once over the fp32
    FMA peak, the bound of an fp32 body without tensor cores."""
    import torch
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_backward, flash_prefill_plain)
    out = {"errs": []}
    q, k, v, qp, kp, qs, ks = full_case(B, S, S, H, H, hd, device, 5,
                                        torch.float32, encoder=True)
    with uncounted():
        got = flash_prefill(q, k, v, qp, kp, qs, ks, causal=True)
    ref = flash_prefill_plain(q, k, v, qp, kp, qs, ks, causal=True)
    compare(f"[flash prefill train] causal B={B} S={S} H=K={H} hd={hd}",
            got, ref, out["errs"])
    n = 4
    kk, vv = copies(k, n), copies(v, n)
    with uncounted():
        out["ms"], out["wall_ms"] = time_ms(lambda i: flash_prefill(
            q, kk[i], vv[i], qp, kp, qs, ks, causal=True), n, iters=30)
    out["plain_ms"], _ = time_ms(lambda i: flash_prefill_plain(
        q, kk[i], vv[i], qp, kp, qs, ks, causal=True), n, iters=5)
    do = torch.randn_like(got)
    out["backward_ms"], out["backward_wall_ms"] = time_ms(
        lambda i: flash_prefill_backward(q, kk[i], vv[i], got, do, qp, kp,
                                         qs, ks, causal=True), n, iters=5)
    qt = q.transpose(1, 2).contiguous()
    kt = [t.transpose(1, 2).contiguous() for t in kk]
    vt = [t.transpose(1, 2).contiguous() for t in vv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"], out["library_wall_ms"] = time_ms(
        lambda i: sdpa(qt, kt[i], vt[i], is_causal=True), n, iters=30)
    esz = q.element_size()
    nbytes, flops = attention_work(
        q, 2 * k.numel() * esz, B * S * (S + 1) // 2, q.numel() * esz,
        extra=4 * (2 * qp.numel() + 2 * kp.numel()))
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * flops, TF32_FLOPS)
    out["bound_fma_ms"], _ = bound(nbytes, flops, FP32_FLOPS)
    out["shape"] = (f"B={B} Sq=Skv={S} H=K={H} hd={hd} fp32, causal "
                    f"(minicpm-2b's training forward; SDPA is_causal, no "
                    f"mask; bound: 3xTF32 at the TF32 peak)")
    report_timing("[flash prefill train]", out)
    print(f"[flash prefill train] bound 3xTF32 at 495 TFLOP/s "
          f"{out['bound_ms']!r} ms ({out['bound_by']}); the same work at "
          f"the 67 TFLOP/s fp32 FMA peak {out['bound_fma_ms']!r} ms",
          flush=True)
    print(f"[flash prefill train] backward (torch ops) ms="
          f"{out['backward_ms']!r} wall_ms={out['backward_wall_ms']!r}",
          flush=True)
    return out


def train_phase(device, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_STEPS):
    """Phase 6j: the training path (`forward_train`, autograd through #2's
    Function, the AdamW/WSD `Trainer`) on full-width minicpm-2b in fp32
    (random weights from seed 0, made on the card; TF32 off), one
    synthetic batch of `batch` × `seq` tokens (`synthetic_batches`, seed
    0): (a) one step's loss and every gradient leaf through #2 against
    the same step with `flash_prefill_plain` under autograd, within
    GRAD_REL_TOL of each leaf's largest, every parameter with a finite
    gradient, #2 launched once a GQA layer a forward; (b) `steps`
    `Trainer` steps with WSD (warmup TRAIN_WARMUP) on that batch: loss
    and grad_norm finite, the last ce below the first, #2 launched once
    a layer a step (the backward launches none); step time p50, tokens/s
    and the peak memory; (c) one more step under the profiler (device
    busy, idle share); (d) one step with remat=True (#2's recomputations
    counted apart); (e) #2 timed at the step's shape (`time_flash_train`).
    `cfg` and the sizes let a CPU rehearsal pass a reduced model.
    Returns the phase's report."""
    import itertools
    import torch
    from repro_torch.config.base import AttentionKind, TrainConfig, get_arch
    from repro_torch.data import synthetic_batches
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.blocks import ATTN_KINDS
    from repro_torch.models.model import init_params
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    on_card = device != "cpu"
    if on_card and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the training phase runs "
                             "fp32 as the reference's Trainer")
    cfg = cfg or get_arch(TRAIN_ARCH)
    n_attn = sum(k in ATTN_KINDS for k in cfg.layer_kinds()) \
        if cfg.attention != AttentionKind.MLA else 0
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if on_card:
        torch.cuda.synchronize()
    print(f"[init] {cfg.name} fp32 weights ({n_params} parameters) in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    data = next(synthetic_batches(cfg.vocab_size, batch, seq, seed=0))
    b = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    tag = "[train]"

    # (a) gradients through #2's Function against the plain attention's
    loss_k, _m, grads_k, launches_fwd = loss_and_grads(cfg, params, b)
    missing = [i for i, g in enumerate(grads_k) if g is None]
    bad = [i for i, g in enumerate(grads_k)
           if g is not None and not torch.isfinite(g).all()]
    if missing or bad:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a "
                             f"gradient, {len(bad)} with a non-finite one")
    with plain_training_attention():
        loss_p, _m, grads_p, _n = loss_and_grads(cfg, params, b)
    worst = 0.0
    for gk, gp in zip(grads_k, grads_p):
        worst = max(worst, float((gk - gp).abs().max()
                                 / gp.abs().max().clamp_min(1e-30)))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grads_k, grads_p, _m
    print(f"{tag} one step through #2's Function vs the plain attention "
          f"under autograd: loss {loss_k!r} vs {loss_p!r} (rel "
          f"{loss_rel!r}), worst gradient leaf max|d|/max|plain|="
          f"{worst!r} over {len(tree_leaves(params))} leaves (tol "
          f"{GRAD_REL_TOL}); every parameter has a finite gradient; "
          f"flash_prefill launches in the forward: {launches_fwd} "
          f"({n_attn} attention layers)", flush=True)
    if not (worst <= GRAD_REL_TOL and loss_rel <= GRAD_REL_TOL):
        raise AssertionError(f"{tag}: gradients through #2 disagree with "
                             f"the plain attention's: {worst}, loss "
                             f"{loss_rel}")
    if on_card and launches_fwd != n_attn:
        raise AssertionError(f"{tag}: #2 launched {launches_fwd} times in "
                             f"a forward of {n_attn} attention layers")
    if on_card:
        free_device_memory()

    # (b) Trainer steps on the one batch
    tcfg = TrainConfig(global_batch=batch, seq_len=seq, lr=TRAIN_LR,
                       schedule="wsd", warmup_steps=TRAIN_WARMUP,
                       total_steps=steps)
    tr = Trainer(cfg, tcfg, device=device, params=params)
    del params
    fixed = itertools.repeat(data)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    hist, step_s, launches = [], [], []
    for _ in range(steps):
        if on_card:
            torch.cuda.synchronize()
        flash_prefill.launches = 0
        t0 = time.perf_counter()
        tr.fit(fixed, 1, log_every=1, log_fn=lambda l: print(
            f"{tag} {l}", flush=True))
        if on_card:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(flash_prefill.launches)
        m = tr.last_metrics
        hist.append({k: float(m[k]) for k in ("ce", "loss", "grad_norm",
                                              "lr")})
    peak = torch.cuda.max_memory_allocated() if on_card else None
    total = (torch.cuda.get_device_properties(0).total_memory if on_card
             else None)
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"{tag}: a non-finite loss or grad_norm: "
                             f"{hist!r}")
    if not hist[-1]["ce"] < hist[0]["ce"]:
        raise AssertionError(f"{tag}: ce did not fall over {steps} steps: "
                             f"{hist[0]['ce']} -> {hist[-1]['ce']}")
    if on_card and set(launches) != {n_attn}:
        raise AssertionError(f"{tag}: #2 launches per step {launches}, "
                             f"not {n_attn}")
    p50 = percentile(step_s, 0.5)
    print(f"{tag} ce first {hist[0]['ce']!r} last {hist[-1]['ce']!r} over "
          f"{steps} steps (WSD, warmup {TRAIN_WARMUP}, peak lr {TRAIN_LR})",
          flush=True)
    print(f"{tag} step_s={step_s!r}", flush=True)
    print(f"{tag} step_p50_s={p50!r}", flush=True)
    print(f"{tag} tokens_per_s={batch * seq / p50!r}", flush=True)
    print(f"{tag} peak_memory_bytes={peak!r} of {total!r} (free at the "
          f"peak {None if peak is None else total - peak!r}; remat needed "
          f"below {TRAIN_MIN_FREE_BYTES:.0f})", flush=True)
    print(f"{tag} flash_prefill launches per step: {launches!r}", flush=True)
    if on_card and total - peak < TRAIN_MIN_FREE_BYTES:
        raise AssertionError(f"{tag}: the no-remat peak leaves "
                             f"{total - peak} bytes free; train with remat")

    # (c) one step under the profiler
    prof_rep = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            tr.fit(fixed, 1, log_every=0)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        prof_rep = device_profile(prof, wall)
        print(f"{tag} profiled step: wall_s={wall!r} device_busy_s="
              f"{prof_rep and prof_rep['device_busy_s']!r} idle_share="
              f"{prof_rep and prof_rep['idle_share']!r} by_group_s="
              f"{prof_rep and prof_rep['by_group_s']!r}", flush=True)

    # (d) one step with remat: #2's forward launches, then as many
    # recomputations in the backward
    remat_fn = make_train_step(cfg, tcfg, remat=True)
    bt = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    if on_card:
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    flash_prefill.launches = 0
    t0 = time.perf_counter()
    tr.params, tr.opt_state, m = remat_fn(tr.params, tr.opt_state, bt)
    float(m["loss"])
    remat_s = time.perf_counter() - t0
    remat_launches = flash_prefill.launches
    remat_peak = torch.cuda.max_memory_allocated() if on_card else None
    print(f"{tag} remat=True step: {remat_s!r} s, flash_prefill launches "
          f"{remat_launches} ({n_attn} forward + "
          f"{remat_launches - n_attn} recomputed), peak_memory_bytes="
          f"{remat_peak!r}", flush=True)
    if on_card and remat_launches != 2 * n_attn:
        raise AssertionError(f"{tag}: #2 launched {remat_launches} times in "
                             f"a remat step, not {2 * n_attn}")
    del tr, m
    if on_card:
        free_device_memory()
    kernel = time_flash_train(device) if on_card else None
    return {
        "model": cfg.name, "dtype": "float32", "layers": cfg.num_layers,
        "parameters": n_params, "batch": batch, "seq": seq,
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "grad_check": {"loss_kernel": loss_k, "loss_plain": loss_p,
                       "loss_rel": loss_rel, "worst_leaf_rel": worst,
                       "tol": GRAD_REL_TOL},
        "history": hist, "step_s": step_s, "step_p50_s": p50,
        "tokens_per_s": batch * seq / p50, "peak_memory_bytes": peak,
        "device_memory_bytes": total,
        "flash_prefill_per_step": launches[0], "launches": launches,
        "flash_prefill_forward": launches_fwd,
        "remat": {"step_s": remat_s, "flash_prefill": remat_launches,
                  "recomputed": remat_launches - launches[0],
                  "peak_memory_bytes": remat_peak},
        "profile": prof_rep, "kernel": kernel,
    }


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
    start = time.monotonic()

    def elapsed(phase):
        print(f"[time] {phase} done, {time.monotonic() - start:.1f} s since "
              f"start", flush=True)
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
        full = check_flash_full(device)
        ssd = check_ssd(device)
        elapsed("kernel checks")
        for tag, r in (("[decode]", dec), ("[dense decode]", dense),
                       ("[paged prefill]", pfx), ("[flash prefill]", fla),
                       ("[flash prefill not causal]", full), ("[ssd]", ssd)):
            report_timing(tag, r)
            if "hd120" in r:
                report_timing(f"{tag} hd=120", r["hd120"])
        cfg = dataclasses.replace(get_arch("deepseek-7b"),
                                  num_layers=SERVE_LAYERS)
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
        torch.cuda.synchronize()
        print(f"[init] {cfg.name} bf16 weights in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        counters = [paged_decode_attention, paged_prefill_attention,
                    flash_prefill, decode_attention, ssd_chunk]
        mixed, mixed_eager = serve_modes(cfg, params, device, counters,
                                         "[serve]")
        for name in ("paged_decode_attention", "paged_prefill_attention"):
            if mixed["launches"][name] <= 0:
                raise AssertionError(f"{name} never launched on the mixed "
                                     f"serve")
        report_serve("[serve]", mixed)
        report_serve("[serve eager]", mixed_eager)
        mixed["eager"] = {k: v for k, v in mixed_eager.items()
                          if k != "prefill_chunks"}
        elapsed("mixed serve (graphs and eager)")
        free_device_memory()
        pd = serve_pd(cfg, params, device, counters)
        elapsed("P/D serve")
        report_serve("[pd serve]", pd)
        print(f"[pd serve] launches={pd['launches']!r} per decode step: "
              f"decode_attention="
              f"{pd['decode_attention_per_decode_step']!r}, per prefill "
              f"pass: flash_prefill="
              f"{pd['flash_prefill_per_prefill_pass']!r}", flush=True)
        free_device_memory()
        pd["eager"] = serve_pd(cfg, params, device, counters,
                               tag="[pd serve eager]", step_graphs=False,
                               profile=False)
        report_pd_modes("[pd serve]", pd, pd["eager"])
        pd["bits"] = serve_pd_bits(cfg, params, device, counters)
        elapsed("P/D serve eager and graphs-vs-eager A/B")
        del params
        free_device_memory()
        scfg_ = dataclasses.replace(get_arch("mamba2-370m"),
                                    num_layers=SSM_LAYERS)
        t0 = time.monotonic()
        sparams = init_params(scfg_, seed=0, dtype=torch.bfloat16,
                              device=device)
        torch.cuda.synchronize()
        print(f"[init] {scfg_.name} bf16 weights in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        ssm = serve_pd(scfg_, sparams, device, counters, tag="[ssm serve]",
                       forward=ssm_forward_logits,
                       info_forward=ssm_whole_prompt_logits,
                       launched=("ssd_chunk",))
        elapsed("SSM serve")
        print(f"[ssm serve] logits_rel_err={ssm['logits_rel_err']!r} "
              f"(limit {LOGITS_REL_TOL}; recorded: a 1e-7 relative "
              f"perturbation of kernel #4's output gives "
              f"{SSM_LOGITS_AT_1E7} at all 48 layers)", flush=True)
        report_serve("[ssm serve]", ssm)
        print(f"[ssm serve] decode_steps={ssm['decode_steps']} "
              f"prefill_passes={ssm['prefill_passes']} ssd_chunk "
              f"launches={ssm['launches']['ssd_chunk']} "
              f"({ssm['ssd_chunk_per_prefill_pass']!r} per prefill pass)",
              flush=True)
        free_device_memory()
        ssm["eager"] = serve_pd(scfg_, sparams, device, counters,
                                tag="[ssm serve eager]",
                                forward=ssm_forward_logits,
                                launched=("ssd_chunk",), step_graphs=False,
                                profile=False)
        report_pd_modes("[ssm serve]", ssm, ssm["eager"])
        del sparams
        free_device_memory()
        swa = serve_swa(counters, device, n_layers=SWA_LAYERS)
        elapsed("SWA serve")
        free_device_memory()
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
        torch.cuda.synchronize()
        print(f"[init] {cfg.name} bf16 weights in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        px = serve_pd_prefix(cfg, params, device, counters)
        elapsed("shared-prefix P/D serve")
        for w in (0, 1):
            print(f"[pd prefix serve] wave {w + 1}: "
                  f"wall_s={px['wall_s_per_wave'][w]!r}", flush=True)
        report_serve("[pd prefix serve]", px)
        print(f"[pd prefix serve] prefix_stats wave 1: "
              f"{px['prefix_stats_wave1']!r}", flush=True)
        print(f"[pd prefix serve] prefix_stats after wave 2: "
              f"{px['prefix_stats']!r} (computed prompts "
              f"{px['computed_prompts']}, full hits {px['full_hits']}, "
              f"{px['pools_emptied']} pools empty after eviction)",
              flush=True)
        print(f"[pd prefix serve] launches per decode "
              f"step: paged_decode_attention="
              f"{px['paged_decode_attention_per_decode_step']!r}, per "
              f"prefill pass: paged_prefill_attention="
              f"{px['paged_prefill_attention_per_prefill_pass']!r} "
              f"(decode_steps={px['decode_steps']}, "
              f"prefill_passes={px['prefill_passes']})", flush=True)
        del params
        free_device_memory()
        moe_rep = serve_moe(counters, device, n_layers=MOE_LAYERS)
        elapsed("MoE serve (graphs and eager)")
        free_device_memory()
        mla = serve_mla(counters, device, n_layers=MLA_LAYERS)
        elapsed("MLA serve")
        free_device_memory()
        sharded = serve_sharded_phase(counters, device)
        elapsed("sharded serves")
        free_device_memory()
        hybrid = serve_hybrid_phase(counters, device)
        elapsed("hybrid serves (jamba, paged and sharded)")
        free_device_memory()
        t0 = time.monotonic()
        encdec = serve_encdec_phase(counters, device)
        print(f"[encdec serve] phase 6i wall_s="
              f"{time.monotonic() - t0!r}", flush=True)
        elapsed("full-sequence serves (whisper, internvl2-1b; whisper "
                "paged)")
        tp = serve_tp_phase(counters, device)
        print(f"[tp] merged decode step p50: (2, 2) TP P/D serve "
              f"{tp['pd']['decode_step_p50_s']!r} s beside phase 6g's "
              f"data-only (4, 1) P/D serve "
              f"{sharded['pd']['decode_step_p50_s']!r} s", flush=True)
        elapsed("TP serves (granite-moe P/D, bits A/B; deepseek-7b step)")
        tp.update(serve_tp_mla_ssm(counters, device))
        for leg in ("mla", "hybrid"):
            st = tp[leg].get("step_bf16", tp[leg]["step"])
            print(f"[tp {leg}] merged decode step p50 "
                  f"{tp[leg]['decode_step_p50_s']!r} s; bf16 TP step "
                  f"{st['tp_step_p50_s']!r} s vs unsharded "
                  f"{st['unsharded_step_p50_s']!r} s; logits vs the "
                  f"unsharded step {tp[leg]['step']['logits_rel_err']!r} "
                  f"(checked, "
                  f"{'fp32' if 'step_bf16' in tp[leg] else 'bf16'})",
                  flush=True)
        elapsed("TP serves of MLA and SSM layers (minicpm3-4b, jamba)")
        tp.update(tp_share_checks(device))
        elapsed("TP step checks (internvl2-1b (1, 4), whisper (2, 2))")
        launch = launch_phase(counters, device)
        elapsed("launchers (serve --mode real, microbench twin)")
        train = train_phase(device)
        elapsed("training path (minicpm-2b, fp32)")
        free_device_memory()
        twin = serve_twin(counters, device, elapsed=elapsed)
        split = prefill_split(device)
        elapsed("prefill pass split")
        kernels = kernel_items(dec, dense, pfx, fla, ssd, mixed, pd, ssm, px,
                               moe_rep, swa, twin, sharded, hybrid, full,
                               encdec, train, tp, launch)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(json.dumps({"serve": mixed}), flush=True)
        print(json.dumps({"serve_pd": pd}), flush=True)
        print(json.dumps({"serve_ssm": ssm}), flush=True)
        print(json.dumps({"serve_pd_prefix": px}), flush=True)
        print(json.dumps({"serve_swa": swa}), flush=True)
        print(json.dumps({"serve_moe": moe_rep}), flush=True)
        print(json.dumps({"serve_mla": mla}), flush=True)
        print(json.dumps({"serve_sharded": sharded}), flush=True)
        print(json.dumps({"serve_hybrid": hybrid}), flush=True)
        print(json.dumps({"serve_twin": twin}), flush=True)
        print(json.dumps({"prefill_pass_split": split}), flush=True)
        print(json.dumps({"serve_encdec": encdec}), flush=True)
        print(json.dumps({"serve_tp": tp}), flush=True)
        print(json.dumps({"launch": launch}), flush=True)
        print(json.dumps({"train": train}), flush=True)
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
