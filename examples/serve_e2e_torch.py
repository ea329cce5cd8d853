"""End-to-end serving benchmark of the PyTorch port, the twin of
`examples/serve_e2e.py`: serve a model through the REAL P/D-separated
SBS control plane — ClusterRuntime in realtime mode drives threaded
engines executing true chunked prefill, KV-cache handoff, and continuous
batched decode (paged block-table KV by default) on the port's PyTorch
forwards (CUDA graphs of the decode steps and the dense and
page-native prefill chunks, the hand-written Hopper attention kernels);
EndForward feedback adapts the dispatch interval online.  Runs every
scheduler variant over the same request set and reports per-request
TTFT plus the decode plane's peak concurrent residency.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--requests 8]
        [--arch ID] [--schedulers immediate,sbs,sbs-la] [--timeout 120]
        [--block-size 16] [--compare-padded] [--bench-json BENCH_torch.json]
        [--device cuda|cpu] [--reduced] [--mesh-devices cuda:0x4]

Every trace, deployment, warm-up serve, repetition count, median and
gate is the reference's (each trace is built by a module-level function
below, so that tests and `chip_smoke.py` can import it); what differs is
what the card requires:

  * `--device` (default `cuda`) places weights and caches; with no GPU
    and no `--device cpu` it raises (there is no silent CPU fallback);
  * the model is served at its published width in bf16 (the port's
    `init_params(cfg, seed, dtype=torch.bfloat16)`); `--reduced` serves
    the reference's reduced config in fp32, as the reference always does;
  * every written section also carries `"device"`: the card's name and
    power limit as `nvidia-smi --query-gpu=name,power.limit` gives them
    (`"cpu"` on the CPU);
  * each timed serve's line also gives the step graphs its servers
    captured during it (a chunk length first seen inside a timed serve
    is captured there, as the reference compiles a new jitted shape);
  * `--sharded-bench` serves on an `EngineMesh` of torch devices, the
    first four cards by default; `--mesh-devices` chooses them
    (`cuda:0x4`: four logical shards on one card; `cpux4` on the CPU),
    and the section records the choice; "EP all-to-all in the step HLO"
    becomes the exchange counter of `repro_torch.models.moe_ep`, which
    must be above 0 in every merged decode step; the sharded steps
    replay step graphs as every other serve's (on four logical shards
    of one card one graph a step, on four cards one a card between the
    moves that cross cards), so `ep_ms_per_step` (exchange device time
    from CUDA events) is null with graphs: a replay records no event.

`--compare-padded` re-runs the sweep with padded max_len slots at the
SAME KV memory budget and requires the paged plane to sustain strictly
more concurrent decode requests; `--bench-json` records the comparison
in the bench payload's `real_plane` section.  Exits non-zero if any
request fails to finish within the timeout, or if the paged plane does
not win the comparison.

`--prefix-bench` runs the shared-prefix A/B instead: multi-tenant
repeat-heavy traffic served twice at EQUAL KV memory — prefix caching
off, then on (refcounted page sharing + COW).  Requires the cached run
to post a lower TTFT p99 and > 0 prefill FLOPs saved, and records both
sides in the payload's `real_plane_prefix` section.

`--overload-bench` runs the SLO-overload A/B instead: batch-class KV
hogs fill the ENTIRE paged decode pool, then interactive requests with
a tight e2e deadline arrive mid-decode.  The same trace is served twice
at EQUAL KV memory — drain-only vs page-level preemption.  Requires the
preempting run to post strictly higher goodput (SLO-attained fraction)
with every request still finishing, and records both sides in the
payload's `real_plane_overload` section.

`--mixed-bench` runs the unified mixed-batch A/B instead: long-output
residents decode on a small unified pool while long prompts arrive
mid-decode, served twice — chunked prefill piggybacked into the decode
steps vs the disjoint (prefill-prioritizing, rows stall) ablation.
Requires piggybacking to post a strictly lower ITL p99 at
equal-or-higher throughput, and records both sides in the payload's
`real_plane_mixed` section.

`--sharded-bench` runs the sharded DP+EP A/B instead: the deployment is
mesh-native (4 decode DP units merged into one cache held as one shard
per data rank of a 4-device mesh, every decode step one cross-DP step
with the explicit EP all-to-all in each MoE layer), served under
immediate dispatch vs SBS staggered batch formation.  Requires sbs-la to
post a strictly lower TTFT p99 at equal-or-higher throughput, records
per-step sync stall, the EP exchanges per step and the measured
per-step sync cost that calibrates `CostModel.t_sync`, and writes the
payload's `real_plane_sharded` section.  Use the granite MoE config
(`--arch granite-moe-1b-a400m`) so the expert count divides the mesh.

Exit code: 0 when every request finished and every gate held; 1
otherwise (the failing gate or the unfinished rids are printed).
"""
import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys

import torch

from repro_torch.config import ServingConfig, get_arch
from repro_torch.core.types import Request
from repro_torch.launch.mesh import make_engine_mesh, parse_mesh_devices
from repro_torch.models.model import init_params
from repro_torch.models.moe_ep import count_exchanges
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.metrics import percentile
from repro_torch.serving.real_engine import EngineSpec
from repro_torch.serving.server import RealSBSServer

MAX_LEN = 160


def device_name(device):
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def graphs_captured(srv):
    """Step graphs `srv`'s engines have captured so far (0 when eager)."""
    return sum(e.graphs.stats()["graphs"]
               for e in [*srv.engines, *srv.decode_engines]
               if e.graphs is not None)


def timed_serve(srv, reqs, timeout):
    """`srv.serve(reqs)` and the step graphs captured during it."""
    g0 = graphs_captured(srv)
    gens = srv.serve(reqs, timeout=timeout)
    return gens, graphs_captured(srv) - g0


def make_requests(n, cfg, max_new, seed, spacing):
    rng = random.Random(seed)
    lens = [rng.randrange(20, 90) for _ in range(n)]
    toks = [tuple(rng.randrange(cfg.vocab_size) for _ in range(L))
            for L in lens]
    # fresh Request objects per serve() call (timing stamps are per-run)
    return lambda: [
        Request(rid=i, arrival_time=i * spacing, input_len=lens[i],
                output_len=max_new, tokens=toks[i])
        for i in range(n)]


def sweep_trace(cfg, args):
    """The scheduler sweep's requests and deployment: (fresh, scfg_for),
    `scfg_for(block_size)` the ServingConfig of one cache backend."""
    fresh = make_requests(args.requests, cfg, args.max_new, args.seed,
                          args.arrival_spacing)

    def scfg_for(block_size):
        return ServingConfig(
            num_prefill_instances=2, prefill_dp_per_instance=2,
            num_decode_instances=1, decode_dp_per_instance=2,
            chunk_size=32, t_default=0.05, l_net=0.001,
            max_batch_per_dp=args.max_batch_per_dp, block_size=block_size)
    return fresh, scfg_for


def run_sweep(label, cfg, params, scfg, fresh, args):
    """One scheduler sweep over one cache backend; returns (ok, peaks)."""
    print(f"\n#### backend={label}: "
          f"{scfg.num_prefill_instances}P x {scfg.prefill_dp_per_instance}DP"
          f" -> {scfg.num_decode_instances}D x {scfg.decode_dp_per_instance}"
          f"DP, chunk={scfg.chunk_size}, "
          + (f"paged block_size={scfg.block_size} "
             f"slots/DP={scfg.resolved_decode_slots}" if scfg.block_size
             else f"padded slots/DP={scfg.max_batch_per_dp}"))
    # one shared spec per backend (the kernels build once, each dense
    # chunk length's graph is captured once for the whole sweep; each
    # server captures its engines' decode graphs when it is built)
    spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                      max_batch=scfg.max_batch_per_dp, max_new=args.max_new,
                      block_size=scfg.block_size,
                      decode_slots=(scfg.resolved_decode_slots
                                    if scfg.block_size else 0),
                      device=args.device)
    ok = True
    peaks = {}
    for sched in args.schedulers.split(","):
        reqs = fresh()
        srv = RealSBSServer(cfg, params, serving_cfg=scfg, scheduler=sched,
                            max_len=MAX_LEN, max_new=args.max_new, spec=spec,
                            device=args.device)
        gens, graphs = timed_serve(srv, reqs, args.timeout)
        peak = max((e.peak_resident for e in srv.decode_engines), default=0)
        peaks[sched] = peak
        print(f"\n== scheduler={sched}: {len(gens)}/{len(reqs)} finished; "
              f"adapted I_opt={srv.state.interval.interval*1000:.1f}ms "
              f"T_fwd={srv.state.interval.t_fwd*1000:.1f}ms "
              f"peak_decode_resident={peak} graphs_captured={graphs}")
        for g in gens:
            print(f"  rid={g.rid} ttft={g.ttft*1000:7.1f}ms tokens={g.tokens}")
        if len(gens) < len(reqs):
            missing = sorted(set(r.rid for r in reqs)
                             - set(g.rid for g in gens))
            print(f"  UNFINISHED rids: {missing}")
            ok = False
    return ok, peaks


def prefix_trace(cfg, args):
    """The shared-prefix A/B's deployment and traffic: (scfg, fresh,
    warm, n_tenants), `fresh()` the timed requests and `warm()` the
    warm-up serve's.

    One prefill instance (SBS staggers dispatch windows per instance, so
    a single instance makes every repeat resolve against the binder that
    actually holds its pages); three tenant system prompts recycled
    round-robin so most requests after the first wave are block-aligned
    prefix (or exact full-prompt) hits."""
    bs = args.block_size or 16
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=32, t_default=0.05, l_net=0.001,
        max_batch_per_dp=args.max_batch_per_dp, block_size=bs)
    rng = random.Random(args.seed)
    # one fixed prompt per tenant: every request after the first wave is
    # an exact repeat of its tenant's prompt — a FULL prefix hit, so the
    # cached plane answers it without running a single prefill chunk
    prompts = [tuple(rng.randrange(cfg.vocab_size)
                     for _ in range(96 + 8 + t)) for t in range(3)]
    order = [i % len(prompts) for i in range(args.requests)]
    # the reference's spacing (its CPU prefill took seconds per request):
    # repeats arrive AFTER their tenant's first prompt completes and
    # publishes its pages
    spacing = max(args.arrival_spacing, 1.5)

    def fresh():
        return [Request(rid=i, arrival_time=i * spacing,
                        input_len=len(prompts[t]),
                        output_len=args.max_new, tokens=prompts[t])
                for i, t in enumerate(order)]

    warm_toks = tuple(rng.randrange(cfg.vocab_size) for _ in range(100))

    def warm():
        return [Request(rid=999, arrival_time=0.0, input_len=100,
                        output_len=args.max_new, tokens=warm_toks)]
    return scfg, fresh, warm, len(prompts)


def run_prefix_bench(cfg, params, args):
    """Shared-prefix A/B on the real plane: same tenanted workload, same
    KV memory, prefix caching off vs on.  Returns (ok, report-section)."""
    scfg, fresh, warm, n_tenants = prefix_trace(cfg, args)
    bs = scfg.block_size
    cost = CostModel(cfg)
    spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                      max_batch=args.max_batch_per_dp, max_new=args.max_new,
                      block_size=bs,
                      decode_slots=scfg.resolved_decode_slots,
                      device=args.device)
    print(f"\n#### prefix-cache A/B: {args.requests} requests, 3 tenants "
          f"x 96-token prompts, block_size={bs}")
    ok = True
    section = {"block_size": bs, "requests": args.requests,
               "device": device_name(args.device)}
    for mode in ("uncached", "cached"):
        srv = RealSBSServer(cfg, params, serving_cfg=scfg, scheduler="sbs",
                            max_len=MAX_LEN, max_new=args.max_new, spec=spec,
                            prefix_cache=(mode == "cached"),
                            device=args.device)
        # warm-up outside the timed window (cuBLAS handles, the
        # allocator, the chunk graphs of the warm-up's lengths)
        srv.serve(warm(), timeout=args.timeout)
        pre = srv.prefix_stats()
        gens, graphs = timed_serve(srv, fresh(), args.timeout)
        post = srv.prefix_stats()
        if len(gens) < args.requests:
            print(f"  {mode}: UNFINISHED "
                  f"({len(gens)}/{args.requests})")
            ok = False
        ttfts = [g.ttft for g in gens]
        # the first wave (one request per tenant) is cold in BOTH modes
        # by construction; the caching claim is about the steady state,
        # so the headline p99 is over the repeat-eligible requests
        steady = [g.ttft for g in gens if g.rid >= n_tenants]
        hit = post["prefix_hit_tokens"] - pre["prefix_hit_tokens"]
        seen = post["prefix_seen_tokens"] - pre["prefix_seen_tokens"]
        section[mode] = {
            "ttft_mean": sum(ttfts) / max(len(ttfts), 1),
            "ttft_p99": percentile(steady, 99) if steady else 0.0,
            "ttft_p99_all": percentile(ttfts, 99) if ttfts else 0.0,
            "prefix_hit_rate": hit / seen if seen else 0.0,
            "prefill_flops_saved": cost.prefill_flops(hit),
            "prefill_chunks_run": (post["prefill_chunks_run"]
                                   - pre["prefill_chunks_run"]),
            "decode_blocks_shared": (post["decode_blocks_shared"]
                                     - pre["decode_blocks_shared"]),
        }
        s = section[mode]
        print(f"  {mode:>9}: ttft_p99={s['ttft_p99']*1000:7.1f}ms "
              f"mean={s['ttft_mean']*1000:7.1f}ms "
              f"hit={s['prefix_hit_rate']*100:5.1f}% "
              f"chunks={s['prefill_chunks_run']} "
              f"saved={s['prefill_flops_saved']:.2e} FLOPs "
              f"graphs_captured={graphs}")
    if ok:
        c, u = section["cached"], section["uncached"]
        if not (c["prefill_flops_saved"] > 0
                and c["ttft_p99"] < u["ttft_p99"]):
            print("  prefix-cache gate FAILED: need flops_saved > 0 and "
                  "cached ttft_p99 < uncached ttft_p99")
            ok = False
        else:
            print(f"  gate OK: ttft_p99 "
                  f"{(1 - c['ttft_p99'] / u['ttft_p99']) * 100:+.1f}% "
                  f"vs uncached")
    return ok, section


def overload_trace(cfg, args):
    """The SLO-overload A/B's deployment and traffic: (scfg, fresh, warm,
    hog_out), `warm()` the two warm-up requests (one of each class).

    The decode pool is sized so ONE batch-class hog fills a whole DP
    (max_batch_per_dp=1 → 10 blocks of 16 at max_len 160; a 24-in /
    128-out hog reserves exactly 10 blocks for its lifetime).  Six hogs
    in tight waves keep both DPs saturated for several hog generations;
    two interactive requests (priority 0, tight deadline) arrive while
    the first wave is mid-decode, so their joins defer on device
    capacity."""
    bs = args.block_size or 16
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=32, t_default=0.05, l_net=0.001,
        max_batch_per_dp=1, block_size=bs)
    rng = random.Random(args.seed)
    n_hogs = 6
    hog_in, hog_out = 24, MAX_LEN - 24 - 8     # lifetime 152 ≤ max_len 160
    int_in, int_out = 72, 4
    hog_toks = [tuple(rng.randrange(cfg.vocab_size) for _ in range(hog_in))
                for _ in range(n_hogs)]
    int_toks = [tuple(rng.randrange(cfg.vocab_size) for _ in range(int_in))
                for _ in range(2)]

    def fresh():
        hogs = [Request(rid=i, arrival_time=0.01 * i, input_len=hog_in,
                        output_len=hog_out, tokens=hog_toks[i],
                        priority=2, slo_e2e=float(args.timeout),
                        slo_class="batch")
                for i in range(n_hogs)]
        inter = [Request(rid=10 + i, arrival_time=0.15 + 0.03 * i,
                         input_len=int_in, output_len=int_out,
                         tokens=int_toks[i],
                         priority=0, slo_e2e=args.interactive_slo,
                         slo_class="interactive")
                 for i in range(2)]
        return hogs + inter

    def warm():
        return [Request(rid=998, arrival_time=0.0, input_len=hog_in,
                        output_len=hog_out, tokens=hog_toks[0]),
                Request(rid=999, arrival_time=0.1, input_len=int_in,
                        output_len=int_out, tokens=int_toks[0])]
    return scfg, fresh, warm, hog_out


def run_overload_bench(cfg, params, args):
    """SLO-overload A/B on the real plane: same trace, equal KV memory,
    drain-only vs page-level preemption.  Returns (ok, report-section).

    Drain-only: the interactive requests queue BEHIND the later hog
    waves (joins retry FIFO) and blow the deadline.  Preempting: the
    runtime swaps a hog's pages to host (generation state intact), the
    interactive request joins immediately, and the hogs resume once
    their blocks free up — every request still finishes, but now inside
    its SLO."""
    scfg, fresh, warm, hog_out = overload_trace(cfg, args)
    bs = scfg.block_size
    spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                      max_batch=scfg.max_batch_per_dp, max_new=hog_out,
                      block_size=bs, decode_slots=scfg.resolved_decode_slots,
                      device=args.device)
    # throwaway pass outside the A/B (the reference's compile pass): a
    # mode whose own warm-up measured cold wall times would enter the
    # timed run with an inflated adaptive interval
    RealSBSServer(cfg, params, serving_cfg=scfg, scheduler="sbs-la",
                  max_len=MAX_LEN, max_new=hog_out, spec=spec,
                  device=args.device).serve(warm(), timeout=args.timeout)
    print(f"\n#### SLO-overload A/B: 6 batch hogs "
          f"(24in/{hog_out}out, one fills a DP) + 2 interactive "
          f"(72in/4out, slo={args.interactive_slo:.1f}s), "
          f"block_size={bs}")
    ok = True
    section = {"block_size": bs, "interactive_slo": args.interactive_slo,
               "device": device_name(args.device)}
    for mode in ("drain_only", "preempt"):
        srv = RealSBSServer(cfg, params,
                            serving_cfg=dataclasses.replace(
                                scfg, preemption=(mode == "preempt")),
                            scheduler="sbs-la", max_len=MAX_LEN,
                            max_new=hog_out, spec=spec, device=args.device)
        # warm-up outside the timed window
        srv.serve(warm(), timeout=args.timeout)
        reqs = fresh()
        gens, graphs = timed_serve(srv, reqs, args.timeout)
        if len(gens) < len(reqs):
            missing = sorted(set(r.rid for r in reqs)
                             - set(g.rid for g in gens))
            print(f"  {mode}: UNFINISHED rids {missing}")
            ok = False
        inter = [r for r in reqs if r.slo_class == "interactive"]
        attained = [r for r in reqs if r.slo_attained()]
        section[mode] = {
            "goodput": len(attained) / len(reqs),
            "goodput_interactive": (sum(1 for r in inter
                                        if r.slo_attained())
                                    / max(len(inter), 1)),
            "e2e_interactive": [
                (r.finish_time - r.arrival_time
                 if r.finish_time is not None else None) for r in inter],
            "ttft_interactive": [r.ttft for r in inter],
            "preemptions": len(srv.runtime.preempted),
            "finished": len(gens),
        }
        s = section[mode]
        e2e, ttft = (["--" if v is None else f"{v:5.2f}s"
                      for v in s[key]]
                     for key in ("e2e_interactive", "ttft_interactive"))
        print(f"  {mode:>10}: goodput={s['goodput']*100:5.1f}% "
              f"interactive={s['goodput_interactive']*100:5.1f}% "
              f"e2e_int={e2e} ttft_int={ttft} "
              f"preemptions={s['preemptions']} graphs_captured={graphs}")
    if ok:
        d, p = section["drain_only"], section["preempt"]
        if not (p["goodput"] > d["goodput"] and p["preemptions"] > 0):
            print("  overload gate FAILED: need preempt goodput strictly "
                  "above drain-only and preemptions > 0")
            ok = False
        else:
            print(f"  gate OK: goodput {d['goodput']*100:.1f}% -> "
                  f"{p['goodput']*100:.1f}% "
                  f"({p['preemptions']} preemptions)")
    return ok, section


def mixed_trace(cfg, args):
    """The mixed-batch A/B's deployment and traffic: (scfg, fresh,
    max_new).  Four long-output residents decode on a 2-DP pool while
    eight long prompts arrive mid-decode; `mixed_chunk` is small enough
    that each prompt needs several chunk-steps."""
    bs = args.block_size or 16
    rng = random.Random(args.seed)
    res_in, res_out = 32, 120        # lifetime 152 ≤ max_len 160
    burst_in, burst_out = 96, 4      # lifetime 100; 96 = 3 chunks of 32
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=32, t_default=0.05, l_net=0.001,
        max_batch_per_dp=8, block_size=bs,
        mixed_batch=True, mixed_chunk=32)
    res_toks = [tuple(rng.randrange(cfg.vocab_size) for _ in range(res_in))
                for _ in range(4)]
    burst_toks = [tuple(rng.randrange(cfg.vocab_size)
                        for _ in range(burst_in)) for _ in range(8)]

    def fresh():
        res = [Request(rid=i, arrival_time=0.02 * i, input_len=res_in,
                       output_len=res_out, tokens=res_toks[i])
               for i in range(4)]
        burst = [Request(rid=10 + i, arrival_time=0.5 + 0.15 * i,
                         input_len=burst_in, output_len=burst_out,
                         tokens=burst_toks[i])
                 for i in range(8)]
        return res + burst
    return scfg, fresh, max(res_out, burst_out)


def run_mixed_bench(cfg, params, args):
    """Unified mixed-batch A/B on the real plane: the same trace served
    twice by the SAME unified (decode-pool-only) deployment — chunked
    prefill piggybacked into the decode steps vs the disjoint ablation
    (prefill-prioritizing: a step with pending prefill runs only the
    chunk and the resident decode rows stall).  Returns
    (ok, report-section).

    Gate: piggybacking must post a strictly lower ITL p99 at
    equal-or-higher throughput (tokens / completion wall time), "equal"
    with a 5% tolerance over the median of three timed serves."""
    scfg, fresh, max_new = mixed_trace(cfg, args)
    bs = scfg.block_size
    print(f"\n#### mixed-batch A/B: 4 residents (32in/120out) "
          f"+ 8 prompts (96in/4out) on a 2-DP unified "
          f"pool, mixed_chunk={scfg.mixed_chunk}, block_size={bs}")
    ok = True
    section = {"block_size": bs, "mixed_chunk": scfg.mixed_chunk,
               "device": device_name(args.device)}
    spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                      max_batch=scfg.max_batch_per_dp, max_new=max_new,
                      block_size=bs, decode_slots=scfg.resolved_decode_slots,
                      device=args.device)
    for mode, piggy in (("piggyback", True), ("disjoint", False)):
        srv = RealSBSServer(cfg, params,
                            serving_cfg=dataclasses.replace(
                                scfg, mixed_piggyback=piggy),
                            scheduler="sbs-la", max_len=MAX_LEN,
                            max_new=max_new, spec=spec, device=args.device)
        # warm-up serve of the SAME trace: the chunk graphs this leg
        # will hit are captured outside the timed runs
        srv.serve(fresh(), timeout=args.timeout)
        # median of three timed serves: single wall-clock runs on a
        # shared host swing tens of percent on transient load
        samples = []
        for _ in range(3):
            for e in srv.decode_engines:
                e.itl.clear()
            reqs = fresh()
            gens, graphs = timed_serve(srv, reqs, args.timeout)
            if len(gens) < len(reqs):
                missing = sorted(set(r.rid for r in reqs)
                                 - set(g.rid for g in gens))
                print(f"  {mode}: UNFINISHED rids {missing}")
                ok = False
                break
            itls = [s for e in srv.decode_engines for s in e.itl]
            toks = sum(r.generated for r in reqs)
            span = max((r.finish_time for r in reqs
                        if r.finish_time is not None), default=0.0)
            print(f"  {mode:>9} serve {len(samples) + 1}: "
                  f"graphs_captured={graphs}")
            samples.append({
                "itl_p50": percentile(itls, 50) if itls else 0.0,
                "itl_p99": percentile(itls, 99) if itls else 0.0,
                "throughput": toks / span if span > 0 else 0.0,
            })
        if not samples:
            continue
        med = {k: sorted(s[k] for s in samples)[len(samples) // 2]
               for k in samples[0]}
        section[mode] = med
        section[mode].update({
            "runs": len(samples),
            "mixed_steps": sum(e.mixed_steps for e in srv.decode_engines),
            "forced_grants": sum(e.forced_grants
                                 for e in srv.decode_engines),
            "prefill_tokens": sum(e.prefill_tokens
                                  for e in srv.decode_engines),
        })
        s = section[mode]
        print(f"  {mode:>9}: itl_p99={s['itl_p99']*1000:7.1f}ms "
              f"p50={s['itl_p50']*1000:6.1f}ms thr={s['throughput']:6.1f} "
              f"tok/s mixed_steps={s['mixed_steps']} "
              f"prefill_tok={s['prefill_tokens']}")
    if ok:
        p, d = section["piggyback"], section["disjoint"]
        if not (p["itl_p99"] < d["itl_p99"]
                and p["throughput"] >= 0.95 * d["throughput"]):
            print("  mixed gate FAILED: need piggyback itl_p99 strictly "
                  "below disjoint at equal-or-higher throughput "
                  "(5% tolerance)")
            ok = False
        else:
            print(f"  gate OK: itl_p99 "
                  f"{(1 - p['itl_p99'] / d['itl_p99']) * 100:+.1f}% "
                  f"thr {(p['throughput'] / d['throughput'] - 1) * 100:+.1f}%"
                  f" vs disjoint")
    return ok, section


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _measure_step_sync(spec_sh, spec_lo, reps=20):
    """Per-step DP sync cost, measured: wall time of the merged sharded
    decode step (the EP all-to-all over every DP's rows) minus the
    equivalent single-device per-DP step, both compiled as the serves
    run them (each spec's decode step replays its CUDA graph, as the
    reference's probe times the jitted steps; eager where a spec has
    `step_graphs=False`).  The minimum over `reps` filters scheduler
    noise.  Also returns the merged step's EP exchanges, which must be
    above 0."""
    import time

    def best(spec, cache):
        if "shards" in cache:
            toks = [torch.zeros((c["cur"].shape[0], 1), dtype=torch.int32,
                                device=c["cur"].device)
                    for c in cache["shards"]]
        else:
            toks = torch.zeros((cache["cur"].shape[0], 1),
                               dtype=torch.int32, device=spec.device)
        graphs = spec.step_graphs_for()

        def step(c):
            if graphs is None:
                return spec.decode_fn(c, toks)
            return graphs.run(("decode", "probe"), spec.decode_fn, c,
                              token=toks)
        with count_exchanges() as ep:
            _lg, cache = step(cache)                # warm-up (capture)
        _sync(spec.device)
        t = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _lg, cache = step(cache)
            _sync(spec.device)
            t = min(t, time.perf_counter() - t0)
        return t, ep.exchanges

    t_sh, ex = best(spec_sh, spec_sh.merged_paged_cache())
    t_lo, _ = best(spec_lo, spec_lo.paged_cache())
    return max(t_sh - t_lo, 0.0), t_sh, t_lo, ex


def sharded_trace(cfg, args):
    """The sharded A/B's deployment and requests: (scfg, fresh, out) — a
    burst of 16 alternating 144- and 16-token prompts, 16 new tokens, 2
    prefill instances × 1 DP, 1 decode instance × 4 DP."""
    n_dp = 4
    bs = args.block_size or 16
    long_in, short_in, out = 144, 16, 16     # lifetime 160 == max_len
    scfg = ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=n_dp,
        chunk_size=64, t_default=0.02, l_net=0.001,
        max_batch_per_dp=2, block_size=bs,
        # the burst IS the experiment: keep PBAA's overload detection
        # from shedding it
        n_limit=1000)
    rng = random.Random(args.seed)
    lens = [long_in if i % 2 == 0 else short_in for i in range(16)]
    toks = [tuple(rng.randrange(cfg.vocab_size) for _ in range(L))
            for L in lens]
    spacing = min(args.arrival_spacing, 0.005)

    def fresh():
        return [Request(rid=i, arrival_time=i * spacing,
                        input_len=lens[i], output_len=out, tokens=toks[i])
                for i in range(len(lens))]
    return scfg, fresh, out


def run_sharded_bench(cfg, params, args):
    """Sharded DP+EP A/B on the real plane: the SAME trace served by a
    mesh-native deployment (4 decode DP units merged into ONE cache held
    as one shard per data rank of a 4-device mesh, every decode step a
    cross-DP step with the explicit EP all-to-all) under immediate
    dispatch vs SBS staggered batch formation.  Returns
    (ok, report-section).

    Gate: sbs-la must post a strictly lower TTFT p99 at equal-or-higher
    throughput (5% tolerance; latencies are medians of five timed
    serves, throughput the best serve).  The section also records the
    per-step sync-stall integral Σ dur·(1 − active/rows) from the
    engines' step samples, the EP exchanges per decode step (every
    merged decode step must carry some), and the measured per-step sync
    cost that calibrates `CostModel.t_sync`."""
    n_dp = 4
    devices = (parse_mesh_devices(args.mesh_devices)
               if args.mesh_devices else None)
    mesh = make_engine_mesh(n_dp, devices=devices)
    scfg, fresh, out = sharded_trace(cfg, args)
    bs = scfg.block_size
    spec = EngineSpec(cfg, params, max_len=MAX_LEN,
                      max_batch=scfg.max_batch_per_dp, max_new=out,
                      block_size=bs, decode_slots=scfg.resolved_decode_slots,
                      mesh=mesh)
    spec_lo = EngineSpec(cfg, params, max_len=MAX_LEN,
                         max_batch=scfg.max_batch_per_dp, max_new=out,
                         block_size=bs,
                         decode_slots=scfg.resolved_decode_slots,
                         device=mesh.lead)
    t_sync, t_sh, t_lo, probe_ex = _measure_step_sync(spec, spec_lo)
    ep_active = probe_ex > 0
    cost = CostModel(cfg).with_measured_sync(t_sync)
    print(f"\n#### sharded DP+EP A/B: 16 requests (144/16 alternating, "
          f"{out} out) on a {n_dp}-shard data mesh "
          f"{[str(d) for d in mesh.devices]}, merged decode cache "
          f"{n_dp}x{spec.paged_slots} rows, block_size={bs}, EP exchanges "
          f"in the merged step: {probe_ex}")
    print(f"  measured per-step sync: sharded={t_sh*1000:.2f}ms "
          f"local={t_lo*1000:.2f}ms -> t_sync={t_sync*1000:.2f}ms "
          f"(CostModel default {CostModel(cfg).t_sync*1000:.1f}ms)")
    ok = ep_active
    section = {
        "block_size": bs, "n_dp": n_dp, "requests": 16,
        "ep_all_to_all_active": ep_active,
        "t_sync_measured_ms": t_sync * 1000,
        "t_step_sharded_ms": t_sh * 1000,
        "t_step_local_ms": t_lo * 1000,
        "t_sync_calibrated_costmodel_ms": cost.t_sync * 1000,
        "device": device_name(mesh.lead),
        "mesh_devices": [str(d) for d in mesh.devices],
    }
    for sched in ("immediate", "sbs-la"):
        srv = RealSBSServer(cfg, params, serving_cfg=scfg, scheduler=sched,
                            max_len=MAX_LEN, max_new=out, spec=spec,
                            mesh=mesh)
        # warm-up serve of the same trace (cuBLAS handles, the allocator,
        # the adaptive interval)
        srv.serve(fresh(), timeout=args.timeout)
        samples = []
        g0 = graphs_captured(srv)
        for _ in range(5):
            for e in srv.decode_engines:
                e.step_samples.clear()
                e.ep_samples.clear()
                e.tp_samples.clear()
            reqs = fresh()
            gens = srv.serve(reqs, timeout=args.timeout)
            if len(gens) < len(reqs):
                missing = sorted(set(r.rid for r in reqs)
                                 - set(g.rid for g in gens))
                print(f"  {sched}: UNFINISHED rids {missing}")
                ok = False
                break
            steps = [(s, x) for e in srv.decode_engines
                     for s, x in zip(e.step_samples, e.ep_samples)]
            if any(x[0] <= 0 for _s, x in steps):
                print(f"  {sched}: a merged decode step made no EP "
                      f"exchange")
                ok = False
            ttfts = [g.ttft for g in gens]
            total = sum(r.generated for r in reqs)
            span = max((r.finish_time for r in reqs
                        if r.finish_time is not None), default=0.0)
            stall = sum(d * (1 - a / r) for (d, a, r), _x in steps if r)
            occ = (sum(a / r for (_d, a, r), _x in steps if r)
                   / max(len(steps), 1))
            n = max(len(steps), 1)
            ep_s = [x[2] for _s, x in steps if x[2] is not None]
            samples.append({
                "ttft_p99": percentile(ttfts, 99) if ttfts else 0.0,
                "ttft_mean": sum(ttfts) / max(len(ttfts), 1),
                "throughput": total / span if span > 0 else 0.0,
                "sync_stall_ms": stall * 1000,
                "decode_steps": len(steps),
                "mean_occupancy": occ,
                "step_p50_ms": percentile([d for (d, _a, _r), _x in steps],
                                   50) * 1000 if steps else 0.0,
                "ep_exchanges_per_step": sum(x[0] for _s, x in steps) / n,
                "ep_bytes_per_step": sum(x[1] for _s, x in steps) / n,
                "ep_ms_per_step": (sum(ep_s) / n * 1000 if ep_s
                                   else None),
            })
        if not samples:
            continue
        med = {k: (sorted(s[k] for s in samples)[len(samples) // 2]
                   if samples[0][k] is not None else None)
               for k in samples[0]}
        # throughput = tokens / burst makespan, a MAX over requests that
        # host jitter only inflates: the best serve is the stable
        # estimator (latencies stay medians), as in the reference
        med["throughput"] = max(s["throughput"] for s in samples)
        med["runs"] = len(samples)
        section[sched] = med
        ep_ms = ("n/a" if med["ep_ms_per_step"] is None
                 else f"{med['ep_ms_per_step']:.2f}ms")
        print(f"  {sched:>9}: ttft_p99={med['ttft_p99']*1000:7.1f}ms "
              f"mean={med['ttft_mean']*1000:7.1f}ms "
              f"thr={med['throughput']:6.1f} tok/s "
              f"stall={med['sync_stall_ms']:7.1f}ms "
              f"steps={med['decode_steps']} "
              f"occ={med['mean_occupancy']*100:5.1f}% "
              f"ep={med['ep_exchanges_per_step']:.0f}/step "
              f"({med['ep_bytes_per_step'] / 1e6:.2f} MB, {ep_ms}) "
              f"graphs_captured={graphs_captured(srv) - g0}")
    if ok and "immediate" in section and "sbs-la" in section:
        i, s = section["immediate"], section["sbs-la"]
        if not (s["ttft_p99"] < i["ttft_p99"]
                and s["throughput"] >= 0.95 * i["throughput"]):
            print("  sharded gate FAILED: need sbs-la ttft_p99 strictly "
                  "below immediate at equal-or-higher throughput "
                  "(5% tolerance)")
            ok = False
        else:
            dstall = ((1 - s["sync_stall_ms"] / i["sync_stall_ms"]) * 100
                      if i["sync_stall_ms"] else 0.0)
            print(f"  gate OK: ttft_p99 "
                  f"{(1 - s['ttft_p99'] / i['ttft_p99']) * 100:+.1f}% "
                  f"thr {(s['throughput'] / i['throughput'] - 1) * 100:+.1f}%"
                  f" stall {dstall:+.1f}% vs immediate")
    elif ok:
        ok = False
    return ok, section


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--schedulers", default="immediate,sbs,sbs-la")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-KV block size; 0 = padded max_len slots")
    ap.add_argument("--max-batch-per-dp", type=int, default=8,
                    help="decode KV memory budget per DP, in max_len slots")
    ap.add_argument("--arrival-spacing", type=float, default=0.05)
    ap.add_argument("--compare-padded", action="store_true",
                    help="also run padded slots at equal memory and demand "
                         "strictly higher paged decode concurrency")
    ap.add_argument("--bench-json", default=None,
                    help="record the real-plane comparison into this "
                         "benchmark payload (e.g. BENCH_torch.json)")
    ap.add_argument("--prefix-bench", action="store_true",
                    help="run the shared-prefix caching A/B (equal KV "
                         "memory, caching off vs on) instead of the "
                         "scheduler sweep")
    ap.add_argument("--overload-bench", action="store_true",
                    help="run the SLO-overload A/B (equal KV memory, "
                         "drain-only vs page-level preemption) instead "
                         "of the scheduler sweep")
    ap.add_argument("--interactive-slo", type=float, default=0.6,
                    help="e2e deadline (s) for the interactive class in "
                         "--overload-bench")
    ap.add_argument("--mixed-bench", action="store_true",
                    help="run the unified mixed-batch A/B (piggybacked "
                         "chunked prefill vs the disjoint stall-the-rows "
                         "ablation) instead of the scheduler sweep")
    ap.add_argument("--sharded-bench", action="store_true",
                    help="run the sharded DP+EP A/B (4 decode DP units "
                         "merged on a 4-device mesh, EP all-to-all; "
                         "immediate vs sbs-la) instead of the scheduler "
                         "sweep")
    ap.add_argument("--mesh-devices", default=None,
                    help="the sharded A/B's mesh devices, comma-separated, "
                         "each optionally repeated with xN (cuda:0x4: four "
                         "logical shards on one card; cpux4); default: the "
                         "first 4 cards")
    ap.add_argument("--device", default="cuda",
                    help="where weights and caches live (cuda or cpu); "
                         "cuda with no GPU raises")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's reduced config in fp32 "
                         "instead of the published width in bf16")
    args = ap.parse_args(argv)
    if args.compare_padded and not args.block_size:
        ap.error("--compare-padded needs a paged plane (--block-size > 0); "
                 "with --block-size 0 the concurrency gate would silently "
                 "not run")
    return args


def load_model(args):
    """(cfg, params): the published width in bf16, or with `--reduced`
    the reference's reduced config in fp32, random weights from
    `--seed` on `--device`."""
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = get_arch(args.arch, reduced=args.reduced)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    return cfg, init_params(cfg, seed=args.seed, dtype=dtype,
                            device=args.device)


def write_section(path, key, section):
    payload = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            payload = {}        # corrupt/truncated: rebuild our section
    payload[key] = section
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"\nupdated {os.path.abspath(path)} [{key}]")


def main(argv=None):
    args = parse_args(argv)
    cfg, params = load_model(args)

    if (args.prefix_bench or args.overload_bench or args.mixed_bench
            or args.sharded_bench):
        if args.prefix_bench:
            key, (ok, section) = ("real_plane_prefix",
                                  run_prefix_bench(cfg, params, args))
        elif args.overload_bench:
            key, (ok, section) = ("real_plane_overload",
                                  run_overload_bench(cfg, params, args))
        elif args.sharded_bench:
            key, (ok, section) = ("real_plane_sharded",
                                  run_sharded_bench(cfg, params, args))
        else:
            key, (ok, section) = ("real_plane_mixed",
                                  run_mixed_bench(cfg, params, args))
        if args.bench_json:
            write_section(args.bench_json, key, section)
        sys.exit(0 if ok else 1)

    fresh, scfg_for = sweep_trace(cfg, args)
    print(f"serving {args.requests} requests on {cfg.name} "
          f"({'reduced' if args.reduced else 'published width'}, "
          f"{str(params['embed'].dtype).replace('torch.', '')}, "
          f"{device_name(args.device)})")

    label = "paged" if args.block_size else "padded"
    ok, peaks = run_sweep(label, cfg, params, scfg_for(args.block_size),
                          fresh, args)
    report = {"block_size": args.block_size,
              "max_batch_per_dp": args.max_batch_per_dp,
              "peak_decode_resident": {label: peaks},
              "device": device_name(args.device)}

    if args.compare_padded and args.block_size:
        ok2, padded_peaks = run_sweep("padded", cfg, params, scfg_for(0),
                                      fresh, args)
        ok = ok and ok2
        report["peak_decode_resident"]["padded"] = padded_peaks
        print("\n#### paged vs padded peak concurrent decode requests "
              "(equal KV memory)")
        for sched in peaks:
            p, q = peaks[sched], padded_peaks[sched]
            verdict = "OK" if p > q else "NOT STRICTLY HIGHER"
            print(f"  {sched:>10}: paged={p} padded={q}  {verdict}")
            if p <= q:
                ok = False

    if args.bench_json:
        write_section(args.bench_json, "real_plane", report)

    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
