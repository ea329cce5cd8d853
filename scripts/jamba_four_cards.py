#!/usr/bin/env python3
"""Full-depth jamba-v0.1-52b on the sharded P/D plane over four cards.

    python3 scripts/jamba_four_cards.py            # needs 4 cards
    python3 scripts/jamba_four_cards.py --reduced --devices cpu,cpu,cpu,cpu

jamba-v0.1-52b at its published width and all 32 layers (51.46 B
parameters, 102.9 GB in bf16: more than one 80 GB card holds) behind
`RealSBSServer(mesh=make_engine_mesh(4, devices=cuda:0..3))`: 2 prefill
instances × 1 DP with dense 64-token chunks on cuda:0, 1 decode instance
× 4 DP merged into one cache held as one shard a card, its 16 experts
split four a card (EP), every step a CUDA graph replay (one graph a card
between the moves that cross cards).  The traffic is the serving
benchmark twin's sharded trace (`examples/serve_e2e_torch.py`
`sharded_trace`: 16 prompts of 144 and 16 tokens alternating, 16 new
tokens, 5 ms apart), served under `immediate` and then `sbs-la`, each
server first serving it once (captures, allocator) and then three times
measured.

The weights are random, drawn from seed 0 in `init_params`' order on
the lead card one tensor at a time (the same values `init_params(cfg,
seed, device="cuda")` would give); each layer's expert stacks go to the
host in bf16 as soon as they are made, so the whole model never sits on
one card, and `EngineSpec(mesh=)` places them (`place_params`: each
card receives its four experts' slices from the host, and a replica of
every other weight).

Checks, each fatal (exit code 1): every request finishes with its
tokens; the decode slots and block pools drain; every merged decode
step that decoded rows made 2 EP exchanges in each of the 16 MoE layers
(32); every merged decode step of a measured serve replayed a graph and
every dense chunk did; no weight or cache is on the CPU.  Printed: the
init and placement seconds, the merged decode step p50 and p99, TTFT
and ITL p50 / p99 (medians over the measured serves), the captures and
their seconds, and each card's allocated and peak memory, with the
card's name and power limit; the last line is one JSON object with all
of it.  `--reduced` serves the reduced config in fp32 (a rehearsal; on
`--devices cpu,...` nothing is captured).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.config.base import get_arch  # noqa: E402
from repro_torch.launch.mesh import make_engine_mesh  # noqa: E402
from repro_torch.models.blocks import init_block_params  # noqa: E402
from repro_torch.serving.metrics import percentile  # noqa: E402
from repro_torch.serving.real_engine import EngineSpec  # noqa: E402
from repro_torch.serving.server import RealSBSServer  # noqa: E402

N_CARDS = 4
MEASURED = 3
SEED = 0
TIMEOUT_S = 300.0                  # a serve's limit, s
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def load_twin():
    """The serving benchmark twin, loaded by path (for its trace)."""
    path = os.path.join(ROOT, "examples", "serve_e2e_torch.py")
    spec = importlib.util.spec_from_file_location("serve_e2e_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_params(cfg, seed, dtype, lead, park):
    """`init_params(cfg, seed, dtype, device=lead)`'s tree, drawn in its
    order on `lead`, with every MoE expert stack moved to `park` (the
    host) as soon as its layer is made."""
    gen = torch.Generator(device=lead)
    gen.manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=lead)
        return (w * scale).to(dtype)
    params = {"embed": normal((V, D), 0.02),
              "ln_f": torch.ones(D, dtype=dtype, device=lead)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D))
    params["layers"] = []
    for kind in cfg.layer_kinds():
        p = init_block_params(gen, cfg, kind, dtype)
        if "moe" in p:
            for name in EXPERT_WEIGHTS:
                p["moe"][name] = p["moe"][name].to(park)
        params["layers"].append(p)
        if lead.type == "cuda":
            torch.cuda.empty_cache()
    return params


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def memory(devices):
    """Allocated and peak bytes of each distinct card."""
    return {str(d): {"allocated": torch.cuda.memory_allocated(d),
                     "peak": torch.cuda.max_memory_allocated(d)}
            for d in devices if d.type == "cuda"}


def check_placement(spec):
    """Every weight, expert slice and cache shard on its mesh device,
    none on the CPU unless the mesh is the CPU's."""
    from repro_torch.distributed.sharding import param_leaves
    want = {d.type for d in spec.mesh.devices}
    bad = [t.device for t in param_leaves(spec.params)
           if t.device.type not in want]
    if bad:
        raise AssertionError(f"{len(bad)} weights off the mesh: {bad[:3]}")


def serve_scheduler(cfg, spec, mesh, scfg, fresh, out, sched, timeout):
    """One scheduler's server on the shared spec: a warm-up serve, then
    MEASURED serves, each checked.  Returns the medians and counts."""
    n_moe = sum("moe" in p for p in spec.params["layers"])
    t0 = time.monotonic()
    srv = RealSBSServer(cfg, spec.params, serving_cfg=scfg, scheduler=sched,
                        max_len=spec.max_len, max_new=out, spec=spec,
                        mesh=mesh)
    build_s = time.monotonic() - t0
    eng = srv.decode_engines[0]
    chunks = {"n": 0, "replayed": 0}
    inner = spec.dense_prefill

    def dense_prefill(graphs, tokens, cache, row, at, work=None):
        before = graphs.replays
        logits = inner(graphs, tokens, cache, row, at, work)
        chunks["n"] += 1
        chunks["replayed"] += int(graphs.replays == before + 1)
        return logits
    spec.dense_prefill = dense_prefill
    runs = []
    try:
        for i in range(1 + MEASURED):
            m = (len(eng.step_samples), len(eng.itl), eng.graphs.replays,
                 chunks["n"], chunks["replayed"],
                 sum(e.graphs.captured for e in [*srv.engines, eng]),
                 sum(e.graphs.capture_s for e in [*srv.engines, eng]))
            reqs = fresh()
            t0 = time.monotonic()
            gens = srv.serve(reqs, timeout=timeout)
            wall = time.monotonic() - t0
            tag = f"[{sched} serve {i}{' warm-up' if i == 0 else ''}]"
            done = {g.rid: g for g in gens}
            if sorted(done) != [r.rid for r in reqs]:
                missing = sorted(set(r.rid for r in reqs) - set(done))
                raise AssertionError(f"{tag}: unfinished requests {missing}")
            for r in reqs:
                if len(done[r.rid].tokens) != spec.target_len(r):
                    raise AssertionError(f"{tag}: request {r.rid} has "
                                         f"{len(done[r.rid].tokens)} tokens")
            for st in eng._dp.values():
                st.pool.check()
                if st.pool.used_count or st.occupied():
                    raise AssertionError(f"{tag}: the decode pools did not "
                                         f"drain")
            samples = eng.step_samples[m[0]:]
            ep = eng.ep_samples[m[0]:]
            decode = [(d, x) for (d, a, _r), x in zip(samples, ep) if a]
            for _d, (ex, _b, _s) in decode:
                if ex != 2 * n_moe:
                    raise AssertionError(f"{tag}: a merged decode step made "
                                         f"{ex} EP exchanges, not "
                                         f"{2 * n_moe}")
            replays = eng.graphs.replays - m[2]
            n_chunks = chunks["n"] - m[3]
            replayed = chunks["replayed"] - m[4]
            captured = sum(e.graphs.captured
                           for e in [*srv.engines, eng]) - m[5]
            cap_s = sum(e.graphs.capture_s
                        for e in [*srv.engines, eng]) - m[6]
            if spec.device.type == "cuda" and (replays != len(decode)
                                               or replayed != n_chunks):
                raise AssertionError(
                    f"{tag}: {len(decode) - replays} decode steps and "
                    f"{n_chunks - replayed} dense chunks ran eagerly")
            ttft = [g.ttft for g in gens]
            itl = eng.itl[m[1]:]
            run = {"wall_s": wall,
                   "decode_steps": len(decode),
                   "merged_step_p50_s": percentile(
                       [d for d, _x in decode], 50),
                   "merged_step_p99_s": percentile(
                       [d for d, _x in decode], 99),
                   "ttft_p50_s": percentile(ttft, 50),
                   "ttft_p99_s": percentile(ttft, 99),
                   "itl_p50_s": percentile(itl, 50),
                   "itl_p99_s": percentile(itl, 99),
                   "ep_exchanges_per_decode_step":
                       sum(x[0] for _d, x in decode) / max(len(decode), 1),
                   "ep_bytes_per_decode_step":
                       sum(x[1] for _d, x in decode) / max(len(decode), 1),
                   "dense_chunks": n_chunks, "dense_chunks_replayed":
                       replayed, "decode_replays": replays,
                   "captures": captured, "capture_s": cap_s}
            print(f"{tag} " + " ".join(f"{k}={v!r}" for k, v in run.items()),
                  flush=True)
            if i:
                runs.append(run)
    finally:
        del spec.dense_prefill
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    med["server_build_s"] = build_s
    med["merged_graph_segments"] = len(
        eng.graphs._entries[("decode", "merged")].segments) \
        if eng.graphs.cuda else None
    return med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="the mesh's 4 devices, comma-separated (default "
                         "cuda:0..3)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config in fp32 (a rehearsal)")
    args = ap.parse_args(argv)
    devices = (args.devices.split(",") if args.devices
               else [f"cuda:{i}" for i in range(N_CARDS)])
    if any(d.startswith("cuda") for d in devices) and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < N_CARDS):
        print(f"jamba_four_cards: needs {N_CARDS} NVIDIA GPUs",
              file=sys.stderr)
        return 2
    try:
        mesh = make_engine_mesh(N_CARDS, devices=devices)
        cfg = get_arch("jamba-v0.1-52b", reduced=args.reduced)
        dtype = torch.float32 if args.reduced else torch.bfloat16
        total = cfg.param_counts()["total"]
        print(f"[config] {cfg.name}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
              f"{cfg.moe.top_k}; {total} parameters; mesh "
              f"{[str(d) for d in mesh.devices]}", flush=True)
        lead = mesh.lead
        if lead.type == "cuda":
            from repro_torch.kernels.build import load_kernels
            t0 = time.monotonic()
            load_kernels()
            print(f"[build] kernels in {time.monotonic() - t0:.1f} s",
                  flush=True)
        t0 = time.monotonic()
        params = make_params(cfg, SEED, dtype, lead,
                             torch.device("cpu"))
        if lead.type == "cuda":
            torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        print(f"[init] weights drawn on {lead}, expert stacks parked on the "
              f"host in {dtype}: {init_s:.1f} s", flush=True)
        twin = load_twin()
        scfg, fresh, out = twin.sharded_trace(cfg, argparse.Namespace(
            block_size=16, seed=SEED, arrival_spacing=0.005))
        t0 = time.monotonic()
        spec = EngineSpec(cfg, params, max_len=twin.MAX_LEN,
                          max_batch=scfg.max_batch_per_dp, max_new=out,
                          block_size=scfg.block_size,
                          decode_slots=scfg.resolved_decode_slots,
                          mesh=mesh)
        del params
        if lead.type == "cuda":
            for d in mesh.distinct:
                torch.cuda.synchronize(d)
        place_s = time.monotonic() - t0
        check_placement(spec)
        print(f"[place] place_params over {len(mesh.distinct)} devices: "
              f"{place_s:.1f} s; memory {memory(mesh.distinct)!r}",
              flush=True)
        if not spec.step_graphs:
            raise AssertionError("the spec runs eagerly")
        report = {"model": cfg.name, "layers": cfg.num_layers,
                  "parameters": total, "dtype": str(dtype),
                  "mesh": [str(d) for d in mesh.devices],
                  "init_s": init_s, "place_s": place_s,
                  "weights": "drawn on the lead card one tensor at a time "
                             "in init_params' order; expert stacks parked "
                             "on the host, placed by place_params"}
        for sched in ("immediate", "sbs-la"):
            report[sched] = serve_scheduler(cfg, spec, mesh, scfg, fresh,
                                            out, sched, TIMEOUT_S)
            r = report[sched]
            print(f"[{sched}] medians of {MEASURED}: merged decode step "
                  f"p50 {r['merged_step_p50_s']!r} s p99 "
                  f"{r['merged_step_p99_s']!r} s; TTFT p50 "
                  f"{r['ttft_p50_s']!r} p99 {r['ttft_p99_s']!r} s; ITL "
                  f"p50 {r['itl_p50_s']!r} p99 {r['itl_p99_s']!r} s; "
                  f"exchanges a step {r['ep_exchanges_per_decode_step']!r}",
                  flush=True)
        report["memory"] = memory(mesh.distinct)
        print(f"[memory] per card (allocated, peak): "
              f"{report['memory']!r}", flush=True)
        if lead.type == "cuda":
            report["card"] = card_name()
            print(report["card"], flush=True)
        print(json.dumps(report), flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
