#!/usr/bin/env python3
"""Tensor parallelism inside a DP over four cards, beside the same mesh
on four logical shards of one card.

    python3 scripts/tp_four_cards.py            # needs 4 cards
    python3 scripts/tp_four_cards.py --reduced --devices cpu,cpu,cpu,cpu

chip_smoke.py's phase 6k on two (data, model) = (2, 2) meshes in one
process, in turn: four logical shards of the first device, then one
shard a device (cuda:0..3 by default: DP 0's ranks on cuda:0 and
cuda:1, DP 1's on cuda:2 and cuda:3).  On each:

  * full-width granite-moe-1b-a400m (24 layers, bf16 from seed 0) behind
    `RealSBSServer(mesh=...)`, P/D as chip_smoke's sharded P/D serve
    with 2 decode DP units of 2 TP ranks, step graphs (on four cards one
    graph a card between the moves that cross cards: each TP collective
    and EP exchange a cut), 8 requests, with `serve_sharded`'s checks:
    every request finishes, the merged cache drains, every merged decode
    step makes 48 EP exchanges and the TP collectives
    `expected_tp_calls` says, every step replays a graph, #1 and #2's
    contiguous entry launch and nothing else, first-token logits within
    5e-2 of a plain forward over the served expert sets;
  * full-width deepseek-7b at 8 of 30 layers: the TP merged decode step
    against the unsharded paged step on the same 8 prefilled rows
    (`tp_step_check`: logits within 5e-2, collectives as predicted, the
    `[tp weights]` check: each card holds its ranks' pieces of what
    `tp_axis` splits and no whole replica), both steps' p50 as step
    graphs, and `torch.cuda.memory_allocated` of each card after the
    placement (cuda:0 also holds the whole weights and the unsharded
    cache the check compares with).

Any failed check exits with code 1.  Printed: each layout's merged
decode step p50/p99, TTFT and ITL, TP collectives and bytes per step,
the step check's p50s, with the card's name and power limit; the last
line is one JSON object with all of it (also written to
chiprun_out/tp_four_cards.json).  `--reduced` cuts granite to 2 layers
and checks reduced deepseek-7b (a rehearsal: nothing is captured on the
CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def load_smoke():
    """chip_smoke.py, loaded by path (it is not a package module)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_layout(cs, name, devices, reduced, counters):
    """The TP P/D serve and the step check on a (2, 2) mesh over
    `devices`.  Returns the layout's report."""
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.model import init_params
    lead = devices[0]
    mesh = make_engine_mesh(cs.TP_DATA, cs.TP_MODEL, devices=devices)
    cfg = get_arch("granite-moe-1b-a400m")
    if reduced:
        cfg = dataclasses.replace(cfg, num_layers=2)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=lead)
    kw = (dict(n_requests=4, lens=(64, 200), outs=(3, 5)) if reduced
          else {})
    tag = f"[tp pd serve {name}]"
    pd = cs.serve_sharded(cfg, params, lead, counters, False, mesh=mesh,
                          tag=tag, **kw)
    cs.report_sharded(tag, pd)
    print(f"{tag} TP per merged decode step: collectives "
          f"{pd['tp_calls_per_decode_step']!r} (expected "
          f"{pd['tp_calls_expected']!r}), bytes "
          f"{pd['tp_bytes_per_decode_step']!r}", flush=True)
    del params
    if lead != "cpu":
        cs.free_device_memory()
    step_cfg = step_params = None
    if reduced:
        step_cfg = get_arch("deepseek-7b", reduced=True)
        step_params = init_params(step_cfg, seed=0, dtype=torch.float32,
                                  device=lead)
    step = cs.tp_step_check(lead, step_cfg, step_params, mesh=mesh)
    if lead != "cpu":
        cs.free_device_memory()
    keys = ("decode_step_p50_s", "step_p99_s", "ttft_p50_s", "ttft_p99_s",
            "itl_p50_s", "itl_p99_s", "tp_calls_per_decode_step",
            "tp_bytes_per_decode_step", "ep_exchanges_per_decode_step",
            "ep_bytes_per_decode_step", "ep_ms_per_decode_step_eager_probe",
            "logits_rel_err", "graphs", "launches", "mesh")
    return {"pd": {k: pd[k] for k in keys}, "step": step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="the four devices of the four-card layout, "
                         "comma-separated (default cuda:0,...,cuda:3)")
    ap.add_argument("--reduced", action="store_true",
                    help="2 granite layers and reduced deepseek-7b (a "
                         "rehearsal)")
    args = ap.parse_args(argv)
    import torch
    devices = (args.devices.split(",") if args.devices
               else [f"cuda:{i}" for i in range(4)])
    if len(devices) != 4:
        print("tp_four_cards: four devices", file=sys.stderr)
        return 2
    on_cuda = devices[0].startswith("cuda")
    if on_cuda and torch.cuda.device_count() < len(set(devices)):
        print(f"tp_four_cards: needs {len(set(devices))} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cs = load_smoke()
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention, ssd_chunk]
    out = {}
    try:
        if on_cuda:
            from repro_torch.kernels.build import load_kernels
            load_kernels()
        for name, devs in (("one card", [devices[0]] * 4),
                           ("four cards", devices)):
            out[name] = run_layout(cs, name, devs, args.reduced, counters)
    except Exception:
        traceback.print_exc()
        return 1
    one, four = out["one card"], out["four cards"]
    print(f"[tp four cards] memory_allocated per card after the "
          f"deepseek-7b placement: four cards "
          f"{four['step']['memory_allocated_after_placement']!r}; weight "
          f"storage per card {four['step']['weights']['held']!r}",
          flush=True)
    print(f"[tp four cards] merged decode step p50: one card "
          f"{one['pd']['decode_step_p50_s']!r} s, four cards "
          f"{four['pd']['decode_step_p50_s']!r} s; deepseek-7b TP step "
          f"p50: one card {one['step']['tp_step_p50_s']!r} s, four cards "
          f"{four['step']['tp_step_p50_s']!r} s (unsharded "
          f"{four['step']['unsharded_step_p50_s']!r} s)", flush=True)
    if on_cuda:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(out["card"], flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tp_four_cards.json"),
              "w") as f:
        json.dump(out, f, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
