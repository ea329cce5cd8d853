#!/usr/bin/env python3
"""What a graph capture inside a prefill pass does to SBS dispatch,
emulated on the CPU.

    PYTHONPATH=src python3 scripts/capture_stall_emulation.py \
        [--per spec|engine] [--delay 0.3] [--trials 5] [twin flags ...]

On the card, a dense prefill chunk of a length no graph holds yet is
captured inside the pass that first runs it (0.1-0.4 s on the H100,
against passes of tens of ms).  The SBS prefill scheduler's watchdog
(5 × T_fwd) may then trip, and every PBAA cycle in which a request is
left over (a prompt's tail pinned to a DP whose pass is stalled, or
outbid by longer prompts) adds one to its wait; past 16 cycles the flow
controller rejects it (priority 1: n_limit 8 × 2), and the serve ends
with that request unfinished.

This runs the serving twin (`examples/serve_e2e_torch.py`, its default
sweep unless other flags are given) on the CPU at reduced width, where
nothing is captured, and sleeps `--delay` seconds at the first use of
each dense chunk length: once a spec (`--per spec`, how the port
captures dense chunks: `EngineSpec.dense_graphs`) or once an engine
(`--per engine`, one runner each, as the port captured them before).
For every serve of an SBS scheduler it prints the requests finished,
the largest PBAA wait of any request and the rejected ones; the last
line counts the serves with an unfinished request.
"""
import argparse
import importlib.util
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.serving import server as server_mod  # noqa: E402
from repro_torch.serving.real_engine import EngineSpec  # noqa: E402


def load_twin():
    spec = importlib.util.spec_from_file_location(
        "serve_e2e_torch", os.path.join(ROOT, "examples", "serve_e2e_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per", choices=("spec", "engine"), default="spec")
    ap.add_argument("--delay", type=float, default=0.3)
    ap.add_argument("--trials", type=int, default=5)
    args, twin_flags = ap.parse_known_args()
    torch.set_num_threads(2)
    twin = load_twin()
    seen, lock = set(), threading.Lock()
    inner = EngineSpec.dense_prefill

    def dense_prefill(self, graphs, tokens, *rest):
        # the spec's entries are one dict shared by its engines' runners
        owner = graphs._entries if args.per == "spec" else graphs
        key = (id(owner), tokens.shape[1])
        with lock:
            first = key not in seen
            seen.add(key)
        if first:
            time.sleep(args.delay)
        return inner(self, graphs, tokens, *rest)

    EngineSpec.dense_prefill = dense_prefill
    unfinished = [0, 0]

    class Server(server_mod.RealSBSServer):
        def serve(self, requests, timeout=120.0):
            t0 = time.monotonic()
            gens = super().serve(requests, timeout=timeout)
            if self.sched is None or not hasattr(self.sched, "sync"):
                return gens         # no SBS prefill dispatch in this serve
            unfinished[1] += 1
            unfinished[0] += len(gens) < len(requests)
            print(f"  {self.scheduler}: {len(gens)}/{len(requests)} "
                  f"finished, wall {time.monotonic() - t0:.2f} s, "
                  f"T_fwd {self.state.interval.t_fwd:.3f} s, largest "
                  f"PBAA wait {max(r.wait_cycles for r in requests)}, "
                  f"rejected {[r.rid for r in self.sched.rejected]}",
                  flush=True)
            return gens

    def make(*a, scheduler="sbs", **kw):
        srv = Server(*a, scheduler=scheduler, **kw)
        srv.scheduler = scheduler
        return srv

    twin.RealSBSServer = make
    for t in range(args.trials):
        seen.clear()
        print(f"trial {t} (a {args.delay} s capture once a {args.per})",
              flush=True)
        try:
            twin.main(["--device", "cpu", "--reduced", *twin_flags])
        except SystemExit:
            pass
    print(f"SBS serves with an unfinished request: {unfinished[0]} of "
          f"{unfinished[1]} (a {args.delay} s capture once a {args.per})")


if __name__ == "__main__":
    main()
