#!/usr/bin/env python3
"""Where the time of a dense P/D prefill pass goes, on the serving
benchmark twin's SLO-overload A/B.

    python3 scripts/prefill_pass_split.py [--root TREE] [--device cuda]
        [--reduced] [--repeat N]

Runs `TREE/examples/serve_e2e_torch.py --overload-bench` (the reference's
trace: deepseek-7b, 6 batch hogs and 2 interactive requests, 32-token
dense prefill chunks, paged decode) against `TREE/src` (default: the
checkout holding this script), and, in each leg's timed serve
(drain-only, then preemption), splits every prefill pass into:

  * `pass_ms`: the pass's wall time on its engine's worker thread (the
    job `RealPrefillEngine._exec_pass`, first chunk issued to the last
    chunk's first-token sync);
  * `lock_wait_ms`: time the worker spent acquiring the spec's
    `step_lock` (the lock every engine of the deployment holds while it
    queues a step or captures a graph);
  * `upload_ms`: time in the chunk's token upload (`torch.tensor(...,
    device=...)` from pageable host memory, which waits for the work
    queued before it on the stream);
  * `call_ms`: the rest of the host time in the chunk calls
    (`_run_chunk`): issuing the chunk's work and, for a prompt's last
    chunk, the first-token sync;
  * `device_ms_per_pass`: device time of the prefill chunks, from
    torch.profiler's CUDA activity (`prefill_device`: on a tree whose
    dense chunks replay graphs, every kernel of a chunk's graph; on an
    eager tree only kernel #2's own launches can be told apart from the
    decode steps' on the shared stream), over the timed serve's passes.

Everything is measured by wrapping the package's classes from outside
(the same wrappers on any tree of the port), so the script compares two
trees.  Each repeat runs the A/B twice: once with the wrappers alone
(the host parts) and once under the profiler (the device part; its
host figures are slowed by the profiler and not reported).  The twin's
own lines (goodput, interactive e2e and TTFT) are printed by its CLI as
usual.  Prints one JSON line `{"prefill_pass_split": {...}}` (per leg:
passes, chunks, means and p50/p99 of each part, the twin's `T_fwd`
estimate at the end of the serve, the device time of the prefill
chunks, and the card's name and power limit).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _TimedLock:
    """A spec's `step_lock` that times its acquisitions on the threads
    `log.on` marks (the prefill workers, inside a pass)."""

    def __init__(self, lock, log):
        self._lock = lock
        self._log = log

    def acquire(self, *a, **kw):
        t0 = time.perf_counter()
        ok = self._lock.acquire(*a, **kw)
        self._log.add("lock_wait", time.perf_counter() - t0)
        return ok

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _Log(threading.local):
    pass


class Split:
    """Per-pass accumulators, filled on the prefill worker threads."""

    def __init__(self):
        self.passes = []            # one dict per pass
        self.tls = _Log()
        self.on = False             # inside a measured serve

    def add(self, part, seconds):
        cur = getattr(self.tls, "cur", None)
        if cur is not None:
            cur[part] = cur.get(part, 0.0) + seconds


def install(RE, split):
    """Wrap the prefill engine's pass and chunk methods, the spec's lock
    and the engine module's token upload; returns the undo."""
    Eng, Spec = RE.RealPrefillEngine, RE.EngineSpec
    inner_pass, inner_chunk = Eng._exec_pass, Eng._run_chunk
    inner_post = Spec.__post_init__
    inner_torch = RE.torch

    def exec_pass(self, batch, post):
        if not split.on:
            return inner_pass(self, batch, post)
        cur = split.tls.cur = {"chunks": 0}
        t0 = time.perf_counter()

        # the worker posts pass_end inside the job: time up to it
        def timed_post(kind, payload):
            cur["pass"] = time.perf_counter() - t0
            split.passes.append(cur)
            split.tls.cur = None
            post(kind, payload)
        try:
            return inner_pass(self, batch, timed_post)
        finally:
            split.tls.cur = None

    def run_chunk(self, req, tok):
        t0 = time.perf_counter()
        try:
            return inner_chunk(self, req, tok)
        finally:
            split.add("chunk_call", time.perf_counter() - t0)
            split.add("chunks", 1)

    def post_init(self):
        inner_post(self)
        self.step_lock = _TimedLock(self.step_lock, split)

    class _Torch:
        """The engine module's `torch`, with `tensor` timed."""

        def __getattr__(self, name):
            return getattr(inner_torch, name)

        @staticmethod
        def tensor(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner_torch.tensor(*a, **kw)
            finally:
                split.add("upload", time.perf_counter() - t0)

    Eng._exec_pass, Eng._run_chunk = exec_pass, run_chunk
    Spec.__post_init__ = post_init
    RE.torch = _Torch()

    def undo():
        Eng._exec_pass, Eng._run_chunk = inner_pass, inner_chunk
        Spec.__post_init__ = inner_post
        RE.torch = inner_torch
    return undo


PREFILL_KERNELS = ("flash_kernel", "ssd_chunk_kernel")


def prefill_device(prof):
    """(device seconds of the prefill chunks, chunks found, all device
    seconds) of a profile: the device events that share a correlation id
    with a prefill kernel (#2's contiguous entry or #4, which only the
    dense prefill runs on the P/D plane).  A replayed graph's kernels all
    carry its `cudaGraphLaunch`'s id, so on a tree whose dense chunks
    replay graphs each group is one chunk's whole device time; an eager
    step's kernels each carry their own, so on an eager tree only the
    prefill kernels themselves are found."""
    from torch.autograd import DeviceType
    groups, total = {}, 0.0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0
                or e.is_user_annotation()):
            continue
        groups.setdefault(e.correlation_id(), []).append(e)
        total += e.duration_ns() / 1e9
    chunks = [g for g in groups.values()
              if any(k in e.name() for e in g for k in PREFILL_KERNELS)]
    ours = sum(e.duration_ns() for g in chunks for e in g) / 1e9
    return ours, len(chunks), total


def _stats(xs):
    xs = sorted(xs)
    if not xs:
        return None

    def q(p):
        k = (len(xs) - 1) * p
        lo = int(k)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
    return {"mean": statistics.fmean(xs), "p50": q(0.5), "p99": q(0.99)}


def summarize(passes, wall_s, t_fwd):
    """The leg's host figures, times in ms."""
    ms = 1e3
    call = [p.get("chunk_call", 0.0) - p.get("lock_wait", 0.0)
            - p.get("upload", 0.0) for p in passes]
    return {
        "passes": len(passes),
        "chunks": sum(p.get("chunks", 0) for p in passes),
        "serve_wall_s": wall_s,
        "t_fwd_ms": None if t_fwd is None else t_fwd * ms,
        "pass_ms": _stats([p["pass"] * ms for p in passes]),
        "lock_wait_ms": _stats([p.get("lock_wait", 0.0) * ms
                                for p in passes]),
        "upload_ms": _stats([p.get("upload", 0.0) * ms for p in passes]),
        "call_ms": _stats([c * ms for c in call]),
    }


def load_twin(root):
    spec = importlib.util.spec_from_file_location(
        "serve_e2e_torch_split",
        os.path.join(root, "examples", "serve_e2e_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root=HERE, device="cuda", reduced=False, profiled=False,
            bench=None):
    """Run the twin's overload A/B from `root` with the split installed;
    returns {leg: figures}: the host parts, or with `profiled` (on the
    card) the device part.  The package is the one on sys.path (put
    `root/src` first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import real_engine as RE
    twin = load_twin(root)
    split = Split()
    legs = {}
    inner_srv = twin.RealSBSServer

    class Measured(inner_srv):
        def serve(self, requests, timeout=120.0):
            timed = any(r.slo_class == "interactive" for r in requests) \
                and len(requests) > 2
            if not timed:
                return super().serve(requests, timeout=timeout)
            leg = "preempt" if self.scfg.preemption else "drain_only"
            split.passes = []
            prof = (profile(activities=[ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            split.on = True
            t0 = time.monotonic()
            try:
                with prof:
                    gens = super().serve(requests, timeout=timeout)
                    if device != "cpu":
                        torch.cuda.synchronize()
            finally:
                split.on = False
            wall = time.monotonic() - t0
            if profiled:
                ours, groups, total = prefill_device(prof)
                n = len(split.passes)
                legs[leg] = {
                    "passes": n, "device_busy_s": total,
                    "prefill_device_s": ours, "prefill_launch_groups": groups,
                    "device_ms_per_pass": ours * 1e3 / n if n else None,
                    "device_ms_per_group": (ours * 1e3 / groups if groups
                                            else None)}
            else:
                legs[leg] = summarize(split.passes, wall,
                                      self.state.interval.t_fwd)
                legs[leg]["ttft_interactive_s"] = {
                    r.rid: r.ttft for r in requests
                    if r.slo_class == "interactive"}
            return gens

    undo = install(RE, split)
    twin.RealSBSServer = Measured
    bench = bench or os.path.join(root, "build",
                                  f"prefill_pass_split_{os.getpid()}.json")
    os.makedirs(os.path.dirname(bench), exist_ok=True)
    argv = ["--overload-bench", "--timeout", "150", "--device", device,
            "--bench-json", bench]
    if reduced:
        argv.append("--reduced")
    try:
        twin.main(argv)
    except SystemExit:
        pass                    # 1 = a timing gate failed (printed)
    finally:
        twin.RealSBSServer = inner_srv
        undo()
        if os.path.exists(bench):
            os.remove(bench)
    return legs


def card(device):
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the tree whose src/ and examples/ are measured")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced config in fp32 (CPU "
                         "rehearsal)")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    runs = []
    for _ in range(args.repeat):
        runs.append({"host": measure(root, args.device, args.reduced)})
        if args.device != "cpu":
            runs[-1]["device"] = measure(root, args.device, args.reduced,
                                         profiled=True)
    print(json.dumps({"prefill_pass_split": {
        "tree": args.tag or root, "device": card(args.device),
        "runs": runs}}), flush=True)
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
