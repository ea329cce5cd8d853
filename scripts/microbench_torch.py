"""Scheduler and sharded-plane micro-benchmarks of the PyTorch port.

    PYTHONPATH=src python3 scripts/microbench_torch.py [--device cpu]

The twin of `benchmarks/microbench.py`: the scheduler's decision
latency at production batch sizes (PBAA, the IQR-lex decode
allocation, a radix-tree match, the block pool's free store against the
sorted list it replaced), on the port's copies of the scheduler layer,
then the sharded plane's probes at 2, 4 and 8 shards: `ep_a2a`, the EP
exchange's dispatch and combine of a (n·64, top_k·d_model) bf16 buffer
(reduced granite-moe-1b-a400m's widths) through
`models.moe_ep.ep_all_to_all`, and `sharded_decode_step`, the merged
paged decode step of reduced granite-moe-1b-a400m (max_len 64,
max_batch 2, block_size 8) behind `EngineSpec(mesh=...)`, run through
the step runner (a CUDA graph replay on the card).  The reference runs
each shard count in a subprocess of forced host devices; here the
shards are logical ones of `--device` (`make_engine_mesh(n,
devices=[device] * n)`), so no subprocess is needed.  Prints the
reference's `micro/<name>,<us>,` rows last, after a `name,us_per_call,
derived` header.  Times are wall microseconds a call, the device
synchronised after each call on the card.
"""
from __future__ import annotations

import argparse
import random
import sys
import time
from typing import Callable, List

import torch

from repro_torch.core.decode_alloc import schedule_decode_batch
from repro_torch.core.prefill_alloc import pbaa
from repro_torch.core.types import DecodeDPState, DPState, Request


def _time(fn, reps=20):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6   # µs


def scheduler_rows(report: Callable) -> List[str]:
    """The reference's scheduler probes, on the port's copies."""
    rows: List[str] = []
    rng = random.Random(0)
    report("\n## Scheduler micro-benchmarks (decision latency)")
    report(f"{'op':>34} {'us/call':>10}")

    def bench_pbaa():
        dps = [DPState(i, 0, 16384) for i in range(8)]
        reqs = [Request(rid=i, arrival_time=0,
                        input_len=rng.randrange(100, 8000))
                for i in range(64)]
        pbaa([], reqs, dps)
    us = _time(bench_pbaa)
    report(f"{'PBAA (64 reqs × 8 DPs)':>34} {us:>10.1f}")
    rows.append(f"micro/pbaa_64x8,{us:.1f},")

    def bench_decode():
        units = [DecodeDPState(i, 0, batch=rng.randrange(40),
                               kv_tokens=rng.randrange(100_000))
                 for i in range(32)]
        reqs = [Request(rid=i, arrival_time=0,
                        input_len=rng.randrange(100, 8000))
                for i in range(64)]
        schedule_decode_batch(reqs, units)
    us = _time(bench_decode)
    report(f"{'IQR-lex decode (64 reqs × 32 DPs)':>34} {us:>10.1f}")
    rows.append(f"micro/decode_64x32,{us:.1f},")

    from repro_torch.core.prefix_cache import RadixTree
    t = RadixTree(block=16)
    seqs = [tuple(rng.randrange(1000) for _ in range(512)) for _ in range(64)]
    for s in seqs[:32]:
        t.insert(s)

    def bench_radix():
        for s in seqs:
            t.match(s)
    us = _time(bench_radix) / 64
    report(f"{'radix match (512 tokens)':>34} {us:>10.1f}")
    rows.append(f"micro/radix_match_512,{us:.1f},")

    from repro_torch.serving.kv_pool import BlockPool

    N_BLOCKS, REQ_BLOCKS, ROUNDS = 65536, 8, 256

    class _SortedListStore:
        """The pre-heap free store, inlined for comparison."""
        def __init__(self, num_blocks):
            self.free = list(range(1, num_blocks))

        def alloc(self, n):
            out, self.free = self.free[:n], self.free[n:]
            return out

        def free_blocks(self, ids):
            self.free = sorted(self.free + list(ids))

    def _churn(alloc, free):
        crng = random.Random(42)
        held = []
        for _ in range(ROUNDS):
            held.append(alloc(REQ_BLOCKS))
            if len(held) > 64:
                free(held.pop(crng.randrange(len(held))))

    pool = BlockPool(N_BLOCKS, 16)
    store = _SortedListStore(N_BLOCKS)
    for name, fn in (
            ("pool_heap", lambda: _churn(pool.alloc, pool.free)),
            ("pool_sorted", lambda: _churn(store.alloc,
                                           store.free_blocks))):
        us = _time(fn, reps=5)
        report(f"{f'{name} churn (8-blk reqs, 64K pool)':>34} {us:>10.1f}")
        rows.append(f"micro/{name}_churn_64k,{us:.1f},")
    return rows


def _timed(fn: Callable, reps: int, device: str) -> float:
    """Wall µs a call of `fn` after one warm call (a capture, on the
    card), the device synchronised after each."""
    def call():
        fn()
        if device != "cpu":
            torch.cuda.synchronize()
    call()
    return _time(call, reps)


def sharded_rows(report: Callable, device: str) -> List[str]:
    """`ep_a2a` and `sharded_decode_step` at each shard count."""
    import threading
    from repro_torch.config.base import get_arch
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.moe_ep import ep_all_to_all
    from repro_torch.serving.real_engine import EngineSpec
    from repro_torch.serving.step_graphs import StepGraphs
    rows: List[str] = []
    report(f"\n## Sharded-plane collectives (logical shards of {device})")
    report(f"{'op':>34} {'us/call':>10}")
    cfg = get_arch("granite-moe-1b-a400m", reduced=True)
    params = init_params(cfg, seed=0, device=device)
    for n in (2, 4, 8):
        mesh = make_engine_mesh(n, devices=[device] * n)
        # one MoE layer's activation exchange: top_k·d_model bf16 a
        # token, 64 tokens a shard, dispatch then combine
        bufs = [torch.zeros((n, 64 // n, cfg.moe.top_k * cfg.d_model),
                            dtype=torch.bfloat16, device=d)
                for d in mesh.devices]

        def xchg(bufs=bufs, mesh=mesh):
            return ep_all_to_all(ep_all_to_all(bufs, mesh), mesh)
        us = _timed(xchg, 20, device)
        report(f"{f'ep_a2a_{n}dev':>34} {us:>10.1f}")
        rows.append(f"micro/ep_a2a_{n}dev,{us:.1f},")
        spec = EngineSpec(cfg, params, max_len=64, max_batch=2,
                          block_size=8, mesh=mesh, step_graphs=False)
        S = spec.paged_slots
        state = {"cache": spec.merged_paged_cache()}
        toks = [torch.zeros((S, 1), dtype=torch.int32, device=d)
                for d in mesh.devices]
        runner = StepGraphs(spec.params, spec.device, threading.RLock(),
                            devices=mesh.distinct)

        def step(state=state, runner=runner, spec=spec, toks=toks):
            _lg, state["cache"] = runner.run(("decode", "merged"),
                                             spec.decode_fn, state["cache"],
                                             token=toks)
        us = _timed(step, 10, device)
        report(f"{f'sharded_decode_step_{n}dev':>34} {us:>10.1f}")
        rows.append(f"micro/sharded_decode_step_{n}dev,{us:.1f},")
        del runner, spec, state
    return rows


def main(report: Callable = print, device: str = "cuda") -> List[str]:
    return scheduler_rows(report) + sharded_rows(report, device)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the sharded probes' logical shards "
                         "(default cuda; cpu on request)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("microbench_torch: no CUDA device: pass --device cpu",
              file=sys.stderr)
        return 2
    rows = main(lambda s: print(s, flush=True), args.device)
    print("name,us_per_call,derived")
    for r in rows:
        print(r)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
