"""Reproduce the paper's production-scale experiments in the discrete-event
simulator: the 3P1D DeepSeek-V3 cluster (§5) — TTFT vs load, chunk
utilization, and decode balance — plus the bursty and long-context
heavy-tail traffic scenarios on the unified ClusterRuntime.

The PyTorch port's twin of `examples/simulate_production.py`: the same
script over the port's copies of the simulator modules (`config`,
`serving.cluster`, `serving.e2e`, `serving.workload`), which import
neither torch nor JAX; on the same seeds it prints the same summary.

    PYTHONPATH=src python examples/simulate_production_torch.py [--quick]
"""
import argparse
import dataclasses

from repro_torch.config import ServingConfig, get_arch
from repro_torch.serving.cluster import DecodeClusterSim, PrefillClusterSim
from repro_torch.serving.e2e import PDClusterSim
from repro_torch.serving.workload import (
    BURSTY, DECODE_BURST, DIURNAL, HEAVY_TAIL, OVERLOAD_SPIKE,
    SHARED_PREFIX, SHORT, WorkloadSpec, generate,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    dur = 8.0 if args.quick else 20.0

    cfg = get_arch("deepseek-v3-671b")
    print("== Prefill: 3 instances × DP8, chunk 3K, DeepSeek-V3 ==")
    scfg = ServingConfig(num_prefill_instances=3, prefill_dp_per_instance=8,
                         chunk_size=3072, t_default=0.1)
    for qps in (60, 100, 130):
        line = [f"qps={qps:4d}"]
        for sched in ("immediate-rr", "sbs"):
            reqs = generate(SHORT, qps=qps, duration=dur, seed=0)
            rep = PrefillClusterSim(cfg, scfg, scheduler=sched).run(reqs, dur)
            line.append(f"{sched}: ttft={rep.ttft_mean*1000:6.1f}ms "
                        f"util={rep.chunk_util*100:4.1f}%")
        print("   ".join(line))

    print("\n== Prefill scenarios: bursty (MMPP) & long-context heavy-tail ==")
    for name, spec, qps in (("bursty", BURSTY, 80),
                            ("heavy_tail", HEAVY_TAIL, 25)):
        line = [f"{name:>10} qps={qps:3d}"]
        for sched in ("immediate-rr", "sbs"):
            reqs = generate(spec, qps=qps, duration=dur, seed=7)
            rep = PrefillClusterSim(cfg, scfg, scheduler=sched).run(reqs, dur)
            line.append(f"{sched}: ttft={rep.ttft_mean*1000:7.1f}ms "
                        f"p99={rep.ttft_p99*1000:7.1f}ms")
        print("   ".join(line))

    print("\n== Prefill: shared_prefix (Zipf multi-tenant system prompts) ==")
    for label, c in (("sbs", scfg),
                     ("sbs+cache", dataclasses.replace(scfg,
                                                       cache_aware=True))):
        reqs = generate(SHARED_PREFIX, qps=100, duration=dur, seed=3,
                        with_tokens=True)
        sim = PrefillClusterSim(cfg, c, scheduler="sbs")
        rep = sim.run(reqs, dur)
        cache = getattr(sim.sched, "cache", None)
        hr = cache.hit_rate if cache is not None else 0.0
        print(f"{label:>10} ttft={rep.ttft_mean*1000:7.1f}ms "
              f"p99={rep.ttft_p99*1000:7.1f}ms "
              f"util={rep.chunk_util*100:4.1f}% hit={hr*100:4.1f}%")

    print("\n== Decode: DP=32, EP=32, closed-loop batch ≈ 35/DP ==")
    dcfg = ServingConfig(num_decode_instances=1, decode_dp_per_instance=32,
                         max_batch_per_dp=64, kv_budget_tokens=200_000)
    spec = WorkloadSpec("decode", 256, 32768, 2000.0, out_mean=500)
    for sched in ("immediate", "sbs", "sbs-la"):
        reqs = generate(spec, qps=10_000, duration=5, seed=1)[:15_000]
        sim = DecodeClusterSim(cfg, dcfg, scheduler=sched)
        rep = sim.run(reqs, 30.0 if args.quick else 60.0,
                      closed_loop=32 * 35)
        print(f"{sched:10s} {rep.row()}")

    print("\n== Decode-heavy bursts (decode_burst): P/D pipeline vs "
          "unified mixed-batch plane ==")
    # same 4-DP decode pool on the 7B arch (mixed chunk sizing is
    # per-arch; 2048 @ 7B keeps the mixed step near the decode step —
    # see benchmarks/e2e_pd._mixed_batch): the unified plane runs
    # chunked prefill inside the decode steps, no transfer hop
    cfg7 = get_arch("deepseek-7b")
    mdur = 4.0 if args.quick else 8.0
    pipe_cfg = ServingConfig(num_prefill_instances=1,
                             prefill_dp_per_instance=4,
                             num_decode_instances=1,
                             decode_dp_per_instance=4, chunk_size=2048)
    unified_cfg = ServingConfig(num_prefill_instances=1,
                                num_decode_instances=1,
                                decode_dp_per_instance=4,
                                mixed_batch=True, mixed_chunk=2048,
                                bucket_size=512)
    for label, c in (("pd_pipeline", pipe_cfg),
                     ("unified", unified_cfg),
                     ("unified_disjoint", dataclasses.replace(
                         unified_cfg, mixed_piggyback=False))):
        reqs = generate(DECODE_BURST, qps=6, duration=mdur, seed=31)
        sim = PDClusterSim(cfg7, c, scheduler="sbs-la")
        rep = sim.run(reqs, mdur)
        print(f"{label:>17}  {rep.row()}")

    print("\n== Overload control: SLO classes under a 5x spike and a "
          "compressed diurnal cycle ==")
    # a deliberately tight decode pool (2x4 DP, 12K KV tokens each): the
    # spike exhausts the KV budgets, so preemption/flow-control have real
    # choices; goodput buckets by class deadline (see core.types)
    ocfg = ServingConfig(num_prefill_instances=2, prefill_dp_per_instance=4,
                         num_decode_instances=2, decode_dp_per_instance=4,
                         chunk_size=3072, t_default=0.5,
                         max_batch_per_dp=16, kv_budget_tokens=12_000)
    odur = 6.0 if args.quick else 15.0
    for scen, spec in (("overload_spike", OVERLOAD_SPIKE),
                       ("diurnal", DIURNAL)):
        print(f"-- {scen} (qps=24, sbs-la)")
        for mode, kw in (("baseline", {}),
                         ("preempt", dict(preemption=True)),
                         ("preempt+flow", dict(preemption=True,
                                               flow_control=True))):
            reqs = generate(spec, qps=24, duration=odur, seed=23)
            sim = PDClusterSim(cfg, dataclasses.replace(ocfg, **kw),
                               scheduler="sbs-la")
            rep = sim.run(reqs, odur)
            print(f"{mode:>13}  {rep.row()}")


if __name__ == "__main__":
    main()
