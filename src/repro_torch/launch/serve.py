"""Serving launcher: run the SBS control plane.

Two modes:
  --mode sim   discrete-event cluster simulation at production scale
               (the paper's §5 numbers; default), on the port's copies
               of `serving/cluster.py` and `serving/workload.py`
  --mode real  a reduced model on `--device` (default cuda: the port's
               kernels on the card) behind the SBS scheduler (threaded
               engines, chunked prefill and decode)

    PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
        --arch deepseek-v3-671b --scheduler sbs --qps 100 --duration 20
    PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
        --arch deepseek-7b --requests 8 [--device cpu]

Counterpart of `repro/launch/serve.py`: the same flags and output, plus
`--device`.  The real mode draws its weights with the port's
`init_params` (seed `--seed`, fp32), so its tokens are not the
reference's on the same seed; `serve_real` takes any weights (a test
hands it the reference's, bridged).
"""
from __future__ import annotations

import argparse
import random
from typing import Dict, List


def make_requests(cfg, n: int, seed: int) -> List:
    """The real mode's traffic: n prompts of 16-95 random tokens, 50 ms
    apart, 8 new tokens each (the reference's)."""
    from repro_torch.core.types import Request
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        L = rng.randrange(16, 96)
        reqs.append(Request(
            rid=i, arrival_time=i * 0.05, input_len=L, output_len=8,
            tokens=tuple(rng.randrange(cfg.vocab_size) for _ in range(L))))
    return reqs


def serve_real(cfg, params: Dict, reqs: List, device: str,
               scheduler: str = "sbs"):
    """`reqs` through `RealSBSServer(cfg, params)` with the reference
    launcher's settings (its default serving config, max_len 160, 8 new
    tokens); returns (the finished requests' generations, the server)."""
    from repro_torch.serving.server import RealSBSServer
    srv = RealSBSServer(
        cfg, params,
        scheduler="sbs" if scheduler == "sbs" else "immediate",
        max_len=160, max_new=8, device=device)
    return srv.serve(reqs, timeout=300), srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sim", choices=["sim", "real"])
    ap.add_argument("--arch", default="deepseek-v3-671b")
    ap.add_argument("--scheduler", default="sbs",
                    choices=["sbs", "immediate-rr", "immediate-lt"])
    ap.add_argument("--workload", default="short",
                    choices=["short", "long", "decode"])
    ap.add_argument("--qps", type=float, default=100.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--chunk", type=int, default=3072)
    ap.add_argument("--prefill-instances", type=int, default=3)
    ap.add_argument("--dp-per-instance", type=int, default=8)
    ap.add_argument("--cache-aware", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the real mode's device (default cuda; cpu on "
                         "request)")
    args = ap.parse_args(argv)

    from repro_torch.config.base import ServingConfig, get_arch

    if args.mode == "sim":
        from repro_torch.serving.cluster import PrefillClusterSim
        from repro_torch.serving.workload import SPECS, generate
        cfg = get_arch(args.arch)
        scfg = ServingConfig(
            num_prefill_instances=args.prefill_instances,
            prefill_dp_per_instance=args.dp_per_instance,
            chunk_size=args.chunk, cache_aware=args.cache_aware,
            t_default=0.1)
        reqs = generate(SPECS[args.workload], qps=args.qps,
                        duration=args.duration, seed=args.seed,
                        with_tokens=args.cache_aware,
                        shared_prefix_prob=0.5 if args.cache_aware else 0.0)
        sim = PrefillClusterSim(cfg, scfg, scheduler=args.scheduler)
        rep = sim.run(reqs, args.duration)
        print(f"{args.scheduler} @ {args.qps} qps: {rep.row()}")
        return

    # real execution (reduced model)
    import torch
    from repro_torch.models.model import init_params
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU")
    cfg = get_arch(args.arch, reduced=True)
    params = init_params(cfg, seed=args.seed, device=args.device)
    reqs = make_requests(cfg, args.requests, args.seed)
    gens, srv = serve_real(cfg, params, reqs, args.device, args.scheduler)
    for g in gens:
        print(f"rid={g.rid} ttft={g.ttft*1000:7.1f}ms tokens={g.tokens}")
    print(f"served {len(gens)}/{len(reqs)}; "
          f"adapted I_opt={srv.state.interval.interval*1000:.1f}ms")


if __name__ == "__main__":
    main()
