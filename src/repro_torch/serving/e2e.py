"""End-to-end P/D-disaggregated cluster simulation (the paper's 3P1D
deployment): requests flow prefill pool → KV-cache transfer (ICI/DCN) →
decode pool, with SBS or immediate scheduling on BOTH phases.  The event
loop is the unified `repro_torch.serving.runtime.ClusterRuntime` — this module
only wires the two planes together and derives the report.

Metrics: TTFT (arrival → first token, includes the transfer), TPOT, E2E
latency, and goodput (requests completing within an SLO).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.flow_control import FlowController
from repro_torch.core.types import Request
from repro_torch.serving.cluster import (
    build_decode_instances, build_decode_scheduler, build_prefill_instances,
    build_prefill_scheduler, build_state,
)
from repro_torch.serving.costmodel import CostModel, ICI_BW
from repro_torch.serving.metrics import goodput_by_class, mean, percentile
from repro_torch.serving.runtime import ClusterRuntime


@dataclasses.dataclass
class E2EReport:
    n_finished: int
    ttft_mean: float
    ttft_p50: float
    ttft_p99: float
    tpot_mean: float
    e2e_mean: float
    goodput: float                  # fraction finishing within slo_e2e
    prefill_util: float
    throughput: float = 0.0        # decode tokens / s over the run
    # inter-token latency (gap between consecutive emissions of one
    # request) — the unified mixed-batch plane's tentpole metric: decode
    # stalls behind disjoint prefill passes surface as a fat ITL p99
    itl_p50: float = 0.0
    itl_p99: float = 0.0
    prefix_hit_rate: float = 0.0   # cached prefix tokens / prompt tokens
    prefill_flops_saved: float = 0.0   # FLOPs skipped via prefix reuse
    # SLO-aware overload control (all zero/empty when it is off)
    goodput_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    rejected: int = 0              # flow-control rejections
    preemptions: int = 0           # page-level swap-out events

    def row(self) -> str:
        out = (f"n={self.n_finished} ttft={self.ttft_mean*1000:.0f}ms "
               f"p99={self.ttft_p99*1000:.0f}ms "
               f"tpot={self.tpot_mean*1000:.1f}ms "
               f"itl_p99={self.itl_p99*1000:.1f}ms "
               f"e2e={self.e2e_mean:.2f}s goodput={self.goodput*100:.1f}% "
               f"util={self.prefill_util*100:.1f}% "
               f"thr={self.throughput:.0f} tok/s")
        if self.prefix_hit_rate:
            out += (f" hit={self.prefix_hit_rate*100:.1f}% "
                    f"saved={self.prefill_flops_saved:.2e}FLOPs")
        if self.rejected or self.preemptions:
            out += f" rej={self.rejected} preempt={self.preemptions}"
        if len(self.goodput_by_class) > 1:
            out += " [" + " ".join(
                f"{c}={g*100:.0f}%"
                for c, g in self.goodput_by_class.items()) + "]"
        return out

    def json_row(self) -> dict:
        return {"n_finished": self.n_finished,
                "ttft_p50": self.ttft_p50, "ttft_p99": self.ttft_p99,
                "ttft_mean": self.ttft_mean, "tpot_mean": self.tpot_mean,
                "itl_p50": self.itl_p50, "itl_p99": self.itl_p99,
                "throughput": self.throughput, "goodput": self.goodput,
                "prefix_hit_rate": self.prefix_hit_rate,
                "prefill_flops_saved": self.prefill_flops_saved,
                "goodput_by_class": self.goodput_by_class,
                "rejected": self.rejected,
                "preemptions": self.preemptions}


class PDClusterSim:
    """3P1D-style pipeline with KV transfer between the pools.

    scheduler ∈ {sbs, sbs-la, immediate}: 'sbs-la' keeps SBS on the
    prefill side but switches decode to Load-Aware Global Allocation."""

    def __init__(self, model_cfg: ModelConfig, scfg: ServingConfig,
                 scheduler: str = "sbs", cost: Optional[CostModel] = None,
                 transfer_bw: float = ICI_BW,
                 watchdog_multiplier: float = 0.0):
        self.cfg = model_cfg
        self.scfg = scfg
        self.cost = cost or CostModel(model_cfg)
        self.state = build_state(scfg)
        self.transfer_bw = transfer_bw
        if scheduler not in ("sbs", "sbs-la", "immediate"):
            raise ValueError(scheduler)
        if scfg.mixed_batch:
            # unified mixed-batch plane: DECODE-POOL-ONLY deployment —
            # arrivals hand off straight to the decode scheduler and the
            # unified instances run chunked prefill piggybacked on their
            # own steps (no prefill pool, no KV transfer)
            self.psched = None
            self.prefill = []
        elif scheduler == "immediate":
            self.psched = build_prefill_scheduler(self.state, scfg,
                                                  "immediate-rr")
            self.prefill = build_prefill_instances(self.state, scfg,
                                                   self.cost)
        else:
            self.psched = build_prefill_scheduler(self.state, scfg, "sbs")
            self.prefill = build_prefill_instances(self.state, scfg,
                                                   self.cost)
        self.dsched = build_decode_scheduler(
            self.state, scfg, scheduler,
            watchdog_multiplier=watchdog_multiplier)
        self.decode = build_decode_instances(self.state, scfg, self.cost)
        flow = (FlowController(n_limit=scfg.n_limit,
                               backoff_base=scfg.flow_backoff)
                if scfg.flow_control else None)
        self.runtime = ClusterRuntime(
            self.state, prefill_sched=self.psched,
            prefill_instances=self.prefill or None,
            decode_sched=self.dsched,
            decode_instances=self.decode,
            transfer_time=None if scfg.mixed_batch else self._transfer_time,
            flow=flow, preemption=scfg.preemption)

    def _transfer_time(self, req: Request) -> float:
        bytes_ = self.cost.kv_bytes_per_token * req.input_len
        return bytes_ / self.transfer_bw + 0.002

    def run(self, requests: Sequence[Request], duration: float,
            slo_e2e: Optional[float] = None) -> E2EReport:
        slo = slo_e2e if slo_e2e is not None else self.scfg.slo_default
        end = self.runtime.run(requests, duration,
                               horizon=duration * 30 + 120.0)
        done = [r for r in requests if r.finish_time is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [(r.finish_time - r.first_token_time) / max(r.generated - 1, 1)
                 for r in done if r.first_token_time is not None]
        e2e = [r.finish_time - r.arrival_time for r in done]
        # goodput = SLO-attained throughput: a request's own slo_e2e (its
        # priority class) wins over the deployment default; rejected and
        # unfinished requests stay in the denominator
        good = (sum(1 for r in requests if r.slo_attained(slo))
                / max(len(requests), 1))
        # prefix-reuse accounting: the sim prices savings with the SAME
        # cost model the dispatcher uses, so sim and real planes share one
        # reuse model (the real plane reports engine-truth counters via
        # RealSBSServer.prefix_stats instead)
        cache = getattr(self.psched, "cache", None)
        hit_rate = cache.hit_rate if cache is not None else 0.0
        saved = (self.cost.prefill_flops(cache.hit_tokens)
                 if cache is not None and cache.hit_tokens else 0.0)
        itls = [s for inst in self.decode
                for s in getattr(inst, "itl", [])]
        return E2EReport(
            n_finished=len(done),
            ttft_mean=mean(ttfts), ttft_p50=percentile(ttfts, 50),
            ttft_p99=percentile(ttfts, 99),
            tpot_mean=mean(tpots), e2e_mean=mean(e2e),
            itl_p50=percentile(itls, 50) if itls else 0.0,
            itl_p99=percentile(itls, 99) if itls else 0.0,
            goodput=good,
            prefill_util=self.runtime.prefill_util,
            throughput=self.runtime.tokens_generated / max(end, 1e-9),
            prefix_hit_rate=hit_rate, prefill_flops_saved=saved,
            goodput_by_class=goodput_by_class(requests, slo),
            rejected=len(self.runtime.rejected),
            preemptions=len(self.runtime.preempted))
