"""Cluster simulators — thin configuration wrappers over the unified
`repro.serving.runtime.ClusterRuntime` event loop (paper §5 experiments).

  PrefillClusterSim — TTFT vs load (Fig 6a/6b), chunk utilization & max QPS
                      (Table 1). Scheduler ∈ {sbs, immediate-rr, immediate-lt}.
  DecodeClusterSim  — KV-load balance (Fig 7) and decode throughput (Fig 8).
                      Scheduler ∈ {sbs (IQR-lex), sbs-la (load-aware global
                      allocation), immediate (rr/least_*)}.

Engines report EndForward with measured pass times, closing the
Algorithm-1 feedback loop — the adaptive interval converges online exactly
as in §4.1.1.  The P/D-separated pipeline lives in repro.serving.e2e.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.prefix_cache import PrefixCacheIndex
from repro_torch.core.scheduler import (
    DecodeScheduler, ImmediatePrefillScheduler, PrefillScheduler,
    StaggeredBatchScheduler,
)
from repro_torch.core.state import GlobalState
from repro_torch.core.interval import AdaptiveIntervalController
from repro_torch.core.types import Request
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.engine import (
    SimDecodeInstance, SimPrefillInstance, SimUnifiedInstance,
)
from repro_torch.serving.metrics import (
    DecodeReport, PrefillReport, decode_report, prefill_report,
)
from repro_torch.serving.runtime import ClusterRuntime, EventLoop

# back-compat alias (pre-runtime callers imported the private loop)
_EventLoop = EventLoop


def build_state(cfg_s: ServingConfig) -> GlobalState:
    return GlobalState(
        num_prefill_instances=cfg_s.num_prefill_instances,
        prefill_dp_per_instance=cfg_s.prefill_dp_per_instance,
        num_decode_instances=cfg_s.num_decode_instances,
        decode_dp_per_instance=cfg_s.decode_dp_per_instance,
        chunk_size=cfg_s.chunk_size,
        interval=AdaptiveIntervalController(
            window_size=cfg_s.window_size, l_net=cfg_s.l_net,
            t_default=cfg_s.t_default,
            n_active=cfg_s.num_prefill_instances),
        max_batch_per_dp=cfg_s.resolved_decode_slots,
        kv_budget_tokens=cfg_s.kv_budget_tokens,
        block_size=cfg_s.block_size,
    )


def build_prefill_scheduler(state: GlobalState, scfg: ServingConfig,
                            scheduler: str) -> PrefillScheduler:
    if scheduler == "sbs":
        cache = None
        if scfg.cache_aware:
            cache = PrefixCacheIndex(
                [d.dp_id for d in state.prefill_dps],
                block=scfg.block_size or 16)
        return StaggeredBatchScheduler(
            state, n_limit=scfg.n_limit, cache_aware=scfg.cache_aware,
            prefix_cache=cache,
            watchdog_multiplier=scfg.watchdog_multiplier,
            bucket_size=scfg.bucket_size,
            bucket_max_wait=scfg.bucket_max_wait)
    if scheduler in ("immediate-rr", "immediate-lt"):
        pol = "round_robin" if scheduler.endswith("rr") else "least_tokens"
        return ImmediatePrefillScheduler(state, pol)
    raise ValueError(scheduler)


def build_decode_scheduler(state: GlobalState, scfg: ServingConfig,
                           scheduler: str, policy: str = "round_robin",
                           watchdog_multiplier: float = 0.0,
                           cache_aware: Optional[bool] = None
                           ) -> DecodeScheduler:
    """Decode plane scheduler for any driver (sim or real):
    'sbs' = IQR-lex batched placement, 'sbs-la' = Load-Aware Global
    Allocation, 'immediate' = per-handoff placement baseline.

    With `scfg.cache_aware` (overridable via the `cache_aware` arg, which
    the real server sets when prefix caching is on), 'sbs-la' and
    'immediate' get cache-aware placement: a per-decode-DP prefix index
    steers each hand-off to the DP already holding the longest prefix of
    its prompt (the real plane's per-DP page binders then resolve that
    prefix to live pages)."""
    if scheduler not in ("sbs", "sbs-la", "immediate"):
        raise ValueError(scheduler)
    mode = "immediate" if scheduler == "immediate" else "sbs"
    alloc = "load_aware" if scheduler == "sbs-la" else "lex"
    if cache_aware is None:
        cache_aware = scfg.cache_aware
    cache = None
    if cache_aware and scheduler in ("sbs-la", "immediate"):
        cache = PrefixCacheIndex(
            [d.dp_id for d in state.decode_dps],
            block=scfg.block_size or 16)
    return DecodeScheduler(
        state, mode=mode, policy=policy, iqr_k=scfg.iqr_k,
        window=scfg.l_net * 10 + 0.02, alloc=alloc,
        watchdog_multiplier=watchdog_multiplier,
        prefix_cache=cache, bucket_size=scfg.bucket_size)


def build_prefill_instances(state: GlobalState, scfg: ServingConfig,
                            cost: CostModel):
    return [SimPrefillInstance(
                i, [d.dp_id for d in state.prefill_dps_of(i)],
                scfg.chunk_size, cost)
            for i in range(scfg.num_prefill_instances)]


def build_decode_instances(state: GlobalState, scfg: ServingConfig,
                           cost: CostModel, unified: Optional[bool] = None):
    """`unified` (default: scfg.mixed_batch) swaps in the mixed-batch
    plane: SimUnifiedInstance runs chunked prefill piggybacked on the
    decode steps, so the deployment needs no prefill pool at all."""
    if unified is None:
        unified = scfg.mixed_batch
    if unified:
        return [SimUnifiedInstance(
                    i, [d.dp_id for d in state.decode_dps_of(i)], cost,
                    chunk=scfg.resolved_mixed_chunk,
                    starve_limit=scfg.prefill_starve_limit,
                    piggyback=scfg.mixed_piggyback)
                for i in range(scfg.num_decode_instances)]
    return [SimDecodeInstance(
                i, [d.dp_id for d in state.decode_dps_of(i)], cost)
            for i in range(scfg.num_decode_instances)]


class PrefillClusterSim:
    """Prefill-only pool: one plane of the unified runtime."""

    def __init__(self, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                 scheduler: str = "sbs", cost: Optional[CostModel] = None):
        self.cfg_s = serving_cfg
        self.cost = cost or CostModel(model_cfg)
        self.state = build_state(serving_cfg)
        self.sched = build_prefill_scheduler(self.state, serving_cfg,
                                             scheduler)
        self.instances = build_prefill_instances(self.state, serving_cfg,
                                                 self.cost)
        self.runtime = ClusterRuntime(
            self.state, prefill_sched=self.sched,
            prefill_instances=self.instances)

    def run(self, requests: Sequence[Request], duration: float
            ) -> PrefillReport:
        self.runtime.run(requests, duration,
                         horizon=duration * 20 + 60.0)   # drain guard
        rejected = len(getattr(self.sched, "rejected", []))
        return prefill_report(requests, duration, self.runtime.prefill_util,
                              rejected)


class DecodeClusterSim:
    """Decode-only pool: arrivals are hand-offs straight into the decode
    scheduler.  scheduler='sbs-la' selects the load-aware global
    allocator; `watchdog_multiplier` > 0 arms the re-dispatch path."""

    def __init__(self, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                 scheduler: str = "sbs", policy: str = "round_robin",
                 cost: Optional[CostModel] = None,
                 snapshot_every: int = 1,
                 watchdog_multiplier: float = 0.0):
        self.cfg_s = serving_cfg
        self.cost = cost or CostModel(model_cfg)
        self.state = build_state(serving_cfg)
        self.sched = build_decode_scheduler(
            self.state, serving_cfg, scheduler, policy=policy,
            watchdog_multiplier=watchdog_multiplier)
        self.instances = build_decode_instances(self.state, serving_cfg,
                                                self.cost)
        self.runtime = ClusterRuntime(
            self.state, decode_sched=self.sched,
            decode_instances=self.instances, snapshot_every=snapshot_every)

    @property
    def kv_timeline(self):
        return self.runtime.kv_timeline

    @property
    def batch_timeline(self):
        return self.runtime.batch_timeline

    def run(self, requests: Sequence[Request], duration: float,
            closed_loop: int = 0) -> DecodeReport:
        """Open-loop: requests arrive by their arrival_time. Closed-loop
        (paper §5.2.2: 'average batch size 35'): hold `closed_loop`
        concurrent requests — each finish immediately admits the next."""
        horizon = (duration * 20 + 60.0) if not closed_loop else duration
        end = self.runtime.run(requests, duration, horizon=horizon,
                               closed_loop=closed_loop)
        return decode_report(self.runtime.tokens_generated, max(end, 1e-9),
                             self.runtime.kv_timeline,
                             self.runtime.batch_timeline)
