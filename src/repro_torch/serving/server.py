"""Real-execution SBS server of the port: `ClusterRuntime` driving the
PyTorch engines in realtime (wall-clock) mode.

Counterpart of `repro/serving/server.py`, for the unified mixed-batch
plane (`ServingConfig(mixed_batch=True, block_size>0)`): a decode-pool-
only deployment of `RealUnifiedEngine`s, where chunked prefill rides the
same paged steps as decode and no KV handoff happens.  `immediate`,
`sbs` and `sbs-la` schedule it exactly as in the JAX server.  The P/D
deployment and the padded plane raise NotImplementedError naming the
ROADMAP item that will port them.

Build fresh Request objects per serve() call: progress fields are
mutated in place by a run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.flow_control import FlowController
from repro_torch.core.types import Request
from repro_torch.serving.cluster import build_decode_scheduler, build_state
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, RealUnifiedEngine,
)
from repro_torch.serving.runtime import ClusterRuntime


@dataclasses.dataclass
class Generation:
    rid: int
    tokens: List[int]
    ttft: float
    finish: float


class RealSBSServer:
    """SBS control plane over the port's unified engines.

    scheduler ∈ {sbs, sbs-la, immediate}: the decode pool's allocator —
    'sbs-la' is Load-Aware Global Allocation, 'immediate' the baseline.
    `device` places the KV pools (the params must already live there)."""

    def __init__(self, cfg: ModelConfig, params,
                 serving_cfg: ServingConfig,
                 scheduler: str = "sbs", max_len: int = 256,
                 max_new: int = 8,
                 watchdog_multiplier: float = 0.0,
                 spec: Optional[EngineSpec] = None,
                 prefix_cache: bool = False,
                 device: str = "cuda"):
        scfg = serving_cfg
        if not scfg.mixed_batch:
            raise NotImplementedError(
                "the P/D-separated deployment is not ported yet (ROADMAP "
                "Queue 1 item 6); use ServingConfig(mixed_batch=True)")
        if not scfg.block_size:
            raise NotImplementedError(
                "the padded plane is not ported yet (ROADMAP Queue 1 item "
                "7); set ServingConfig.block_size > 0")
        if prefix_cache:
            raise NotImplementedError(
                "page sharing is not ported yet (ROADMAP Queue 1 item 6)")
        if watchdog_multiplier:
            raise NotImplementedError(
                "the watchdog drains a busy instance, which the in-place "
                "pools of the port do not allow yet (see real_engine)")
        if scheduler not in ("sbs", "sbs-la", "immediate"):
            raise ValueError(scheduler)
        self.cfg = cfg
        self.scfg = scfg
        self.state = build_state(scfg)
        self.dsched = build_decode_scheduler(self.state, scfg, scheduler)
        # a spec may be shared across server instances over one model
        self.spec = spec or EngineSpec(
            cfg, params, max_len=max_len,
            max_batch=scfg.max_batch_per_dp, max_new=max_new,
            block_size=scfg.block_size,
            decode_slots=scfg.resolved_decode_slots, device=device)
        self.bus = KVHandoffBus()
        self.decode_engines = [
            RealUnifiedEngine(
                i, [d.dp_id for d in self.state.decode_dps_of(i)],
                self.spec, self.bus,
                chunk=scfg.resolved_mixed_chunk,
                starve_limit=scfg.prefill_starve_limit,
                piggyback=scfg.mixed_piggyback)
            for i in range(scfg.num_decode_instances)]
        flow = (FlowController(n_limit=scfg.n_limit,
                               backoff_base=scfg.flow_backoff)
                if scfg.flow_control else None)
        self.runtime = ClusterRuntime(
            self.state, prefill_sched=None, prefill_instances=None,
            decode_sched=self.dsched, decode_instances=self.decode_engines,
            transfer_time=None, realtime=True,
            flow=flow, preemption=scfg.preemption)

    def serve(self, requests: Sequence[Request], timeout: float = 120.0
              ) -> List[Generation]:
        for r in requests:
            if r.tokens is None or len(r.tokens) < r.input_len:
                raise ValueError(
                    f"request {r.rid}: the real plane needs `tokens` of "
                    f"length >= input_len")
            need = self.spec.lifetime_tokens(r)
            if need > self.spec.max_len:
                raise ValueError(
                    f"request {r.rid}: input_len + generated tokens "
                    f"({need}) exceed max_len={self.spec.max_len}")
        for e in self.decode_engines:
            e.start()
        try:
            self.runtime.run(requests, duration=timeout, horizon=timeout)
        finally:
            for e in self.decode_engines:
                e.stop()
            for e in self.decode_engines:
                e.join_worker(timeout=10)
        out: List[Generation] = []
        for r in requests:
            gen = self.bus.get(r.rid)
            if gen is None or r.finish_time is None:
                continue        # unfinished within the timeout
            out.append(Generation(
                rid=r.rid, tokens=list(gen.tokens),
                ttft=r.ttft if r.ttft is not None else float("nan"),
                finish=r.finish_time))
        return sorted(out, key=lambda g: g.rid)
