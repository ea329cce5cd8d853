"""Real-execution SBS server of the port: `ClusterRuntime` driving the
PyTorch engines in realtime (wall-clock) mode.

Counterpart of `repro/serving/server.py`, for two deployments:

  P/D-separated (`ServingConfig(mixed_batch=False)`, the paper's)
      `RealPrefillEngine`s run true chunked prefill into per-request
      dense caches and hand each finished cache, with its first token,
      over the `KVHandoffBus` (priced at `l_net` on the runtime heap) to
      `RealDecodeEngine`s, which decode over the padded plane
      (`block_size=0`: dense max_len rows, a ring for SWA models, per-row
      SSM and conv state for SSM layers) or the paged plane
      (`block_size>0`: block-table pools, attention-only models).
  unified mixed-batch (`mixed_batch=True`, paged only)
      a decode-pool-only deployment of `RealUnifiedEngine`s, where
      chunked prefill rides the same paged steps as decode and no KV
      handoff happens.  An SSM config raises ValueError there, as in
      JAX: its state has no page form.

`immediate`, `sbs` and `sbs-la` schedule both exactly as in the JAX
server, and `watchdog_multiplier > 0` arms the decode watchdog (a drain
waits for the in-flight step, see `real_engine`).  `prefix_cache=True`
(page sharing, with page-native prefill) raises NotImplementedError
naming the ROADMAP item that will port it.

Build fresh Request objects per serve() call: progress fields are
mutated in place by a run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.flow_control import FlowController
from repro_torch.core.types import Request
from repro_torch.serving.cluster import (
    build_decode_scheduler, build_prefill_scheduler, build_state,
)
from repro_torch.serving.real_engine import (
    EngineSpec, KVHandoffBus, RealDecodeEngine, RealPrefillEngine,
    RealUnifiedEngine,
)
from repro_torch.serving.runtime import ClusterRuntime


@dataclasses.dataclass
class Generation:
    rid: int
    tokens: List[int]
    ttft: float
    finish: float


def _default_serving_config() -> ServingConfig:
    return ServingConfig(
        num_prefill_instances=2, prefill_dp_per_instance=2,
        num_decode_instances=1, decode_dp_per_instance=2,
        chunk_size=32, t_default=0.05, l_net=0.001,
        max_batch_per_dp=8)


class RealSBSServer:
    """SBS control plane over the port's real engines.

    scheduler ∈ {sbs, sbs-la, immediate}: identical meaning to the JAX
    server — 'sbs-la' keeps SBS prefill dispatch and switches the decode
    pool to Load-Aware Global Allocation; 'immediate' is the baseline on
    both phases.  `device` places the caches (the params must already
    live there)."""

    def __init__(self, cfg: ModelConfig, params,
                 serving_cfg: Optional[ServingConfig] = None,
                 scheduler: str = "sbs", max_len: int = 256,
                 max_new: int = 8,
                 watchdog_multiplier: float = 0.0,
                 spec: Optional[EngineSpec] = None,
                 prefix_cache: bool = False,
                 device: str = "cuda"):
        scfg = serving_cfg or _default_serving_config()
        if prefix_cache:
            raise NotImplementedError(
                "page sharing is not ported yet (ROADMAP Queue 1 item 6)")
        if scheduler not in ("sbs", "sbs-la", "immediate"):
            raise ValueError(scheduler)
        if scfg.mixed_batch and not scfg.block_size:
            raise ValueError(
                "mixed_batch=True needs a paged deployment "
                "(ServingConfig.block_size > 0)")
        self.cfg = cfg
        self.scfg = scfg
        self.state = build_state(scfg)
        if scfg.mixed_batch:
            # unified plane: no prefill engines, no KV handoff
            self.sched = None
        else:
            self.sched = build_prefill_scheduler(
                self.state, scfg,
                "immediate-rr" if scheduler == "immediate" else "sbs")
        self.dsched = build_decode_scheduler(
            self.state, scfg, scheduler,
            watchdog_multiplier=watchdog_multiplier)
        # a spec may be shared across server instances over one model
        self.spec = spec or EngineSpec(
            cfg, params, max_len=max_len,
            max_batch=scfg.max_batch_per_dp, max_new=max_new,
            block_size=scfg.block_size,
            decode_slots=(scfg.resolved_decode_slots
                          if scfg.block_size else 0),
            device=device)
        self.bus = KVHandoffBus()
        self.engines = [] if scfg.mixed_batch else [
            RealPrefillEngine(
                i, [d.dp_id for d in self.state.prefill_dps_of(i)],
                scfg.chunk_size, self.spec, self.bus)
            for i in range(scfg.num_prefill_instances)]
        if scfg.mixed_batch:
            self.decode_engines = [
                RealUnifiedEngine(
                    i, [d.dp_id for d in self.state.decode_dps_of(i)],
                    self.spec, self.bus,
                    chunk=scfg.resolved_mixed_chunk,
                    starve_limit=scfg.prefill_starve_limit,
                    piggyback=scfg.mixed_piggyback)
                for i in range(scfg.num_decode_instances)]
        else:
            self.decode_engines = [
                RealDecodeEngine(
                    i, [d.dp_id for d in self.state.decode_dps_of(i)],
                    self.spec, self.bus)
                for i in range(scfg.num_decode_instances)]
        flow = (FlowController(n_limit=scfg.n_limit,
                               backoff_base=scfg.flow_backoff)
                if scfg.flow_control else None)
        self.runtime = ClusterRuntime(
            self.state, prefill_sched=self.sched,
            prefill_instances=self.engines or None,
            decode_sched=self.dsched, decode_instances=self.decode_engines,
            transfer_time=(None if scfg.mixed_batch
                           else lambda r: scfg.l_net),  # P/D transfer
            realtime=True,
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
        workers = [*self.engines, *self.decode_engines]
        for e in workers:
            e.start()
        try:
            self.runtime.run(requests, duration=timeout, horizon=timeout)
        finally:
            for e in workers:
                e.stop()
            for e in workers:
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
