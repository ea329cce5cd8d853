"""Real-execution SBS server of the port: `ClusterRuntime` driving the
PyTorch engines in realtime (wall-clock) mode.

Counterpart of `repro/serving/server.py`, for two deployments:

  P/D-separated (`ServingConfig(mixed_batch=False)`, the paper's)
      `RealPrefillEngine`s run true chunked prefill into per-request
      dense caches (or, with `prefix_cache=True`, straight into pool
      pages) and hand each finished cache or `PageHandoff`, with its
      first token, over the `KVHandoffBus` (priced at `l_net` on the
      runtime heap) to `RealDecodeEngine`s, which decode over the padded
      plane (`block_size=0`: dense max_len rows, a ring for SWA models,
      per-row SSM and conv state for SSM layers) or the paged plane
      (`block_size>0`: block-table pools for the attention layers; a
      hybrid's SSM layers keep per-slot state beside them).
  unified mixed-batch (`mixed_batch=True`, paged only)
      a decode-pool-only deployment of `RealUnifiedEngine`s, where
      chunked prefill rides the same paged steps as decode and no KV
      handoff happens.  An SSM or hybrid config raises ValueError
      there, as in JAX: page-native prefill is attention-only.

`immediate`, `sbs` and `sbs-la` schedule both exactly as in the JAX
server, and `watchdog_multiplier > 0` arms the decode watchdog (a drain
waits for the in-flight step, see `real_engine`).  `prefix_cache=True`
turns on block-granular prefix reuse, as in the JAX server: page-native
prefill engines whose binders let a cached prefix's chunks be skipped
(under `sbs`/`sbs-la`), per-decode-DP binders with eager copy-on-write,
and cache-aware placement; it needs a paged deployment of an
attention-only model (ValueError otherwise).  `prefix_stats()` reads the
engines' reuse counters.

`mesh` (an `EngineMesh`, `repro_torch.launch.mesh.make_engine_mesh`)
makes the deployment SHARDED, as in the JAX server (paged only): each
decode instance merges its DP units' rows into one cache held as one
shard per data rank of the mesh, every step is one cross-DP step with
the EP all-to-all in each MoE layer, and the mesh's data size must equal
`decode_dp_per_instance` (ValueError otherwise).  Its steps replay CUDA
graphs as every spec's do (one graph a step where the shards share a
card, one a card between the moves that cross cards otherwise), and its
device is the mesh's lead device.

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
from repro_torch.serving.page_share import EngineBackedPrefixIndex
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
    live there); with a `mesh`, the mesh's lead device does."""

    def __init__(self, cfg: ModelConfig, params,
                 serving_cfg: Optional[ServingConfig] = None,
                 scheduler: str = "sbs", max_len: int = 256,
                 max_new: int = 8,
                 watchdog_multiplier: float = 0.0,
                 spec: Optional[EngineSpec] = None,
                 prefix_cache: bool = False,
                 device: str = "cuda", mesh=None):
        scfg = serving_cfg or _default_serving_config()
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
            watchdog_multiplier=watchdog_multiplier,
            cache_aware=True if prefix_cache else None)
        # a spec may be shared across server instances over one model;
        # `mesh` turns the deployment SHARDED (see the module docstring)
        self.spec = spec or EngineSpec(
            cfg, params, max_len=max_len,
            max_batch=scfg.max_batch_per_dp, max_new=max_new,
            block_size=scfg.block_size,
            decode_slots=(scfg.resolved_decode_slots
                          if scfg.block_size else 0),
            device=device, mesh=mesh)
        # prefix_cache turns on block-granular prefix reuse end to end:
        # page-native prefill engines with shared refcounted pages (a
        # cached prefix's chunks are never computed), PageHandoff
        # transfers, per-decode-DP binders with eager COW, and cache-
        # aware placement on BOTH schedulers.  Prefill-side claiming
        # needs the credit-granting PBAA path, so the `immediate`
        # baseline shares pages only on the decode side.
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and not self.spec.prefix_sharable:
            raise ValueError(
                "prefix_cache=True needs a paged deployment "
                "(ServingConfig.block_size > 0) and an attention-only "
                "decoder-only model config")
        share_prefill = (self.prefix_cache and not scfg.mixed_batch
                         and scheduler in ("sbs", "sbs-la"))
        self.bus = KVHandoffBus()
        self.engines = [] if scfg.mixed_batch else [
            RealPrefillEngine(
                i, [d.dp_id for d in self.state.prefill_dps_of(i)],
                scfg.chunk_size, self.spec, self.bus,
                page_native=self.prefix_cache,
                share_prefix=share_prefill)
            for i in range(scfg.num_prefill_instances)]
        if share_prefill:
            # cache-aware PBAA must credit EXACTLY what the engines will
            # claim: swap the scheduler's simulated index for a view over
            # the real page binders (insert is engine-owned, a no-op here)
            binder_of = {}
            for i, eng in enumerate(self.engines):
                for d in self.state.prefill_dps_of(i):
                    binder_of[d.dp_id] = eng.binder
            self.sched.cache = EngineBackedPrefixIndex(binder_of)
        if scfg.mixed_batch:
            self.decode_engines = [
                RealUnifiedEngine(
                    i, [d.dp_id for d in self.state.decode_dps_of(i)],
                    self.spec, self.bus,
                    chunk=scfg.resolved_mixed_chunk,
                    starve_limit=scfg.prefill_starve_limit,
                    piggyback=scfg.mixed_piggyback,
                    share_prefix=self.prefix_cache)
                for i in range(scfg.num_decode_instances)]
        else:
            self.decode_engines = [
                RealDecodeEngine(
                    i, [d.dp_id for d in self.state.decode_dps_of(i)],
                    self.spec, self.bus, share_prefix=self.prefix_cache)
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

    def prefix_stats(self) -> dict:
        """Engine-truth reuse counters (all zero when prefix_cache=False):
        prefill hit tokens/rate and skipped full prompts, decode pages
        shared at join and eager COW copies."""
        hit = sum(e.binder.hit_tokens for e in self.engines
                  if e.binder is not None)
        seen = sum(e.binder.seen_tokens for e in self.engines
                   if e.binder is not None)
        return {
            "prefix_hit_tokens": hit,
            "prefix_seen_tokens": seen,
            "prefix_hit_rate": hit / seen if seen else 0.0,
            "prefill_full_hits": sum(e.full_hits for e in self.engines),
            "prefill_chunks_run": sum(e.chunks_run for e in self.engines),
            "decode_blocks_shared": sum(e.blocks_shared
                                        for e in self.decode_engines),
            "decode_cow_copies": sum(e.cow_copies
                                     for e in self.decode_engines),
        }
