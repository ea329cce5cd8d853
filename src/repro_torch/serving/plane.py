"""The EnginePlane contract — the single engine-facing interface behind
`ClusterRuntime`.

A *plane* is a scheduler plus a set of engine instances.  The runtime is
the only driver: it forwards scheduler decisions to the instances and
turns instance completions back into scheduler feedback.  Everything an
engine must expose to participate is defined here, and BOTH backends
satisfy it:

  simulated   SimPrefillInstance / SimDecodeInstance (serving.engine) —
              pass/step durations come from the roofline cost model and
              the runtime advances a virtual clock.
  real        RealPrefillEngine / RealDecodeEngine (serving.real_engine)
              — passes/steps are actual jitted JAX forwards executed on a
              worker thread; the runtime uses a wall clock
              (RealtimeEventLoop) and blocks until completions are
              posted.

The split point is the return value of `start_pass` / `start_step`:

  float    the pass/step will take this many (virtual) seconds — the
           runtime schedules the matching `pass_end` / `step_end` event
           on its heap (simulated plane).
  ASYNC    the pass/step was submitted to a worker thread — the engine
           will post `("pass_end", self)` / `("step_end", (self, epoch,
           dur))` to the runtime's realtime loop when the forwards
           complete (real plane).
  None     idle (no work, or a pass/step already in flight).

`finish_pass` / `finish_step` are ALWAYS called on the runtime thread, so
all scheduler-visible state mutation (Request bookkeeping, DecodeDPState
accounting, KV handoff publication) is single-threaded; worker threads
only run pure JAX computations on snapshots taken at submit time.

MESH-NATIVE REAL ENGINES: the same real classes become sharded when
their `EngineSpec` carries a `jax.sharding.Mesh` — per-DP state stays
Python-side, but each pass/step submits ONE cross-device XLA program
(params, merged paged cache, and batch rows sharded over the mesh's
"data" axis; MoE routed through the explicit EP all-to-all), so the
instance-level sync barrier this contract models is physically real.
All multi-device work of a deployment serializes behind the spec's mesh
lock — one device set, one collective program at a time (see
DESIGN.md "Sharded real plane").
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.types import DispatchCommand, EndForward, Request


class _Async:
    """Sentinel returned by real engines from start_pass/start_step."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<ASYNC>"


ASYNC = _Async()

#: what start_pass / start_step may return
StartResult = Union[float, _Async, None]


@dataclasses.dataclass
class PassResult:
    """Outcome of one prefill pass (sim and real)."""
    end_forwards: List[EndForward]
    completed: List[Request]      # prefill fully done at pass end
    processed_per_dp: Dict[int, int]


class PrefillEngine(abc.ABC):
    """One prefill instance: a non-preemptive discrete batch processor
    over its DP units (§3.2)."""

    instance_id: int
    dp_ids: List[int]

    @abc.abstractmethod
    def enqueue(self, cmd: DispatchCommand, now: float) -> None:
        """Accept a scheduler dispatch into the per-DP device queues."""

    @abc.abstractmethod
    def start_pass(self, now: float) -> StartResult:
        """Begin a forward pass over the queued work (see module doc)."""

    @abc.abstractmethod
    def finish_pass(self, now: float) -> PassResult:
        """Complete the pass begun by start_pass (runtime thread only)."""

    @abc.abstractmethod
    def has_work(self) -> bool:
        """Readiness probe: any queued tokens on any DP?"""

    @abc.abstractmethod
    def backlog(self, dp_id: int) -> int:
        """Backlog probe: queued tokens on one DP (EndForward payload)."""


class DecodeEngine(abc.ABC):
    """One decode instance: DP units step together behind the sync
    barrier; requests join on KV handoff and leave on completion.

    KV ACCOUNTING IS BLOCK-GRANULAR when the deployment pages its caches
    (ServingConfig.block_size > 0): the scheduler-side `DecodeDPState`
    tracks reserved blocks (`kv_blocks` / `kv_occupancy`) next to the
    exact token load, budgets and the `sbs-la` load balancer read
    `kv_occupancy`, and an engine admits a handed-off request only while
    its DP's free-BLOCK count covers the request's lifetime pages — not
    merely while a batch slot is free.  `free_kv_tokens` exposes that
    device-side headroom to drivers/diagnostics; padded engines report
    free slots × max_len."""

    instance_id: int
    dp_ids: List[int]
    epoch: int          # bumped by drain(); invalidates in-flight steps

    def free_kv_tokens(self, dp_id: int,
                       tokens: Optional[Sequence[int]] = None
                       ) -> Optional[int]:
        """Admission headroom of one DP in KV tokens (block-granular on
        paged engines); None when the backend has no physical cache (the
        cost-model sims — their capacity lives in DecodeDPState).  With
        `tokens` (a prospective request's prompt ids), page-sharing
        engines additionally credit the claimable block-aligned prefix
        already resident in the DP's binder — the same credit the
        dispatch-side `EngineBackedPrefixIndex` grants, so scheduler and
        engine agree on capacity under heavy sharing."""
        return None

    def preempt(self, rid: int) -> Optional[Request]:
        """Page-level preemption: swap ONE resident request out (park
        its KV + generation state for later re-join) and free its
        slot/pages.  Returns the request, or None when it is not
        resident or a step is in flight (the caller retries next
        cycle).  The caller owns releasing DecodeDPState accounting and
        re-admitting the victim through the normal join path."""
        return None

    def pending_waits(self) -> List[Request]:
        """Requests admitted by the scheduler but still waiting for
        device-side capacity (deferred joins).  Empty on backends that
        admit unconditionally (the cost-model sims)."""
        return []

    @abc.abstractmethod
    def admit(self, dp_id: int, req: Request) -> None:
        """Place a handed-off request onto one of this instance's DPs."""

    @abc.abstractmethod
    def start_step(self, dp_states: Sequence, now: Optional[float] = None
                   ) -> StartResult:
        """Begin one generation step over all running requests."""

    @abc.abstractmethod
    def finish_step(self, now: float, dp_states: Sequence) -> List[Request]:
        """Complete the step; returns the requests that finished."""

    @abc.abstractmethod
    def has_work(self) -> bool:
        """Readiness probe: any running (or pending-join) requests?"""

    @abc.abstractmethod
    def drain(self) -> Dict[int, List[Request]]:
        """Watchdog path: strip all resident work off this instance."""


class UnifiedEngine(DecodeEngine):
    """One UNIFIED mixed-batch instance: a decode engine that also owns
    its requests' chunked prefill, so prompts and decode rows share the
    same engine step (Sarathi-style piggybacking — the plane that kills
    the disjoint-loop decode stall).

    Contract deltas vs a plain DecodeEngine:

      * `admit` additionally accepts RAW requests (remaining_prefill >
        0, no published generation state).  The engine stages them as
        prefilling residents — KV pages reserved for the full lifetime
        up front — and runs their chunks out of the leftover per-step
        token budget (`chunk − decode_rows`) of the SAME forward the
        decode rows run in.  Completing the prompt emits the first
        token from inside the step; the request then graduates to the
        decode rows without any KV handoff (same pool, same DP).
      * STARVATION BOUND: when decode rows exhaust the budget for
        `starve_limit` consecutive steps while prefill is pending, the
        next step grants a minimum chunk regardless of decode load —
        prefill may lag, never be locked out.
      * A unified deployment runs DECODE-PLANE-ONLY under the runtime
        (`psched=None`): arrivals hand off directly to the decode
        scheduler, and `immediate`/`sbs`/`sbs-la` drive it unchanged.

    Both backends implement this: `SimUnifiedInstance` (cost-model
    clocked, `CostModel.mixed_step_time`) and `RealUnifiedEngine`
    (jitted `mixed_step`, paged cache only)."""

    def prefill_backlog(self) -> int:
        """Prompt tokens still to be prefilled across all DPs."""
        return 0
