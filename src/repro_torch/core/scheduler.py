"""The Staggered Batch Scheduler (SBS) main loop + immediate-dispatch
baselines (paper §4, Figure 5).

The scheduler is CLOCK-DRIVEN and ENGINE-AGNOSTIC: the driver is always
`repro.serving.runtime.ClusterRuntime`, over simulated engines (virtual
clock) or the real jitted-JAX engines of repro.serving.real_engine
(wall clock) — the scheduler cannot tell the difference.  It calls

    on_arrival(req, now)      when a request enters the system
    poll(now)                 -> list[DispatchCommand] to execute
    on_end_forward(ev)        when an engine finishes a forward pass
    next_event_time(now)      -> when poll() should next be called

SBS dual trigger (§ Fig 5): dispatch happens when BOTH
  (a) the adaptive interval I_opt has elapsed since the last dispatch, and
  (b) the round-robin target instance is ready (quiescent, signaled, or
      watchdog-reset — the multi-tier sync protocol).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.decode_alloc import (
    schedule_decode_batch, schedule_decode_global, schedule_decode_immediate,
)
from repro_torch.core.flow_control import FlowAction, FlowController
from repro_torch.core.interval import AdaptiveIntervalController
from repro_torch.core.prefill_alloc import chunk_utilization, pbaa
from repro_torch.core.prefix_cache import PrefixCacheIndex
from repro_torch.core.state import GlobalState
from repro_torch.core.sync import SyncProtocol
from repro_torch.core.types import (
    DispatchCommand, EndForward, Request, RequestPhase,
)


class PrefillScheduler:
    """Interface."""

    def on_arrival(self, req: Request, now: float) -> None:
        raise NotImplementedError

    def poll(self, now: float) -> List[DispatchCommand]:
        raise NotImplementedError

    def on_end_forward(self, ev: EndForward) -> None:
        raise NotImplementedError

    def next_event_time(self, now: float) -> Optional[float]:
        raise NotImplementedError


class StaggeredBatchScheduler(PrefillScheduler):
    def __init__(self, state: GlobalState, n_limit: int = 8,
                 cache_aware: bool = False,
                 prefix_cache: Optional[PrefixCacheIndex] = None,
                 watchdog_multiplier: float = 5.0,
                 bucket_size: int = 0, bucket_max_wait: int = 4):
        self.state = state
        self.sync = SyncProtocol(state.num_prefill_instances,
                                 watchdog_multiplier)
        self.flow = FlowController(n_limit)
        self.n_limit = n_limit
        self.cache = prefix_cache if cache_aware else None
        self.buffer: List[Request] = []     # scheduler-side queue (new)
        self.pending: List[Request] = []    # PBAA leftovers (legacy)
        self.rejected: List[Request] = []
        self._target = 0                    # round-robin instance cursor
        self._last_dispatch = -float("inf")
        self._starved = False               # no capacity: wait for feedback
        self.cycles = 0
        self.util_history: List[float] = []
        # length-bucketed batch formation (BucketServe-style): queued
        # prompts are grouped by padded-length class inside the SBS
        # buffering window and ONE class dispatches per cycle, so
        # co-batched prompts pad to near-equal lengths.  bucket_size=0
        # disables (seed behavior: the whole buffer dispatches).
        self.bucket_size = max(int(bucket_size), 0)
        self.bucket_max_wait = max(int(bucket_max_wait), 1)
        self._bucket_wait: Dict[int, int] = {}   # class -> starved cycles
        self.padding_tokens_wasted = 0      # pad-to-batch-max token waste
        self.bucket_dispatches = 0          # dispatches that were bucketed

    # ------------------------------------------------------------------
    def reset_clock(self) -> None:
        """A new driver run restarts its clock at 0: clear the time-gated
        dispatch state so stamps from a previous run's timeline cannot
        stall the staggered interval (called by ClusterRuntime.run)."""
        self._last_dispatch = -float("inf")

    def on_arrival(self, req: Request, now: float) -> None:
        req.phase = RequestPhase.QUEUED
        self.buffer.append(req)
        self._starved = False

    def on_end_forward(self, ev: EndForward) -> None:
        self.state.on_end_forward(ev)
        self.sync.on_end_forward(ev.instance_id, ev.timestamp,
                                 remaining=ev.remaining_tokens,
                                 t_est=self.state.interval.t_fwd)
        self._starved = False

    # ------------------------------------------------------------------
    def _interval_elapsed(self, now: float) -> bool:
        return now - self._last_dispatch >= self.state.interval.interval - 1e-12

    def poll(self, now: float) -> List[DispatchCommand]:
        cmds: List[DispatchCommand] = []
        # allow draining multiple ready instances in one poll (catch-up after
        # a long gap), but each dispatch advances the staggered clock.
        while ((self.buffer or self.pending) and not self._starved
               and self._interval_elapsed(now)):
            target = self._next_ready_instance(now)
            if target is None:
                self._starved = True     # all busy: wait for EndForward
                break
            cmd = self._dispatch_to(target, now)
            if cmd is None:
                self._starved = True     # no capacity anywhere: wait
                break
            cmds.append(cmd)
            self._last_dispatch = now
        return cmds

    def _next_ready_instance(self, now: float) -> Optional[int]:
        n = self.state.num_prefill_instances
        # chunked-prefill tails are pinned to the DP holding their KV —
        # prefer dispatching to instances with pinned pending work so long
        # requests don't wait a full round-robin cycle between chunks
        dp2inst = {d.dp_id: d.instance_id for d in self.state.prefill_dps}
        pinned = {dp2inst[r.assigned_dp] for r in self.pending
                  if r.assigned_dp is not None and r.assigned_dp in dp2inst}
        candidates = [i for i in range(n) if i in pinned] + \
            [(self._target + k) % n for k in range(n)]
        for inst in candidates:
            if self.sync.is_ready(inst, now):
                self._target = (inst + 1) % n
                return inst
        return None

    # -- length-bucketed batch formation --------------------------------
    def _length_class(self, req: Request) -> int:
        """Padded-length class: prompts in one class pad to at most one
        `bucket_size` of waste when co-batched."""
        return max((req.input_len + self.bucket_size - 1)
                   // self.bucket_size, 1)

    def _select_bucket(self) -> List[Request]:
        """Pick ONE length class from the buffer; hold the rest back.

        Starved-first: a class that sat unselected for more than
        `bucket_max_wait` dispatch cycles wins outright (oldest starvation
        first), otherwise the class with the most queued prompt tokens
        dispatches — the one whose padding savings matter most."""
        classes: Dict[int, List[Request]] = {}
        for r in self.buffer:
            classes.setdefault(self._length_class(r), []).append(r)
        # drop wait state of emptied classes
        self._bucket_wait = {c: w for c, w in self._bucket_wait.items()
                             if c in classes}
        starved = [c for c in classes
                   if self._bucket_wait.get(c, 0) >= self.bucket_max_wait]
        if starved:
            chosen = max(starved, key=lambda c: self._bucket_wait.get(c, 0))
        else:
            chosen = max(classes,
                         key=lambda c: sum(r.input_len for r in classes[c]))
        for c in classes:
            if c == chosen:
                self._bucket_wait[c] = 0
            else:
                self._bucket_wait[c] = self._bucket_wait.get(c, 0) + 1
        held = [r for c, lst in classes.items() if c != chosen for r in lst]
        self.buffer = held
        return classes[chosen]

    def _note_padding(self, reqs: List[Request]) -> None:
        """Pad-to-batch-max waste of the NEW prompts entering this
        dispatch (the BucketServe metric; FLOPs-priced by the cost
        model's `padding_flops_wasted`)."""
        lens = [r.input_len for r in reqs]
        if len(lens) > 1:
            top = max(lens)
            self.padding_tokens_wasted += sum(top - ln for ln in lens)

    def _dispatch_to(self, inst: int, now: float) -> Optional[DispatchCommand]:
        dps = self.state.prefill_dps_of(inst)
        if self.bucket_size and self.buffer:
            new = self._select_bucket()     # holds other classes back
            self.bucket_dispatches += 1
        else:
            new = self.buffer
            self.buffer = []
        self._note_padding(new)
        assignments, q_next, over = pbaa(
            self.pending, new, dps, n_limit=self.n_limit,
            cache=self.cache)
        self.cycles += 1
        self.util_history.append(chunk_utilization(assignments, dps))
        # flow control on over-limit requests (per-request outcomes:
        # admit_request resets the wait-cycle clock if the verdict is
        # ADMIT, so a request that got through restarts from zero on the
        # next pressure episode)
        kept: List[Request] = []
        for r in over:
            act = self.flow.admit_request(r)
            if act == FlowAction.REJECT:
                r.phase = RequestPhase.REJECTED
                self.rejected.append(r)
            else:
                kept.append(r)
        self.pending = q_next + kept
        if not assignments:
            return None
        for dp_id, lst in assignments.items():
            for req, tok in lst:
                req.phase = RequestPhase.DISPATCHED
                req.assigned_instance = inst
                if req.dispatch_time is None:
                    req.dispatch_time = now
                if self.cache is not None and req.tokens is not None:
                    done = req.input_len - req.remaining_prefill
                    self.cache.insert(dp_id, req.tokens[:done])
        self.sync.on_dispatch(inst, now, self.state.interval.t_fwd)
        return DispatchCommand(instance_id=inst, assignments=assignments,
                               issue_time=now)

    def next_event_time(self, now: float) -> Optional[float]:
        cands = []
        if (self.buffer or self.pending) and not self._starved:
            cands.append(max(now,
                             self._last_dispatch + self.state.interval.interval))
        wd = self.sync.next_watchdog_deadline(now)
        if wd is not None:
            cands.append(wd)
        return min(cands) if cands else None


class ImmediatePrefillScheduler(PrefillScheduler):
    """Baseline (§3.2): requests are bound to an instance the moment they
    arrive and pile up in the engine's device-side queue (HOL blocking).
    Policies: round_robin | least_tokens (least outstanding work)."""

    def __init__(self, state: GlobalState, policy: str = "round_robin"):
        self.state = state
        self.policy = policy
        self._rr = 0
        self._out: List[DispatchCommand] = []
        # outstanding tokens per instance (scheduler's naive view)
        self._outstanding: Dict[int, int] = {
            i: 0 for i in range(state.num_prefill_instances)}
        self._dp_rr: Dict[int, int] = {
            i: 0 for i in range(state.num_prefill_instances)}
        self.rejected: List[Request] = []
        self.util_history: List[float] = []

    def on_arrival(self, req: Request, now: float) -> None:
        if self.policy == "round_robin":
            inst = self._rr % self.state.num_prefill_instances
            self._rr += 1
        elif self.policy == "least_tokens":
            inst = min(self._outstanding, key=self._outstanding.get)
        else:
            raise ValueError(self.policy)
        dps = self.state.prefill_dps_of(inst)
        j = self._dp_rr[inst] % len(dps)
        self._dp_rr[inst] += 1
        dp = dps[j]
        req.phase = RequestPhase.DISPATCHED
        req.assigned_instance = inst
        req.assigned_dp = dp.dp_id
        req.dispatch_time = now
        self._outstanding[inst] += req.input_len
        dp.on_dispatch(req.input_len)
        req.remaining_prefill = 0   # whole request pushed to the device
        self._out.append(DispatchCommand(
            instance_id=inst,
            assignments={dp.dp_id: [(req, req.input_len)]},
            issue_time=now))

    def poll(self, now: float) -> List[DispatchCommand]:
        out, self._out = self._out, []
        return out

    def on_end_forward(self, ev: EndForward) -> None:
        self.state.on_end_forward(ev)
        self._outstanding[ev.instance_id] = max(
            0, self._outstanding[ev.instance_id] - ev.processed_tokens)

    def next_event_time(self, now: float) -> Optional[float]:
        return now if self._out else None


# ---------------------------------------------------------------------------
# Decode-phase schedulers
# ---------------------------------------------------------------------------

class DecodeScheduler:
    """SBS decode side: buffer hand-offs inside the batching window, then
    batched placement. mode='immediate' degrades to the paper's baseline
    policies.

    Two batched allocators:
      alloc='lex'        — IQR-aware lexicographical placement
                           (Algorithm 3, batch-size first)
      alloc='load_aware' — Load-Aware Global Allocation: per-DP KV-token
                           load balanced within AND across instances

    Watchdog re-dispatch: the driver reports step completions through
    `on_step_end`; an instance holding dispatched work that has not
    completed a step within `watchdog_multiplier`×(EWMA step time) is
    reported by `stalled_instances` and quarantined. The driver drains it
    and re-places the stranded requests via `place_redispatch`, which
    excludes quarantined instances. Quarantine lifts on a healthy step or
    after one further budget of probation (a drained instance receives no
    work, so the next placement is what re-probes its health). The budget
    is not enforced until at least one real step time has been observed.

    `prefix_cache`, when given, makes placement CACHE-AWARE: the
    scheduler tracks which prompts each decode DP has hosted (a
    token-level `PrefixCacheIndex`, the same reuse model the sim plane
    and the real engines' page binders share) and prefers the DP holding
    the longest cached prefix of a new request — tie-broken by
    ⟨kv_occupancy, batch⟩ — for both the batched allocators and the
    immediate baseline."""

    def __init__(self, state: GlobalState, mode: str = "sbs",
                 policy: str = "round_robin", iqr_k: float = 1.5,
                 window: float = 0.05, alloc: str = "lex",
                 watchdog_multiplier: float = 0.0,
                 prefix_cache: Optional[PrefixCacheIndex] = None,
                 bucket_size: int = 0):
        if alloc not in ("lex", "load_aware"):
            raise ValueError(alloc)
        self.state = state
        self.mode = mode
        self.policy = policy
        self.iqr_k = iqr_k
        self.window = window
        self.alloc = alloc
        self.cache = prefix_cache
        # bucketed pricing: >0 groups each window batch by padded-length
        # class and runs the allocator once per class (largest first), so
        # the lex/load-aware allocators price near-equal-length groups
        # instead of a raw mixed-length batch
        self.bucket_size = max(int(bucket_size), 0)
        self.buffer: List[Request] = []
        self._rr = [0]
        self._last = -float("inf")
        # watchdog state
        self.wd_mult = watchdog_multiplier
        self.quarantined: set = set()
        self._quarantined_at: Dict[int, float] = {}
        self._step_est = 0.05           # EWMA of observed step durations
        self._observed = False          # armed only after a real step time
        self._waiting_since: Dict[int, float] = {}   # inst -> oldest unacked
        self._last_step: Dict[int, float] = {}

    def reset_clock(self) -> None:
        """New driver run, clock restarts at 0 — drop time stamps taken
        on the previous run's timeline (batching-window gate, watchdog
        bookkeeping).  Quarantine/EWMA state is timeline-free and kept."""
        self._last = -float("inf")
        self._last_step.clear()
        self._waiting_since.clear()
        self._quarantined_at.clear()
        self.quarantined.clear()    # idle between runs: re-probe on place

    def _affinity(self, req: Request, unit) -> int:
        """Cached-prefix tokens of `req` resident on `unit` (0 = none)."""
        if self.cache is None or req.tokens is None:
            return 0
        return self.cache.match(unit.dp_id, req.tokens,
                                limit=req.input_len)

    def _note_placed(self, out: Optional[Dict]) -> None:
        """Track placements in the scheduler-side reuse model: the DP the
        request joins will hold its prompt's KV (real plane: published
        into the DP's page binder at join)."""
        if self.cache is None or not out:
            return
        for dp_id, reqs in out.items():
            for r in reqs:
                if r.tokens is not None:
                    self.cache.insert(dp_id, r.tokens[:r.input_len])

    def _allocate(self, batch: List[Request]) -> Dict:
        if self.bucket_size and len(batch) > 1:
            classes: Dict[int, List[Request]] = {}
            for r in batch:
                c = max((r.input_len + self.bucket_size - 1)
                        // self.bucket_size, 1)
                classes.setdefault(c, []).append(r)
            if len(classes) > 1:
                # largest class first: it moves the per-DP KV budgets the
                # most, and later (smaller) classes then pack around it
                out: Dict[int, List[Request]] = {}
                for c in sorted(classes, reverse=True):
                    placed = self._allocate_one(classes[c])
                    for dp_id, reqs in (placed or {}).items():
                        out.setdefault(dp_id, []).extend(reqs)
                return out
        return self._allocate_one(batch)

    def _allocate_one(self, batch: List[Request]) -> Dict:
        aff = self._affinity if self.cache is not None else None
        if self.alloc == "load_aware":
            out = schedule_decode_global(
                batch, self.state.decode_dps, self.iqr_k,
                exclude_instances=frozenset(self.quarantined),
                affinity=aff)
        else:
            units = [u for u in self.state.decode_dps
                     if u.instance_id not in self.quarantined]
            out = schedule_decode_batch(
                batch, units or self.state.decode_dps, self.iqr_k)
        self._note_placed(out)
        return out

    def on_handoff(self, req: Request, now: float) -> Optional[Dict]:
        """Prefill finished (KV arrived over the P/D transfer — simulated
        delay or real cache handoff); route into a decode DP. Immediate
        mode places right away, SBS buffers until the window tick."""
        if self.mode == "immediate":
            out = schedule_decode_immediate(
                [req], self.state.decode_dps, self.policy, self._rr,
                affinity=self._affinity if self.cache is not None else None)
            self._note_placed(out)
            return out
        self.buffer.append(req)
        return None

    def poll(self, now: float) -> Optional[Dict]:
        if self.mode == "immediate" or not self.buffer:
            return None
        if now - self._last < self.window - 1e-12:
            return None
        batch, self.buffer = self.buffer, []
        self._last = now
        return self._allocate(batch)

    def next_event_time(self, now: float) -> Optional[float]:
        cands = []
        if self.mode != "immediate" and self.buffer:
            cands.append(max(now, self._last + self.window))
        if self.wd_mult > 0 and self._observed:
            budget = self.wd_mult * max(self._step_est, 1e-6)
            # quarantined instances cannot trip again until they step, so
            # their deadlines must not generate (repeated, past-due) ticks
            pend = [t for i, t in self._waiting_since.items()
                    if i not in self.quarantined]
            if pend:
                cands.append(min(pend) + budget)
            if self._quarantined_at:        # probation expiry wake-up
                cands.append(min(self._quarantined_at.values()) + budget)
        return min(cands) if cands else None

    # -- watchdog / re-dispatch path ------------------------------------

    def on_placed(self, placements: Dict[int, List[Request]], now: float
                  ) -> None:
        """Driver ack: requests physically admitted to instances."""
        if self.wd_mult <= 0:
            return
        dp2inst = {d.dp_id: d.instance_id for d in self.state.decode_dps}
        for dp_id in placements:
            self._waiting_since.setdefault(dp2inst[dp_id], now)

    def on_step_end(self, instance_id: int, now: float,
                    step_time: Optional[float] = None) -> None:
        """`step_time` is the measured duration of the step that just
        finished (preferred); without it the inter-completion gap is used,
        which over-estimates on idle instances."""
        if step_time is None:
            prev = self._last_step.get(instance_id)
            step_time = now - prev if (prev is not None and now > prev) \
                else None
        if step_time is not None:
            if not self._observed:
                self._step_est = step_time     # snap to the first real sample
                self._observed = True
            else:
                self._step_est = 0.8 * self._step_est + 0.2 * step_time
        self._last_step[instance_id] = now
        self._waiting_since.pop(instance_id, None)
        self.quarantined.discard(instance_id)
        self._quarantined_at.pop(instance_id, None)

    def stalled_instances(self, now: float) -> List[int]:
        if self.wd_mult <= 0 or not self._observed:
            return []          # no budget until a real step time is known
        budget = self.wd_mult * max(self._step_est, 1e-6)
        # probation: a drained instance gets no work (it is excluded from
        # allocation), so it can never step itself healthy — re-admit it
        # after one further budget and let the next placement re-probe it
        for inst, since in list(self._quarantined_at.items()):
            if now - since >= budget - 1e-9:
                self.quarantined.discard(inst)
                self._quarantined_at.pop(inst, None)
        out = []
        for inst, since in list(self._waiting_since.items()):
            if now - since >= budget - 1e-9 and inst not in self.quarantined:
                self.quarantined.add(inst)
                self._quarantined_at[inst] = now
                self._waiting_since.pop(inst, None)
                out.append(inst)
        return out

    def place_redispatch(self, reqs: List[Request], now: float
                         ) -> Optional[Dict]:
        if not reqs:
            return None
        return self._allocate(list(reqs))
