"""ClusterRuntime — the single event loop behind every cluster topology
(paper §5 experiments) AND the real serving path.

Before this module the repo carried three separately implemented event
loops (`PrefillClusterSim`, `DecodeClusterSim`, `PDClusterSim`), each with
its own heap, poll-dedup and drain logic.  They are now thin configuration
wrappers over one runtime with pluggable planes (the EnginePlane contract,
repro.serving.plane):

  prefill plane   PrefillScheduler + PrefillEngine set
  decode plane    DecodeScheduler + DecodeEngine set
  handoff         optional prefill→decode coupling with a KV-transfer
                  latency function (the P/D-separated deployment)

Two clock sources drive the same loop:

  simulated  (realtime=False)  the default discrete-event mode: engines
             return pass/step *durations* from the cost model and the
             runtime advances a virtual clock along its heap.
  realtime   (realtime=True)   wall-clock mode for real engines
             (repro.serving.real_engine): engines return the ASYNC
             sentinel, execute jitted forwards on worker threads, and
             post completions to a RealtimeEventLoop; the runtime blocks
             in `next_event_time`-driven waits instead of busy-polling.

Event kinds on the shared heap:
  arrival      request enters the system (prefill plane, or decode plane
               directly when there is no prefill plane)
  pass_end     a prefill instance finished its non-preemptive pass
  kv_arrived   a prefill-completed request's KV cache landed on the
               decode pool (after the ICI/DCN transfer)
  step_end     a decode instance finished one generation step
  tick         scheduler-requested wake-up (staggered interval, decode
               batching window, watchdog deadline)

The runtime also owns the decode watchdog re-dispatch path: when the
decode scheduler reports a stalled instance (dispatched work but no step
completion within its watchdog budget), the instance is drained, its KV
accounting is released, and the stranded requests are re-placed on the
healthy instances through the scheduler's load-aware allocator.

SLO-aware overload control (both opt-in, see ServingConfig):

  admission   a `FlowController` gates arrivals: while the decode pool is
              saturated (every DP at its batch or KV budget) new arrivals
              are throttled — their arrival event re-enters the heap
              after a backoff — and, past their priority class's horizon,
              rejected outright (phase REJECTED, counted as settled).
  preemption  page-level swap-out: when lower-priority residents crowd
              out more urgent work (a deferred engine join on the real
              plane, a unit over its KV budget on the sim plane), victims
              chosen by `select_victims` are preempted — their KV parks
              on the handoff bus with generation state intact — their
              DPState accounting is released, and they re-enter through
              the scheduler's re-dispatch allocator exactly like
              watchdog-drained work.  Strictly-lower-priority-only
              eviction keeps the policy cycle-free; `max_preemptions`
              bounds per-request thrash.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.decode_alloc import kv_footprint, select_victims
from repro_torch.core.flow_control import FlowAction, FlowController
from repro_torch.core.types import Request, RequestPhase
from repro_torch.serving.plane import ASYNC, DecodeEngine, PrefillEngine


class EventLoop:
    """Heap of (time, seq, kind, payload); seq breaks ties FIFO."""

    def __init__(self):
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def pop(self):
        return heapq.heappop(self._heap)

    def __bool__(self):
        return bool(self._heap)


class RealtimeEventLoop(EventLoop):
    """Wall-clock event loop.  Heap times are seconds relative to loop
    start; engine worker threads deliver completions through `post`.
    `pop_wait` sleeps until the earlier of (next timed event, next posted
    completion) — the blocking replacement for the old server busy-wait."""

    def __init__(self):
        super().__init__()
        self._ext: "queue.Queue[Tuple[str, object]]" = queue.Queue()
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def post(self, kind: str, payload=None) -> None:
        """Thread-safe completion delivery (engine worker threads)."""
        self._ext.put((kind, payload))

    def pop_wait(self, horizon: float, blocked: bool
                 ) -> Optional[Tuple[float, int, str, object]]:
        """Next event, or None when nothing can ever arrive (idle and no
        in-flight work) or the horizon passed.  `blocked` marks in-flight
        async work whose completion is worth waiting for."""
        while True:
            try:
                kind, payload = self._ext.get_nowait()
                return (self.now(), -1, kind, payload)
            except queue.Empty:
                pass
            now = self.now()
            if now > horizon:
                return None
            if self._heap:
                delay = self._heap[0][0] - now
                if delay <= 0:
                    t, s, k, p = heapq.heappop(self._heap)
                    return (max(t, now), s, k, p)
                wait = min(delay, horizon - now)
            elif blocked:
                wait = horizon - now
            else:
                return None
            try:
                kind, payload = self._ext.get(timeout=max(wait, 0.0))
                return (self.now(), -1, kind, payload)
            except queue.Empty:
                continue


class ClusterRuntime:
    def __init__(
        self,
        state,
        *,
        prefill_sched=None,
        prefill_instances: Optional[Sequence[PrefillEngine]] = None,
        decode_sched=None,
        decode_instances: Optional[Sequence[DecodeEngine]] = None,
        transfer_time=None,            # callable(Request) -> seconds
        snapshot_every: int = 0,
        realtime: bool = False,
        flow: Optional[FlowController] = None,
        preemption: bool = False,
        max_preemptions: int = 2,
        readmit_frac: float = 0.7,
    ):
        if prefill_sched is None and decode_sched is None:
            raise ValueError("runtime needs at least one plane")
        self.state = state
        self.psched = prefill_sched
        self.prefill = list(prefill_instances or [])
        self.dsched = decode_sched
        self.decode = list(decode_instances or [])
        self.transfer_time = transfer_time
        self.snapshot_every = snapshot_every
        self.realtime = realtime
        self._dp2dinst = {d.dp_id: d.instance_id
                          for d in state.decode_dps} if self.decode else {}
        self._pass_start: Dict[int, float] = {}
        self._next_tick: Optional[float] = None
        self._inflight = 0      # async passes/steps outstanding (realtime)
        # decode observability (Fig 7/8 timelines)
        self.kv_timeline: List[List[int]] = []
        self.batch_timeline: List[List[int]] = []
        self.redispatched: List[Request] = []
        self._steps = 0
        # SLO-aware overload control (opt-in)
        self.flow = flow
        self.preemption = preemption
        self.max_preemptions = max_preemptions
        self.readmit_frac = readmit_frac
        self.preempted: List[Request] = []      # every swap-out event
        self.rejected: List[Request] = []       # flow-control rejections
        self._parked: List[Request] = []        # swapped out, awaiting room

    # -- helpers -----------------------------------------------------------

    def _schedule_tick(self, ev: EventLoop, t: Optional[float],
                       now: float):
        """Dedup: keep only the earliest pending tick; later wake-ups are
        re-derived from next_event_time() once that tick fires.  A tick at
        (or before) `now` is dropped — the drive section already polled at
        `now`, so re-ticking the same instant cannot make progress and
        would livelock the loop."""
        if t is None or t <= now + 1e-12:
            return
        if self._next_tick is None or t < self._next_tick - 1e-12:
            self._next_tick = t
            ev.push(t, "tick", None)

    def _place(self, placements: Optional[Dict[int, List[Request]]],
               now: float):
        if not placements:
            return
        for dp_id, reqs in placements.items():
            inst = self.decode[self._dp2dinst[dp_id]]
            for r in reqs:
                inst.admit(dp_id, r)
        if self.dsched is not None and hasattr(self.dsched, "on_placed"):
            self.dsched.on_placed(placements, now)

    def _handoff(self, req: Request, now: float):
        """Request enters the decode plane (fresh arrival or KV arrival).

        In the cost-model sim the decode plane emits every token, so the
        provisional prefill-completion stamp is cleared and TTFT lands on
        the first decode step.  On the real plane the first token was
        PHYSICALLY produced by the prefill engine (req.generated == 1 at
        handoff) — that stamp is the true TTFT and must survive."""
        if self.psched is not None and req.generated == 0:
            req.first_token_time = None      # sim: TTFT is set by decode
        req.phase = RequestPhase.DECODING
        self._place(self.dsched.on_handoff(req, now), now)

    def _snapshot(self):
        if self.snapshot_every and self._steps % self.snapshot_every == 0:
            self.kv_timeline.append(
                [d.kv_tokens for d in self.state.decode_dps])
            self.batch_timeline.append(
                [d.batch for d in self.state.decode_dps])

    def _redispatch_stalled(self, now: float):
        """Watchdog path: pull stranded work off wedged decode instances
        and re-place it on healthy ones."""
        if self.dsched is None or not hasattr(self.dsched,
                                              "stalled_instances"):
            return None
        stalled = self.dsched.stalled_instances(now)
        if not stalled:
            return None
        by_id = {d.dp_id: d for d in self.state.decode_dps}
        orphans: List[Request] = []
        for iid in stalled:
            drained = self.decode[iid].drain()
            for dp_id, reqs in drained.items():
                st = by_id[dp_id]
                for r in reqs:
                    st.release(r.input_len + r.generated,
                               reserve_len=r.input_len + r.output_len)
                    r.assigned_dp = None
                    r.migrations += 1
                    orphans.append(r)
        if orphans:
            self.redispatched.extend(orphans)
            return self.dsched.place_redispatch(orphans, now)
        return None

    def _decode_saturated(self) -> bool:
        """Admission-gate predicate: every decode DP is at its batch cap
        or KV budget — there is nowhere to put new work."""
        dps = self.state.decode_dps
        if not dps:
            return False
        return all(d.batch >= d.max_batch or d.kv_occupancy >= d.kv_budget
                   for d in dps)

    def _preempt_pressure(self, now: float):
        """SLO-aware preemption: free capacity for more urgent waiters by
        swapping strictly-lower-priority residents out.

        Two pressure signals, one victim policy (`select_victims`):
          real plane   `pending_waits()` — a scheduler-admitted join the
                       engine has deferred for device-side capacity; the
                       waiter's own priority bounds who may be evicted.
          sim plane    a DP over its KV budget (the cost-model engines
                       admit unconditionally); the most urgent resident
                       class bounds eviction.
        Victims are released from DPState accounting (exactly the
        watchdog-drain bookkeeping) and PARKED — the swap-to-host model:
        their KV leaves the device (on the real plane it rides the
        handoff bus and re-joins dense with generation state intact) and
        `_readmit_parked` returns them through the scheduler's
        re-dispatch allocator once a DP can hold them within budget."""
        if self.dsched is None or not self.decode:
            return None
        by_id = {d.dp_id: d for d in self.state.decode_dps}
        bs = getattr(self.state, "block_size", 0) or 0
        victims: List[Request] = []
        for inst in self.decode:
            for waiter in sorted(inst.pending_waits(),
                                 key=lambda r: (r.priority, r.arrival_time)):
                dp_id = waiter.assigned_dp
                if dp_id is None:
                    continue
                need = kv_footprint(waiter, bs)
                free = inst.free_kv_tokens(dp_id, tokens=waiter.tokens)
                if free is not None:
                    need -= free
                if need <= 0:
                    continue        # capacity already there; join retries
                residents = [r for r in inst.running.get(dp_id, [])
                             if r.preemptions < self.max_preemptions]
                for v in select_victims(residents, need, bs,
                                        max_priority=waiter.priority):
                    got = inst.preempt(v.rid)
                    if got is None:
                        break       # step in flight — retry next event
                    victims.append(got)
            for dp_id in inst.dp_ids:
                st = by_id[dp_id]
                over = st.kv_occupancy - st.kv_budget
                if over <= 0:
                    continue
                residents = [r for r in inst.running.get(dp_id, [])
                             if r.preemptions < self.max_preemptions]
                if not residents:
                    continue
                top = min(r.priority for r in residents)
                for v in select_victims(residents, over, bs,
                                        max_priority=top):
                    got = inst.preempt(v.rid)
                    if got is None:
                        break
                    victims.append(got)
        if not victims:
            return
        for r in victims:
            st = by_id[r.assigned_dp]
            st.release(r.input_len + r.generated,
                       reserve_len=r.input_len + r.output_len)
            r.assigned_dp = None
            r.preemptions += 1
            r.phase = RequestPhase.PREEMPTED
        self.preempted.extend(victims)
        self._parked.extend(victims)

    def _readmit_parked(self, now: float):
        """Re-admit parked (swapped-out) requests once pressure drops: a
        parked request re-enters — most urgent first — when some DP can
        hold its whole KV footprint within `readmit_frac` of its budget.
        The fraction is hysteresis: re-admitting the moment occupancy
        dips under 100% puts the victim straight back into the pressure
        that evicted it (swap thrash); waiting for real headroom lets
        the spike pass.  Placement goes through the scheduler's
        re-dispatch allocator, i.e. the normal join path."""
        if not self._parked:
            return None
        bs = getattr(self.state, "block_size", 0) or 0
        self._parked.sort(key=lambda r: (r.priority, r.arrival_time))
        ready: List[Request] = []
        kept: List[Request] = []
        for r in self._parked:
            foot = kv_footprint(r, bs)
            if any(d.batch < d.max_batch
                   and d.kv_occupancy + foot <= d.kv_budget
                   * self.readmit_frac
                   for d in self.state.decode_dps):
                ready.append(r)
            else:
                kept.append(r)
        if not ready:
            return None
        self._parked = kept
        placements = self.dsched.place_redispatch(ready, now)
        if placements:
            for reqs in placements.values():
                for r in reqs:
                    r.phase = RequestPhase.DECODING
        return placements

    def _all_settled(self, template: Sequence[Request]) -> bool:
        return all(r.finish_time is not None
                   or r.phase == RequestPhase.REJECTED for r in template)

    # -- the loop ----------------------------------------------------------

    def run(self, requests: Sequence[Request], duration: float, *,
            horizon: Optional[float] = None, closed_loop: int = 0) -> float:
        """Drive all planes until the heap drains or `horizon` passes.
        Returns the final clock (virtual seconds, or wall seconds since
        loop start in realtime mode).  `closed_loop` (decode-only mode)
        holds that many concurrent requests: each finish admits the next
        from the template list (paper §5.2.2)."""
        ev = RealtimeEventLoop() if self.realtime else EventLoop()
        if self.realtime:
            for inst in itertools.chain(self.prefill, self.decode):
                if hasattr(inst, "bind_loop"):
                    inst.bind_loop(ev)
        self._next_tick = None
        self._inflight = 0
        for sched in (self.psched, self.dsched):
            if sched is not None and hasattr(sched, "reset_clock"):
                sched.reset_clock()     # this run's clock starts at 0
        template = list(requests)
        pool: Iterator[Request] = iter(())
        if closed_loop:
            n0 = min(len(template), closed_loop)
            pool = iter(template[n0:])
            for r in template[:n0]:
                r.arrival_time = 0.0
                ev.push(0.0, "arrival", r)
        else:
            for r in template:
                ev.push(r.arrival_time, "arrival", r)
        now = 0.0
        if horizon is None:
            horizon = duration * 20 + 60.0
        while True:
            if self.realtime:
                item = ev.pop_wait(horizon, blocked=self._inflight > 0)
                if item is None:
                    break
            else:
                if not ev:
                    break
                item = ev.pop()
            now, _, kind, payload = item
            if now > horizon:
                break
            if kind == "arrival":
                req: Request = payload
                act = FlowAction.ADMIT
                if self.flow is not None and self.decode:
                    act = self.flow.gate(req, self._decode_saturated())
                if act == FlowAction.THROTTLE:
                    ev.push(now + self.flow.backoff(req.wait_cycles),
                            "arrival", req)
                elif act == FlowAction.REJECT:
                    req.phase = RequestPhase.REJECTED
                    self.rejected.append(req)
                elif self.psched is not None:
                    self.psched.on_arrival(req, now)
                else:
                    self._handoff(req, now)
            elif kind == "pass_end":
                inst: PrefillEngine = payload
                if self.realtime:
                    self._inflight -= 1
                start = self._pass_start.pop(inst.instance_id)
                res = inst.finish_pass(now)
                for e in res.end_forwards:
                    e.exec_time = now - start
                    self.psched.on_end_forward(e)
                if self.dsched is not None:
                    for req in res.completed:
                        delay = (self.transfer_time(req)
                                 if self.transfer_time else 0.0)
                        ev.push(now + delay, "kv_arrived", req)
            elif kind == "kv_arrived":
                self._handoff(payload, now)
            elif kind == "step_end":
                dinst, epoch, step_dur = payload
                if self.realtime:
                    self._inflight -= 1
                if epoch != dinst.epoch:
                    pass        # stale: the instance was drained mid-step
                else:
                    done = dinst.finish_step(now, self.state.decode_dps)
                    if self.dsched is not None and hasattr(self.dsched,
                                                           "on_step_end"):
                        self.dsched.on_step_end(dinst.instance_id, now,
                                                step_time=step_dur)
                    if closed_loop:
                        for _ in done:
                            nxt = next(pool, None)
                            if nxt is not None:
                                nxt.arrival_time = now
                                ev.push(now, "arrival", nxt)
                    self._steps += 1
                    self._snapshot()
            elif kind == "tick":
                if (self._next_tick is not None
                        and now >= self._next_tick - 1e-9):
                    self._next_tick = None
            # drive every plane after any event ----------------------------
            if self.psched is not None:
                for cmd in self.psched.poll(now):
                    self.prefill[cmd.instance_id].enqueue(cmd, now)
                for inst in self.prefill:
                    dur = inst.start_pass(now)
                    if dur is ASYNC:
                        self._pass_start[inst.instance_id] = now
                        self._inflight += 1
                    elif dur is not None:
                        self._pass_start[inst.instance_id] = now
                        ev.push(now + dur, "pass_end", inst)
            if self.dsched is not None:
                self._place(self.dsched.poll(now), now)
                self._place(self._redispatch_stalled(now), now)
                if self.preemption:
                    self._place(self._readmit_parked(now), now)
                    self._preempt_pressure(now)
                for dinst in self.decode:
                    dur = dinst.start_step(self.state.decode_dps, now)
                    if dur is ASYNC:
                        self._inflight += 1
                    elif dur is not None:
                        ev.push(now + dur, "step_end",
                                (dinst, dinst.epoch, dur))
            # wake-ups -----------------------------------------------------
            for sched in (self.psched, self.dsched):
                if sched is not None:
                    self._schedule_tick(ev, sched.next_event_time(now), now)
            # realtime early exit: every request settled — don't sleep out
            # residual ticks
            if (self.realtime and not closed_loop and template
                    and self._inflight == 0 and self._all_settled(template)):
                break
        return now

    # -- aggregate stats ---------------------------------------------------

    @property
    def prefill_util(self) -> float:
        return (sum(i.tokens_processed for i in self.prefill)
                / max(sum(i.capacity_offered for i in self.prefill), 1))

    @property
    def tokens_generated(self) -> int:
        return sum(i.tokens_generated for i in self.decode)
