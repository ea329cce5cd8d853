"""Overload protection (Algorithm 2, phase 3).

When a request fails allocation for N_limit consecutive cycles the system is
saturated; the flow controller throttles (re-queue with backoff) or rejects,
preventing system-wide congestion collapse.

Two call sites consume the policy:

  * `StaggeredBatchScheduler._dispatch_to` — PBAA's phase-3 leftovers
    (requests unassigned for > N_limit prefill cycles).
  * `ClusterRuntime` admission control — arrivals while the decode pool
    is saturated are throttled (their arrival event re-enters the heap
    after `backoff(...)` seconds) and eventually rejected.

Stats are PER-REQUEST OUTCOMES, not per-cycle decisions: a request polled
for 8 cycles and then admitted counts once under `admitted`, never 8
times.  A request's outcome is its LATEST decision — throttled requests
that are later admitted migrate buckets.  Priority classes tighten the
reject horizon for less urgent work: priority 0 keeps the full
`n_limit × reject_after` budget, each step down the ladder sheds one
`reject_after` multiple (floor 1), so under sustained overload batch
traffic is rejected first and interactive traffic last.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class FlowAction(str, enum.Enum):
    ADMIT = "admit"
    THROTTLE = "throttle"
    REJECT = "reject"


@dataclasses.dataclass
class FlowControlStats:
    throttled: int = 0
    rejected: int = 0
    admitted: int = 0


class FlowController:
    """Two-level policy: first breach throttles (backoff + re-queue at the
    head, preserving FCFS), sustained breach rejects."""

    def __init__(self, n_limit: int = 8, reject_after: int = 3,
                 backoff_base: float = 0.05):
        self.n_limit = n_limit
        self.reject_after = reject_after
        self.backoff_base = backoff_base
        self._outcomes: Dict[int, FlowAction] = {}   # rid -> latest decision
        self._anon = FlowControlStats()              # rid-less legacy calls

    def _reject_cycles(self, priority: int) -> int:
        """Cycles before a priority class is rejected outright."""
        return self.n_limit * max(self.reject_after - max(priority, 0), 1)

    def decide(self, wait_cycles: int, rid: Optional[int] = None,
               priority: int = 0) -> FlowAction:
        """Policy decision for a request that has waited `wait_cycles`
        allocation cycles.  With `rid`, the decision is recorded as the
        request's (latest) outcome; without it the call is counted as an
        anonymous terminal event (legacy behaviour for callers that only
        probe the policy once per request)."""
        if wait_cycles <= self.n_limit:
            act = FlowAction.ADMIT
        elif wait_cycles <= self._reject_cycles(priority):
            act = FlowAction.THROTTLE
        else:
            act = FlowAction.REJECT
        if rid is not None:
            self._outcomes[rid] = act
        else:
            if act == FlowAction.ADMIT:
                self._anon.admitted += 1
            elif act == FlowAction.THROTTLE:
                self._anon.throttled += 1
            else:
                self._anon.rejected += 1
        return act

    def admit_request(self, req) -> FlowAction:
        """`decide` for a `Request`: the wait-cycle state RESETS on admit
        (the request got through — a later pressure episode starts its
        throttle clock from zero, instead of inheriting a stale counter
        that would reject it on first contact)."""
        act = self.decide(req.wait_cycles, rid=req.rid,
                          priority=req.priority)
        if act == FlowAction.ADMIT:
            req.wait_cycles = 0
        return act

    def gate(self, req, saturated: bool) -> FlowAction:
        """Runtime admission gate (arrival-time overload control).
        While `saturated`, the request is throttled IMMEDIATELY — no
        n_limit grace, since admitting into a saturated pool only
        deepens the queue — escalating to REJECT past its class's
        horizon.  Once pressure drops it admits and its wait state
        resets, so a later episode starts the clock from zero."""
        if not saturated:
            # unconditional: routing through `decide` would keep
            # throttling any request whose saturated-phase wait already
            # passed n_limit (wait_cycles never advances on this path —
            # a livelock, not a policy)
            self._outcomes[req.rid] = FlowAction.ADMIT
            req.wait_cycles = 0
            return FlowAction.ADMIT
        req.wait_cycles += 1
        act = (FlowAction.REJECT
               if req.wait_cycles > self._reject_cycles(req.priority)
               else FlowAction.THROTTLE)
        self._outcomes[req.rid] = act
        return act

    def backoff(self, wait_cycles: int) -> float:
        """Throttle re-queue delay: doubles per cycle past n_limit,
        capped at 32× the base."""
        excess = max(wait_cycles - self.n_limit, 0)
        return self.backoff_base * min(2 ** excess, 32)

    @property
    def stats(self) -> FlowControlStats:
        """Per-request terminal outcomes (latest decision per rid), plus
        any rid-less legacy decisions."""
        s = FlowControlStats(admitted=self._anon.admitted,
                             throttled=self._anon.throttled,
                             rejected=self._anon.rejected)
        for act in self._outcomes.values():
            if act == FlowAction.ADMIT:
                s.admitted += 1
            elif act == FlowAction.THROTTLE:
                s.throttled += 1
            else:
                s.rejected += 1
        return s
