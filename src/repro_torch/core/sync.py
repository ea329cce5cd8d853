"""§4.1.2 — Multi-tier (Robust) State Synchronization Protocol.

Triple-check readiness:
  1. Quiescence polling  (init path)  — zero task depth => ready.
  2. EndForward signal   (fast path)  — event-driven readiness.
  3. Liveness watchdog   (safety path)— T_timeout = 5·T̄; expiry forces a
     state reset so lost signals cannot deadlock the cluster; repeated
     expiries degrade the instance into fixed-interval mode.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


class Readiness(str, enum.Enum):
    READY_QUIESCENT = "quiescent"
    READY_SIGNAL = "signal"
    READY_WATCHDOG = "watchdog"     # forced reset (degraded)
    BUSY = "busy"


@dataclasses.dataclass
class _InstanceSync:
    busy: bool = False
    task_depth: int = 0
    dispatch_time: Optional[float] = None
    watchdog_deadline: Optional[float] = None
    watchdog_trips: int = 0
    degraded: bool = False


class SyncProtocol:
    def __init__(self, num_instances: int, watchdog_multiplier: float = 5.0,
                 degrade_after_trips: int = 3):
        self._st: Dict[int, _InstanceSync] = {
            i: _InstanceSync() for i in range(num_instances)}
        self.mult = watchdog_multiplier
        self.degrade_after = degrade_after_trips

    # -- scheduler-side events -------------------------------------------
    def on_dispatch(self, inst: int, now: float, t_fwd_est: float) -> None:
        s = self._st[inst]
        s.busy = True
        s.task_depth += 1
        s.dispatch_time = now
        s.watchdog_deadline = now + self.mult * max(t_fwd_est, 1e-6)

    # -- engine-side events ----------------------------------------------
    def on_end_forward(self, inst: int, now: float, remaining: int = 0,
                       t_est: float = 0.1) -> None:
        """remaining > 0 means the engine still has device-side backlog and
        will auto-run another pass — it is NOT quiescent (paper §4.1.2:
        quiescence polling watches the instance queue's task depth)."""
        s = self._st[inst]
        s.task_depth = max(0, s.task_depth - 1)
        if remaining > 0:
            s.task_depth = max(s.task_depth, 1)
            s.busy = True
            s.watchdog_deadline = now + self.mult * max(t_est, 1e-6)
        elif s.task_depth == 0:
            s.busy = False
            s.watchdog_deadline = None
        s.watchdog_trips = 0            # healthy signal clears degradation
        s.degraded = False

    # -- readiness check (triple path) -------------------------------------
    def readiness(self, inst: int, now: float) -> Readiness:
        s = self._st[inst]
        if s.task_depth == 0:
            return Readiness.READY_QUIESCENT          # path 1
        if not s.busy:
            return Readiness.READY_SIGNAL             # path 2
        if s.watchdog_deadline is not None and now >= s.watchdog_deadline:
            # path 3: force reset — prevents distributed deadlock
            s.task_depth = 0
            s.busy = False
            s.watchdog_deadline = None
            s.watchdog_trips += 1
            if s.watchdog_trips >= self.degrade_after:
                s.degraded = True       # fixed-interval fallback mode
            return Readiness.READY_WATCHDOG
        return Readiness.BUSY

    def is_ready(self, inst: int, now: float) -> bool:
        return self.readiness(inst, now) != Readiness.BUSY

    def is_degraded(self, inst: int) -> bool:
        return self._st[inst].degraded

    def task_depth(self, inst: int) -> int:
        return self._st[inst].task_depth

    def next_watchdog_deadline(self, now: float) -> Optional[float]:
        ds = [s.watchdog_deadline for s in self._st.values()
              if s.watchdog_deadline is not None and s.watchdog_deadline > now]
        return min(ds) if ds else None
