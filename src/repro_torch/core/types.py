"""Core datatypes for the SBS scheduler (paper §4, Figure 5).

The scheduler's world is: requests, DP units (the atomic scheduling unit in
DP+EP systems, §3.1), instances (groups of DP units joined by a
synchronization barrier), and EndForward feedback signals.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Physical KV blocks needed to hold `tokens` entries — THE ceiling
    rule shared by scheduler-side reservation (`DecodeDPState`), the
    engine-side allocator (`serving.kv_pool.BlockPool`) and benchmarks,
    so the two admission layers can never drift apart."""
    if tokens <= 0:
        return 0
    return -(-tokens // block_size)


class RequestPhase(str, enum.Enum):
    QUEUED = "queued"            # scheduler-side queue (SBS buffer)
    DISPATCHED = "dispatched"    # in flight to / inside an engine
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PREEMPTED = "preempted"      # swapped out; KV parked, awaiting re-admit
    FINISHED = "finished"
    REJECTED = "rejected"        # flow control


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service class: dispatch priority (0 = most urgent) plus the
    end-to-end latency target its requests are judged against (goodput =
    the throughput of requests that finish within their class SLO)."""
    name: str
    priority: int
    slo_e2e: float


#: default class ladder — workload generation samples from these, victim
#: selection / PBAA / decode allocation order by `priority`, and the
#: goodput report buckets by `name`.  Override per deployment by building
#: Requests with explicit `priority` / `slo_e2e` fields.
SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", 0, 5.0),
    "standard": SLOClass("standard", 1, 20.0),
    "batch": SLOClass("batch", 2, 120.0),
}

DEFAULT_SLO_CLASS = "standard"


@dataclasses.dataclass
class Request:
    rid: int
    arrival_time: float
    input_len: int
    output_len: int = 1
    tokens: Optional[Tuple[int, ...]] = None    # actual ids (prefix caching)
    phase: RequestPhase = RequestPhase.QUEUED
    # SLO / priority class (overload control).  priority 0 is the most
    # urgent; slo_e2e None falls back to the report-level default SLO.
    priority: int = 1
    slo_e2e: Optional[float] = None
    slo_class: str = DEFAULT_SLO_CLASS
    # scheduling bookkeeping
    wait_cycles: int = 0                        # PBAA starvation counter
    remaining_prefill: int = 0                  # tokens not yet prefetched
    inflight: int = 0                           # granted, not yet processed
    generated: int = 0
    assigned_dp: Optional[int] = None
    assigned_instance: Optional[int] = None
    migrations: int = 0                         # decode watchdog re-dispatches
    preemptions: int = 0                        # page-level swap-outs
    # timestamps
    dispatch_time: Optional[float] = None
    prefill_start: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def __post_init__(self):
        if self.remaining_prefill == 0:
            self.remaining_prefill = self.input_len

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def deadline(self, default_slo: Optional[float] = None
                 ) -> Optional[float]:
        """Absolute wall/virtual time by which the request must finish to
        count toward goodput; None when no SLO applies."""
        slo = self.slo_e2e if self.slo_e2e is not None else default_slo
        if slo is None:
            return None
        return self.arrival_time + slo

    def slo_attained(self, default_slo: Optional[float] = None) -> bool:
        """Finished within its SLO?  Unfinished/rejected never attain."""
        if self.finish_time is None:
            return False
        d = self.deadline(default_slo)
        return d is None or self.finish_time <= d

    @property
    def queueing_delay(self) -> Optional[float]:
        if self.dispatch_time is None:
            return None
        return self.dispatch_time - self.arrival_time

    @property
    def device_queue_delay(self) -> Optional[float]:
        """HOL blocking inside the engine (paper §3.2: the unmanageable part)."""
        if self.prefill_start is None or self.dispatch_time is None:
            return None
        return self.prefill_start - self.dispatch_time


@dataclasses.dataclass
class DPState:
    """Real-time prefill capacity model (paper §4.2.1):
    C_avail = C_chunk − U_flight − R_queued."""
    dp_id: int
    instance_id: int
    c_chunk: int
    u_flight: int = 0       # dispatched but unacknowledged tokens
    r_queued: int = 0       # backlog buffered on the device

    @property
    def c_avail(self) -> int:
        return self.c_chunk - self.u_flight - self.r_queued

    def on_dispatch(self, tokens: int) -> None:
        self.u_flight += tokens

    def on_end_forward(self, processed: int, remaining: int) -> None:
        """EndForward payload: tokens consumed + backlog remaining (§ Fig 5)."""
        self.u_flight = max(0, self.u_flight - processed - remaining)
        self.r_queued = remaining


@dataclasses.dataclass
class DecodeDPState:
    """Decode DP unit state vector V_i = ⟨B_i, K_i⟩ (paper §4.3.3).

    With `block_size` > 0 the unit additionally tracks PAGED occupancy:
    each admitted request reserves ceil(total_len / block_size) physical
    KV blocks for its lifetime, where total_len = input + output.  This
    is a CONSERVATIVE UPPER BOUND on the device-side allocation: the sim
    plane really holds input+output resident tokens at finish, while the
    real engine's `BlockPool` reserves for input + min(output, max_new)
    − 1 (the final sampled token never enters the cache, and the
    scheduler cannot see the engine's max_new cap).  Over-reservation
    only delays admission — the engine's pending-retry path absorbs the
    slack — and admit/release are symmetric, so nothing leaks.  Budget
    masking and the cost model then see `kv_occupancy` — block-granular,
    fragmentation included — while `kv_tokens` stays the exact
    resident-token load."""
    dp_id: int
    instance_id: int
    batch: int = 0          # B_i — number of running decode requests
    kv_tokens: int = 0      # K_i — total KV-cache tokens resident
    max_batch: int = 10_000
    kv_budget: int = 10 ** 12
    block_size: int = 0     # 0 = token-granular (padded-slot) accounting
    kv_blocks: int = 0      # physical blocks reserved (block_size > 0)

    def _blocks_for(self, tokens: int) -> int:
        return blocks_for_tokens(tokens, self.block_size)

    @property
    def kv_occupancy(self) -> int:
        """KV footprint for budgets/cost: reserved-block tokens when
        paged (internal fragmentation included), raw tokens otherwise."""
        if self.block_size:
            return self.kv_blocks * self.block_size
        return self.kv_tokens

    def admit(self, kv_len: int, reserve_len: Optional[int] = None) -> None:
        """`reserve_len` is the request's lifetime KV length (input +
        output) — what the paged plane reserves blocks for up front."""
        self.batch += 1
        self.kv_tokens += kv_len
        if self.block_size:
            self.kv_blocks += self._blocks_for(
                kv_len if reserve_len is None else reserve_len)

    def step(self, n: Optional[int] = None) -> None:
        """Each stepped request grows by 1 KV token.  `n` is the number of
        requests that actually participated in the step — on the real
        plane this can lag `batch` (admitted requests join the padded
        batch only between steps), so engines pass it explicitly.  Paged
        block reservations do not move here: they were taken at admit."""
        self.kv_tokens += self.batch if n is None else n

    def release(self, kv_len: int, reserve_len: Optional[int] = None) -> None:
        self.batch = max(0, self.batch - 1)
        self.kv_tokens = max(0, self.kv_tokens - kv_len)
        if self.block_size:
            self.kv_blocks = max(0, self.kv_blocks - self._blocks_for(
                kv_len if reserve_len is None else reserve_len))


@dataclasses.dataclass
class EndForward:
    """Asynchronous completion signal (paper §4.1.2 fast path)."""
    instance_id: int
    dp_id: int
    exec_time: float               # measured forward-pass duration
    processed_tokens: int = 0
    remaining_tokens: int = 0      # backlog depth (payload statistics)
    timestamp: float = 0.0


@dataclasses.dataclass
class DispatchCommand:
    """Scheduler → engine: one batch for one instance's DP units."""
    instance_id: int
    # per-DP token budget map: dp_id -> list of (request, tokens_this_chunk)
    assignments: Dict[int, List[Tuple[Request, int]]]
    issue_time: float = 0.0

    @property
    def total_tokens(self) -> int:
        return sum(t for lst in self.assignments.values() for _, t in lst)
