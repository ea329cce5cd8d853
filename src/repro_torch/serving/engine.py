"""Simulated inference engines (the Resource Plane of Figure 5).

Both classes satisfy the `EnginePlane` contract (repro.serving.plane):
they are the cost-model-clocked backends; repro.serving.real_engine holds
the jitted-JAX backends behind the same interface.

A prefill instance is a NON-PREEMPTIVE DISCRETE BATCH PROCESSOR (§3.2):
once a pass starts the engine is locked; arriving work accumulates in the
per-DP device-side queue. The pass duration is the cost-model time of the
most-loaded DP unit (the DP+EP sync barrier of §3.3) — so imbalance shows up
as parallelization bubbles exactly as in Figure 3.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import DispatchCommand, EndForward, Request
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.plane import (
    DecodeEngine, PassResult, PrefillEngine, StartResult, UnifiedEngine,
)

__all__ = ["PassResult", "SimPrefillInstance", "SimDecodeInstance",
           "SimUnifiedInstance"]


class SimPrefillInstance(PrefillEngine):
    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 chunk: int, cost: Optional[CostModel]):
        self.instance_id = instance_id
        self.dp_ids = list(dp_ids)
        self.chunk = chunk
        self.cost = cost
        self.queues: Dict[int, Deque[Tuple[Request, int]]] = {
            d: collections.deque() for d in dp_ids}
        self.busy = False
        self._current: Optional[Dict[int, List[Tuple[Request, int]]]] = None
        # stats
        self.passes = 0
        self.tokens_processed = 0
        self.capacity_offered = 0     # passes * n_dp * chunk

    # ------------------------------------------------------------------
    def enqueue(self, cmd: DispatchCommand, now: float) -> None:
        for dp_id, lst in cmd.assignments.items():
            for req, tok in lst:
                req.inflight += tok
                if tok == 0:
                    # full cache hit: completes with the next pass; keep a
                    # zero-token marker so completion is still signaled
                    self.queues[dp_id].append((req, 0))
                else:
                    self.queues[dp_id].append((req, tok))

    def backlog(self, dp_id: int) -> int:
        return sum(t for _, t in self.queues[dp_id])

    def has_work(self) -> bool:
        return any(self.queues[d] for d in self.dp_ids)

    # ------------------------------------------------------------------
    def _begin_pass(self, now: float
                    ) -> Optional[Dict[int, List[Tuple[Request, int]]]]:
        """Form the chunk-bounded per-DP batch and lock the engine.
        Shared by the simulated and real backends — only the pass
        *duration* differs (cost model vs measured wall time)."""
        if self.busy or not self.has_work():
            return None
        batch: Dict[int, List[Tuple[Request, int]]] = {}
        for d in self.dp_ids:
            budget = self.chunk
            taken: List[Tuple[Request, int]] = []
            q = self.queues[d]
            while q and budget >= 0:
                req, tok = q[0]
                if tok == 0:
                    q.popleft()
                    taken.append((req, 0))
                    continue
                if budget == 0:
                    break
                use = min(tok, budget)
                if use == tok:
                    q.popleft()
                else:
                    q[0] = (req, tok - use)
                taken.append((req, use))
                budget -= use
                if req.prefill_start is None:
                    req.prefill_start = now
            if taken:
                batch[d] = taken
        if not batch:
            return None
        self._current = batch
        self.busy = True
        self.passes += 1
        self.capacity_offered += len(self.dp_ids) * self.chunk
        return batch

    def start_pass(self, now: float) -> StartResult:
        """Begin a forward pass; returns its duration or None if idle."""
        batch = self._begin_pass(now)
        if batch is None:
            return None
        dp_tokens = [sum(t for _, t in batch.get(d, [])) for d in self.dp_ids]
        return self.cost.prefill_pass_time(dp_tokens, chunk=self.chunk)

    def finish_pass(self, now: float) -> PassResult:
        assert self.busy and self._current is not None
        evs: List[EndForward] = []
        completed: List[Request] = []
        processed: Dict[int, int] = {}
        for d in self.dp_ids:
            taken = self._current.get(d, [])
            ptok = sum(t for _, t in taken)
            processed[d] = ptok
            self.tokens_processed += ptok
            for req, tok in taken:
                req.inflight -= tok
                if req.inflight == 0 and req.remaining_prefill == 0:
                    req.first_token_time = now
                    completed.append(req)
            evs.append(EndForward(
                instance_id=self.instance_id, dp_id=d,
                exec_time=0.0,                    # filled by the sim
                processed_tokens=ptok,
                remaining_tokens=self.backlog(d),
                timestamp=now))
        self._current = None
        self.busy = False
        return PassResult(evs, completed, processed)

    @property
    def chunk_utilization(self) -> float:
        if self.capacity_offered == 0:
            return 0.0
        return self.tokens_processed / self.capacity_offered


class SimDecodeInstance(DecodeEngine):
    """Decode instance: DP units step together behind the sync barrier."""

    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 cost: Optional[CostModel]):
        self.instance_id = instance_id
        self.dp_ids = list(dp_ids)
        self.cost = cost
        self.running: Dict[int, List[Request]] = {d: [] for d in dp_ids}
        self.busy = False
        self.tokens_generated = 0
        self.steps = 0
        self.epoch = 0      # bumped on drain(); invalidates in-flight steps
        # inter-token latency samples (gap between consecutive emissions
        # of one request on THIS engine) — the tentpole metric of the
        # unified plane: a decode stall behind a prefill pass shows up
        # here as a fat p99
        self.itl: List[float] = []
        self._last_emit: Dict[int, float] = {}

    def _record_emit(self, rid: int, now: float) -> None:
        last = self._last_emit.get(rid)
        if last is not None:
            self.itl.append(now - last)
        self._last_emit[rid] = now

    def admit(self, dp_id: int, req: Request) -> None:
        self.running[dp_id].append(req)

    def has_work(self) -> bool:
        return any(self.running[d] for d in self.dp_ids)

    def drain(self) -> Dict[int, List[Request]]:
        """Watchdog re-dispatch: strip all running work off this instance
        (it is presumed wedged) and unlock it. The caller owns releasing
        the per-DP KV accounting and re-placing the requests."""
        out = {d: reqs for d, reqs in self.running.items() if reqs}
        self.running = {d: [] for d in self.dp_ids}
        self.busy = False
        self.epoch += 1     # any step_end still in flight is now stale
        return out

    def preempt(self, rid: int) -> Optional[Request]:
        """Page-level preemption, per victim (the drain() mechanics at
        request granularity): remove one resident request so its KV can
        be parked and re-admitted later through the normal join path.
        The caller owns releasing the DecodeDPState accounting.  Refused
        (None) while a step is in flight — a swap must never race the
        instance barrier."""
        if self.busy:
            return None
        for d in self.dp_ids:
            for r in self.running[d]:
                if r.rid == rid:
                    self.running[d].remove(r)
                    return r
        return None

    def _target_len(self, req: Request) -> int:
        """Tokens at which `req` is finished (real plane may cap this)."""
        return req.output_len

    def start_step(self, dp_states, now: Optional[float] = None
                   ) -> StartResult:
        if self.busy or not self.has_work():
            return None
        self.busy = True
        by_id = {s.dp_id: s for s in dp_states}
        batches = [len(self.running[d]) for d in self.dp_ids]
        # kv_occupancy: paged units are priced at block granularity
        # (reserved pages are resident and swept every step), so the sim
        # plane models the same fragmentation the real paged engine pays
        kvs = [by_id[d].kv_occupancy for d in self.dp_ids]
        self.steps += 1
        return self.cost.decode_step_time(batches, kvs)

    def finish_step(self, now: float, dp_states) -> List[Request]:
        """Each running request emits one token; returns finished requests."""
        assert self.busy
        self.busy = False
        by_id = {s.dp_id: s for s in dp_states}
        finished: List[Request] = []
        for d in self.dp_ids:
            alive: List[Request] = []
            st = by_id[d]
            n = len(self.running[d])
            if n:
                st.step(n)                      # K_i += participants
                self.tokens_generated += n
            for req in self.running[d]:
                req.generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                self._record_emit(req.rid, now)
                if req.generated >= self._target_len(req):
                    req.finish_time = now
                    st.release(req.input_len + req.generated,
                               reserve_len=req.input_len + req.output_len)
                    self._last_emit.pop(req.rid, None)
                    finished.append(req)
                else:
                    alive.append(req)
            self.running[d] = alive
        return finished

class SimUnifiedInstance(SimDecodeInstance, UnifiedEngine):
    """Unified mixed-batch instance (the Sarathi-style piggyback plane,
    cost-model clocked).  Prompts are admitted RAW (remaining_prefill >
    0) to the decode plane; each step carries the decode rows plus as
    many pending prefill-chunk tokens as fit the leftover token budget
    (`chunk − decode_rows`), priced by `CostModel.mixed_step_time` —
    decode rows keep emitting every step, so prefill no longer stalls
    them.

    Starvation bound: when decode rows alone exhaust the budget for
    `starve_limit` consecutive steps while prefill is pending, the next
    step grants a minimum chunk (`chunk // 4`) anyway, so prefill can
    lag but never be locked out.

    `piggyback=False` is the DISJOINT ablation (the A/B baseline — the
    prefill-prioritizing chunked loop Sarathi measures against): a step
    with pending prefill runs ONLY the prefill chunk and the decode rows
    stall through it, which is exactly the ITL-p99 bubble the unified
    plane removes."""

    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 cost: Optional[CostModel], chunk: int = 3072,
                 starve_limit: int = 4, piggyback: bool = True):
        super().__init__(instance_id, dp_ids, cost)
        self.chunk = max(int(chunk), 1)
        self.starve_limit = max(int(starve_limit), 1)
        self.piggyback = piggyback
        self.prefilling: Dict[int, Deque[Request]] = {
            d: collections.deque() for d in dp_ids}
        self._starve: Dict[int, int] = {d: 0 for d in dp_ids}
        self._grants: Dict[int, List[Tuple[Request, int]]] = {}
        self._stalled: set = set()
        self.prefill_tokens = 0
        self.forced_grants = 0      # starvation-bound activations

    # ------------------------------------------------------------------
    def admit(self, dp_id: int, req: Request) -> None:
        if req.remaining_prefill > 0:
            self.prefilling[dp_id].append(req)
        else:
            super().admit(dp_id, req)

    def has_work(self) -> bool:
        return (super().has_work()
                or any(self.prefilling[d] for d in self.dp_ids))

    def prefill_backlog(self) -> int:
        return sum(r.remaining_prefill for d in self.dp_ids
                   for r in self.prefilling[d])

    def drain(self) -> Dict[int, List[Request]]:
        out = super().drain()
        for d in self.dp_ids:
            if self.prefilling[d]:
                out.setdefault(d, []).extend(self.prefilling[d])
                self.prefilling[d].clear()
            self._starve[d] = 0
        self._grants = {}
        self._stalled = set()
        return out

    def preempt(self, rid: int) -> Optional[Request]:
        got = super().preempt(rid)
        if got is not None or self.busy:
            return got
        for d in self.dp_ids:
            for r in self.prefilling[d]:
                if r.rid == rid:
                    self.prefilling[d].remove(r)
                    return r
        return None

    # ------------------------------------------------------------------
    def _form_grants(self, d: int, n_decode: int, now: float
                     ) -> List[Tuple[Request, int]]:
        """Fill the leftover token budget of DP `d` with pending prefill
        chunks (FIFO).  Queue state is NOT mutated here — completions
        are applied in finish_step, so an epoch-invalidating drain
        mid-step loses nothing."""
        q = self.prefilling[d]
        if not q:
            self._starve[d] = 0
            return []
        # disjoint ablation: prefill-prioritizing baseline — the full
        # chunk budget every step, decode rows stall while it runs
        budget = self.chunk - n_decode if self.piggyback else self.chunk
        if budget <= 0:
            self._starve[d] += 1
            if self._starve[d] < self.starve_limit:
                return []
            budget = max(1, self.chunk // 4)    # forced minimum grant
            self.forced_grants += 1
        grants: List[Tuple[Request, int]] = []
        for req in q:
            if budget <= 0:
                break
            use = min(req.remaining_prefill, budget)
            if req.prefill_start is None:
                req.prefill_start = now
            grants.append((req, use))
            budget -= use
        if grants:
            self._starve[d] = 0
        return grants

    def start_step(self, dp_states, now: Optional[float] = None
                   ) -> StartResult:
        if self.busy or not self.has_work():
            return None
        by_id = {s.dp_id: s for s in dp_states}
        self._grants = {}
        self._stalled = set()
        batches: List[int] = []
        kvs: List[int] = []
        ptoks: List[int] = []
        for d in self.dp_ids:
            n = len(self.running[d])
            grants = self._form_grants(d, n, now if now is not None else 0.0)
            p = sum(t for _, t in grants)
            if grants:
                self._grants[d] = grants
            if grants and not self.piggyback and n:
                # disjoint forced-prefill step: decode rows stall
                self._stalled.add(d)
                batches.append(0)
                kvs.append(0)
            else:
                batches.append(n)
                kvs.append(by_id[d].kv_occupancy if n else 0)
            ptoks.append(p)
        self.busy = True
        self.steps += 1
        return self.cost.mixed_step_time(batches, kvs, ptoks)

    def finish_step(self, now: float, dp_states) -> List[Request]:
        grants = self._grants
        stalled = self._stalled
        self._grants = {}
        self._stalled = set()
        by_id = {s.dp_id: s for s in dp_states}
        # decode half: stalled DPs (disjoint forced-prefill steps) emit
        # nothing — detach their rows so the parent pass skips them
        saved = {d: self.running[d] for d in stalled}
        for d in stalled:
            self.running[d] = []
        finished = super().finish_step(now, dp_states)
        for d, rows in saved.items():
            self.running[d] = rows + self.running[d]
        # prefill half: apply granted chunk tokens; a completed prompt
        # emits its first token (argmax of the chunk's last position on
        # the real plane) and graduates to the decode rows
        for d, lst in grants.items():
            st = by_id[d]
            q = self.prefilling[d]
            for req, use in lst:
                req.remaining_prefill -= use
                self.prefill_tokens += use
                if req.remaining_prefill > 0:
                    continue
                q.remove(req)
                st.step(1)          # the emitted token's KV entry
                req.generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                self._record_emit(req.rid, now)
                if req.generated >= self._target_len(req):
                    req.finish_time = now
                    st.release(req.input_len + req.generated,
                               reserve_len=req.input_len + req.output_len)
                    self._last_emit.pop(req.rid, None)
                    finished.append(req)
                else:
                    self.running[d].append(req)
        return finished
