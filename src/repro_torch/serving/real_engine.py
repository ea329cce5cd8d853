"""Real PyTorch engine backends for the EnginePlane contract (paged only).

Counterpart of `repro/serving/real_engine.py`, the parts the unified
mixed-batch plane runs: `EngineSpec`, `GenState`, `KVHandoffBus`,
`_Worker`/`_WorkerOwner`, `_DPPagedState`, the paged
half of `RealDecodeEngine` and `RealUnifiedEngine`.  They plug into
`ClusterRuntime` exactly where the simulated instances do — same
scheduler feedback, same DecodeDPState accounting — but every step is a
real forward of the port's model on the engine's worker thread.  The
runtime runs in realtime mode: `start_step` returns ASYNC and the worker
posts the `step_end` completion to the runtime's event loop.

Decode is continuous batched decode over a paged block-table cache: each
DP unit owns a `BlockPool` + paged cache (`init_paged_cache`); a
request's lifetime pages are reserved at join and returned at
leave/drain, so admission is by free-block count.  The unified engine
also runs chunked prefill inside the same steps (`mixed_step`).

Differences from the JAX engines:

  * no jit, no mesh, no lock around device programs: PyTorch runs
    eagerly and one engine thread owns one device stream;
  * the step functions write the K/V pools in place (see
    `repro_torch.models.model`), so a worker step mutates the DP's pools
    while the runtime thread waits for `step_end`.  The runtime thread
    touches a cache only between steps (joins, leaves, preemption), never
    while `busy`.  For the same reason `drain` refuses to run while a
    step is in flight: the step would go on writing into pages the drain
    returns to the pool.  The watchdog, which drains an overdue (busy)
    instance, is therefore not available on the port yet;
  * the padded (block_size=0) plane, page-native P/D prefill, page
    sharing and the sharded plane are not ported yet (ROADMAP Queue 1
    items 6, 7 and 11).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import PAGED_SLOTS_FACTOR, ModelConfig
from repro_torch.core.types import Request, RequestPhase
from repro_torch.models.model import (
    init_paged_cache, mixed_step, paged_cache_clear_slot, paged_cache_join,
    paged_cache_take, paged_clear_rows, paged_decode_step, paged_layout,
    paged_prefill_step,
)
from repro_torch.serving.engine import SimDecodeInstance
from repro_torch.serving.kv_pool import BlockPool, pad_block_table
from repro_torch.serving.plane import ASYNC, StartResult, UnifiedEngine


# ---------------------------------------------------------------------------
# Shared engine spec + KV handoff bus
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineSpec:
    """Model + device context shared by every engine of one deployment.

    `max_batch` is the decode-plane MEMORY budget: each DP spends
    max_batch·max_len tokens on a shared `BlockPool` of
    max_batch·max_len/block_size blocks (+ the null block), with
    `decode_slots` (default 2×max_batch) cheap batch rows on top."""
    cfg: ModelConfig
    params: Any
    max_len: int = 256
    max_batch: int = 8          # decode slots per DP unit (= memory budget)
    max_new: int = 0            # 0 = no cap on generated tokens
    block_size: int = 16        # paged KV block size
    decode_slots: int = 0       # paged batch rows per DP (0 = 2×max_batch)
    pool_blocks: int = 0        # physical blocks per DP (0 = equal-memory)
    device: str = "cuda"

    def __post_init__(self):
        if not self.block_size:
            raise NotImplementedError(
                "the padded (block_size=0) plane is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        self.nbt, _ = paged_layout(self.cfg, self.max_len, self.block_size)
        self.device = torch.device(self.device)
        self.dtype = self.params["embed"].dtype
        if self.params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params are on {self.params['embed'].device}, the spec "
                f"on {self.device}")
        if self.device.type == "cuda":
            # build the kernels now, not inside the first timed step
            from repro_torch.kernels.build import load_kernels
            load_kernels()

    @property
    def paged_slots(self) -> int:
        return self.decode_slots or self.max_batch * PAGED_SLOTS_FACTOR

    @property
    def paged_pool_blocks(self) -> int:
        """Physical blocks per DP; default matches the padded plane's
        token capacity exactly (+1 for the reserved null block)."""
        if self.pool_blocks:
            return self.pool_blocks
        return self.max_batch * self.max_len // self.block_size + 1

    def paged_cache(self) -> Dict:
        return init_paged_cache(
            self.cfg, self.paged_slots, self.paged_pool_blocks,
            self.max_len, self.block_size, dtype=self.dtype,
            device=self.device)

    def table(self, ids: Sequence[int]) -> torch.Tensor:
        """A block-table row (nbt,) int32 on the spec's device."""
        return torch.tensor(pad_block_table(ids, self.nbt),
                            dtype=torch.int32, device=self.device)

    def target_len(self, req: Request) -> int:
        if self.max_new:
            return min(req.output_len, self.max_new)
        return req.output_len

    def lifetime_tokens(self, req: Request) -> int:
        """KV tokens resident when `req` finishes: the prompt plus one
        written KV entry per decode step (the final sampled token never
        enters the cache)."""
        return req.input_len + max(self.target_len(req) - 1, 0)


@dataclasses.dataclass
class GenState:
    """Per-request generation context.  `cache` is a parked dense batch-1
    cache (drain / preemption) or None while resident."""
    rid: int
    cache: Optional[Any]
    tokens: List[int]


class KVHandoffBus:
    """Generation-state registry (one per deployment).  The unified plane
    publishes a request's first token when its prompt completes; a
    drained or preempted request's cache is parked here until it
    re-joins.  All access happens on the runtime thread."""

    def __init__(self):
        self._gens: Dict[int, GenState] = {}

    def publish(self, rid: int, cache: Any, first_token: int) -> GenState:
        gen = GenState(rid=rid, cache=cache, tokens=[first_token])
        self._gens[rid] = gen
        return gen

    def gen(self, rid: int) -> GenState:
        return self._gens[rid]

    def get(self, rid: int) -> Optional[GenState]:
        return self._gens.get(rid)


class _Worker(threading.Thread):
    """One serial job executor per engine (the engine's 'device')."""

    def __init__(self, name: str):
        super().__init__(daemon=True, name=name)
        self.jobs: "queue.Queue[Optional[Any]]" = queue.Queue()

    def submit(self, job) -> None:
        self.jobs.put(job)

    def stop(self) -> None:
        self.jobs.put(None)

    def run(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            job()


class _WorkerOwner:
    """start/stop lifecycle of a real engine.  Each start() spawns a
    fresh worker thread, so a server can serve() repeatedly after a
    COMPLETED run.  A worker-thread exception is parked in `_error` and
    re-raised on the runtime thread by the next start/finish call."""

    def __init__(self, tag: str):
        self._tag = tag
        self._worker: Optional[_Worker] = None
        self._error: Optional[BaseException] = None

    def start(self) -> None:
        self._worker = _Worker(self._tag)
        self._worker.start()

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.stop()

    def join_worker(self, timeout: float = 10.0) -> None:
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ---------------------------------------------------------------------------
# Real decode (paged)
# ---------------------------------------------------------------------------


class _DPPagedState:
    """One DP unit's paged continuous batch: `paged_slots` batch rows
    over a shared `BlockPool` (the cache is allocated at the first
    join).  Admission is by free-block count — a request's lifetime
    blocks are reserved at join and returned at leave/drain."""

    def __init__(self, spec: EngineSpec):
        self.cache: Optional[Dict] = None
        self.slots: List[Optional[Request]] = [None] * spec.paged_slots
        self.next_tok: List[int] = [0] * spec.paged_slots
        self.pool = BlockPool(spec.paged_pool_blocks, spec.block_size)
        self.held: Dict[int, List[int]] = {}       # rid -> block ids

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def occupied(self) -> bool:
        return any(r is not None for r in self.slots)

    def can_admit(self, need_tokens: int) -> bool:
        need = self.pool.blocks_for(need_tokens)
        if need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request needs {need} blocks, pool holds only "
                f"{self.pool.num_blocks - 1} — raise max_len/pool_blocks")
        return (self.free_slot() is not None
                and need <= self.pool.free_count)

    def leave(self, rid: int, slot: int) -> None:
        """Drop the slot's table row FIRST (the inactive slot keeps
        stepping on garbage, which must route to the null block), then
        return its pages."""
        self.cache = paged_cache_clear_slot(self.cache, slot)
        self.slots[slot] = None
        self.pool.free(self.held.pop(rid))


class RealDecodeEngine(SimDecodeInstance, _WorkerOwner):
    """Continuous batched paged decode: join-on-handoff /
    leave-on-finish per step.  Request/DPState bookkeeping is inherited
    from the simulated instance; this class adds the paged caches and
    the real step."""

    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 spec: EngineSpec, bus: KVHandoffBus):
        super().__init__(instance_id, dp_ids, cost=None)
        _WorkerOwner.__init__(self, f"decode-{instance_id}")
        self.spec = spec
        self.bus = bus
        self._post = None
        self._dp: Dict[int, _DPPagedState] = {
            d: _DPPagedState(spec) for d in dp_ids}
        self._pending: List[Tuple[int, Request]] = []
        self._deferred: set = set()   # rids whose join failed can_admit
        self._slot_of: Dict[int, Tuple[int, int]] = {}   # rid -> (dp, slot)
        self._participants: Dict[int, List[Tuple[Request, int]]] = {}
        self._result: Optional[Dict[int, Tuple[Dict, List[int]]]] = None
        self._join_finished: List[Request] = []
        # per-step samples (worker appends, read after the run):
        # (wall seconds, active decode rows, cache rows stepped)
        self.step_samples: List[Tuple[float, int, int]] = []
        self._step_active = 0
        self._step_rows = 0

    # -- lifecycle -------------------------------------------------------
    def bind_loop(self, loop) -> None:
        self._post = loop.post

    # -- EnginePlane -----------------------------------------------------
    def free_kv_tokens(self, dp_id: int,
                       tokens: Optional[Sequence[int]] = None
                       ) -> Optional[int]:
        return self._dp[dp_id].pool.free_count * self.spec.block_size

    def admit(self, dp_id: int, req: Request) -> None:
        # buffered: joins are applied between steps (start_step), never
        # while a worker-thread step is in flight
        self._pending.append((dp_id, req))

    def pending_waits(self) -> List[Request]:
        """Joins deferred by device-side capacity: the real plane's
        overload signal, on which the runtime preempts residents."""
        return [r for _, r in self._pending if r.rid in self._deferred]

    def preempt(self, rid: int) -> Optional[Request]:
        """Page-level preemption: park the victim's KV on the bus as a
        dense batch-1 cache, clear its slot, return its pages.
        Re-admission goes through the normal join path.  Refused (None)
        while a worker step is in flight."""
        if self.busy:
            return None
        loc = self._slot_of.get(rid)
        if loc is None:
            return None
        dp_id, slot = loc
        req = next((r for r in self.running[dp_id] if r.rid == rid), None)
        if req is None:
            return None
        st = self._dp[dp_id]
        self.bus.gen(rid).cache = paged_cache_take(self.spec.cfg, st.cache,
                                                   slot)
        st.leave(rid, slot)
        del self._slot_of[rid]
        self.running[dp_id].remove(req)
        return req

    def has_work(self) -> bool:
        return bool(self._pending) or super().has_work()

    def _target_len(self, req: Request) -> int:
        return self.spec.target_len(req)

    def _finish_at_join(self, now: float, by_id, dp_id: int, req: Request,
                        gen: GenState) -> None:
        """The already-emitted token satisfied the request: finish it at
        join, never occupy a slot; the next finish_step reports it."""
        if req.first_token_time is None:
            req.first_token_time = now
        req.finish_time = now
        req.phase = RequestPhase.FINISHED
        gen.cache = None
        by_id[dp_id].release(req.input_len + req.generated,
                             reserve_len=req.input_len + req.output_len)
        self._deferred.discard(req.rid)
        self._join_finished.append(req)

    def _apply_joins(self, now: float, dp_states) -> None:
        """Join parked requests (a dense batch-1 cache on the bus) into a
        free slot with their lifetime pages; retry next step when the
        DP's pool or slots are full."""
        by_id = {s.dp_id: s for s in dp_states}
        still: List[Tuple[int, Request]] = []
        for dp_id, req in self._pending:
            st = self._dp[dp_id]
            gen = self.bus.gen(req.rid)
            if req.generated >= self._target_len(req):
                self._finish_at_join(now, by_id, dp_id, req, gen)
                continue
            life = self.spec.lifetime_tokens(req)
            if not st.can_admit(life):
                self._deferred.add(req.rid)
                still.append((dp_id, req))   # retry after this step
                continue
            self._deferred.discard(req.rid)
            slot = st.free_slot()
            if st.cache is None:
                st.cache = self.spec.paged_cache()
            ids = st.pool.alloc(st.pool.blocks_for(life))
            st.held[req.rid] = ids
            st.cache = paged_cache_join(self.spec.cfg, st.cache, gen.cache,
                                        slot, self.spec.table(ids))
            gen.cache = None        # resident now; parked copy released
            st.slots[slot] = req
            st.next_tok[slot] = gen.tokens[-1]
            self._slot_of[req.rid] = (dp_id, slot)
            self.running[dp_id].append(req)
        self._pending = still

    def _feed_tokens(self, st: _DPPagedState) -> torch.Tensor:
        return torch.tensor([[t] for t in st.next_tok], dtype=torch.int32,
                            device=self.spec.device)

    def start_step(self, dp_states, now: Optional[float] = None
                   ) -> StartResult:
        self._raise_worker_error()
        if self.busy:
            return None
        if self._pending:
            self._apply_joins(now if now is not None else 0.0, dp_states)
        if not super().has_work():
            return None
        self.busy = True
        self.steps += 1
        jobs: List[Tuple[int, Dict, torch.Tensor]] = []
        self._participants = {}
        for d in self.dp_ids:
            st = self._dp[d]
            if not self.running[d]:
                continue
            self._participants[d] = [
                (r, self._slot_of[r.rid][1]) for r in self.running[d]]
            jobs.append((d, st.cache, self._feed_tokens(st)))
        self._step_active = sum(len(v) for v in self._participants.values())
        self._step_rows = sum(len(self._dp[d].slots)
                              for d in self._participants)
        epoch = self.epoch
        post = self._post
        self._worker.submit(lambda: self._exec_step(jobs, epoch, post))
        return ASYNC

    def _exec_step(self, jobs, epoch: int, post) -> None:
        # worker thread: one batched decode step per occupied DP (the
        # instance-level sync barrier = all DPs in one serial job)
        t0 = time.monotonic()
        try:
            res: Dict[int, Tuple[Dict, List[int]]] = {}
            for dp_id, cache, toks in jobs:
                logits, new_cache = paged_decode_step(
                    self.spec.cfg, self.spec.params, toks, cache)
                res[dp_id] = (new_cache, logits.argmax(dim=-1).tolist())
            self._result = res
        except BaseException as e:      # surface on the runtime thread
            self._error = e
        dur = time.monotonic() - t0
        self.step_samples.append((dur, self._step_active, self._step_rows))
        post("step_end", (self, epoch, dur))

    def finish_step(self, now: float, dp_states) -> List[Request]:
        self._raise_worker_error()
        res, self._result = self._result, None
        parts, self._participants = self._participants, {}
        assert res is not None
        for dp_id, (new_cache, nxt) in res.items():
            st = self._dp[dp_id]
            st.cache = new_cache
            for req, slot in parts.get(dp_id, []):
                tok = nxt[slot]
                self.bus.gen(req.rid).tokens.append(tok)
                st.next_tok[slot] = tok
        finished = super().finish_step(now, dp_states)
        for req in finished:
            dp_id, slot = self._slot_of.pop(req.rid)
            self._dp[dp_id].leave(req.rid, slot)     # leave-on-finish
        if self._join_finished:
            # requests satisfied at join time (never occupied a slot):
            # report them with this step's completions
            finished = self._join_finished + finished
            self._join_finished = []
        return finished

    def _require_idle(self) -> None:
        if self.busy:
            raise RuntimeError(
                "drain during an in-flight step: the step writes the pools "
                "in place (see the module docstring)")

    def drain(self) -> Dict[int, List[Request]]:
        self._require_idle()
        out = super().drain()   # clears running, bumps epoch, unlocks
        # migrate resident KV back to the bus so re-dispatch can re-join
        # the requests (with their generation state) on a healthy instance
        for rid, (dp_id, slot) in list(self._slot_of.items()):
            st = self._dp[dp_id]
            self.bus.gen(rid).cache = paged_cache_take(self.spec.cfg,
                                                       st.cache, slot)
            st.leave(rid, slot)
        self._slot_of.clear()
        for dp_id, req in self._pending:
            out.setdefault(dp_id, []).append(req)
        self._pending = []
        self._deferred.clear()
        self._participants = {}
        self._result = None
        return out


# ---------------------------------------------------------------------------
# Real unified mixed-batch engine
# ---------------------------------------------------------------------------


class RealUnifiedEngine(RealDecodeEngine, UnifiedEngine):
    """Unified mixed-batch engine: one pool, one step loop.

    Raw requests (no parked generation state) are staged as PREFILLING
    RESIDENTS at join time: their lifetime pages are reserved and their
    table row installed with `cur = 0`, so no KV handoff ever happens.
    Each step then runs `mixed_step`: the decode rows' batched forward
    plus as many pending prefill-chunk tokens as fit the leftover budget
    (`chunk − decode_rows`).  The decode half is MASKED to the actively
    decoding slots — a prefilling resident's table row is live, so an
    unmasked decode would scribble a garbage token into its pages and
    bump its cursor.

    Chunk grants are quantized to `block_size` multiples (except a
    prompt's final chunk); the starvation bound (`starve_limit`) forces a
    minimum grant when decode rows hog the budget.  `piggyback=False` is
    the DISJOINT ablation: a step with pending prefill runs ONLY the
    prefill chunk while the decode rows stall."""

    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 spec: EngineSpec, bus: KVHandoffBus, chunk: int = 256,
                 starve_limit: int = 4, piggyback: bool = True):
        super().__init__(instance_id, dp_ids, spec, bus)
        self.chunk = max(int(chunk), 1)
        self.starve_limit = max(int(starve_limit), 1)
        self.piggyback = piggyback
        self.prefilling: Dict[int, "collections.deque[Request]"] = {
            d: collections.deque() for d in dp_ids}
        self._consumed: Dict[int, int] = {}       # rid -> prompt tokens done
        self._starve: Dict[int, int] = {d: 0 for d in dp_ids}
        self._grants: Dict[int, List[Tuple[Request, int]]] = {}
        self._chunk_result: Optional[
            Dict[int, List[Tuple[int, torch.Tensor]]]] = None
        self._stalled: set = set()
        self.prefill_tokens = 0
        self.mixed_steps = 0        # steps that ran decode+prefill fused

    # -- EnginePlane -----------------------------------------------------
    def has_work(self) -> bool:
        return (super().has_work()
                or any(self.prefilling[d] for d in self.dp_ids))

    def prefill_backlog(self) -> int:
        return sum(r.input_len - self._consumed[r.rid]
                   for d in self.dp_ids for r in self.prefilling[d])

    def _apply_joins(self, now: float, dp_states) -> None:
        # parked requests (drain re-parks, preemption re-admits) ride the
        # parent join path; RAW requests — no parked KV on the bus —
        # stage as prefilling residents.  A bus entry WITHOUT a cache is
        # one this plane published itself (e.g. a re-served rid): raw
        raw: List[Tuple[int, Request]] = []
        rest: List[Tuple[int, Request]] = []
        for item in self._pending:
            gen = self.bus.get(item[1].rid)
            (raw if gen is None or gen.cache is None else rest).append(item)
        self._pending = rest
        super()._apply_joins(now, dp_states)
        still: List[Tuple[int, Request]] = []
        for dp_id, req in raw:
            st = self._dp[dp_id]
            life = self.spec.lifetime_tokens(req)
            if not st.can_admit(life):
                self._deferred.add(req.rid)
                still.append((dp_id, req))
                continue
            self._deferred.discard(req.rid)
            slot = st.free_slot()
            if st.cache is None:
                st.cache = self.spec.paged_cache()
            ids = st.pool.alloc(st.pool.blocks_for(life))
            st.held[req.rid] = ids
            tab = self.spec.table(ids)
            # reused pages keep their previous tenant's kv_pos; stale
            # pos <= the reader's cursor would alias as valid history
            cache = paged_clear_rows(st.cache, tab)
            cache["block_tab"] = cache["block_tab"].clone()
            cache["block_tab"][slot] = tab
            cache["cur"] = cache["cur"].clone()
            cache["cur"][slot] = 0
            st.cache = cache
            st.slots[slot] = req
            self._slot_of[req.rid] = (dp_id, slot)
            self._consumed[req.rid] = 0
            self.prefilling[dp_id].append(req)
        self._pending.extend(still)

    # -- budget split ----------------------------------------------------
    def _form_grants(self, d: int, n_decode: int, now: float
                     ) -> List[Tuple[Request, int]]:
        q = self.prefilling[d]
        if not q:
            self._starve[d] = 0
            return []
        # disjoint ablation: the full chunk budget every step
        budget = self.chunk - n_decode if self.piggyback else self.chunk
        if budget <= 0:
            self._starve[d] += 1
            if self._starve[d] < self.starve_limit:
                return []
            budget = max(1, self.chunk // 4)    # forced minimum grant
        bs = self.spec.block_size
        grants: List[Tuple[Request, int]] = []
        for req in q:
            if budget <= 0:
                break
            remaining = req.input_len - self._consumed[req.rid]
            use = min(remaining, budget)
            if use < remaining:
                # partial chunks land on block boundaries
                use = (use // bs) * bs
                if use <= 0:
                    break
            if req.prefill_start is None:
                req.prefill_start = now
            grants.append((req, use))
            budget -= use
            # one chunk per DP per step (prefill stays FIFO; leftover
            # budget waits a step)
            break
        if grants:
            self._starve[d] = 0
        return grants

    def start_step(self, dp_states, now: Optional[float] = None
                   ) -> StartResult:
        self._raise_worker_error()
        if self.busy:
            return None
        if self._pending:
            self._apply_joins(now if now is not None else 0.0, dp_states)
        if not (SimDecodeInstance.has_work(self)
                or any(self.prefilling[d] for d in self.dp_ids)):
            return None
        tnow = now if now is not None else 0.0
        dev = self.spec.device
        jobs: List[Tuple[int, Dict, Optional[torch.Tensor], tuple,
                         Optional[torch.Tensor]]] = []
        self._participants = {}
        self._grants = {}
        self._stalled = set()
        for d in self.dp_ids:
            st = self._dp[d]
            rows = self.running[d]
            grants = self._form_grants(d, len(rows), tnow)
            if grants:
                self._grants[d] = grants
            stall = bool(grants) and not self.piggyback and bool(rows)
            if stall:
                self._stalled.add(d)
            decode_rows = [] if stall else rows
            if not decode_rows and not grants:
                continue
            chunks = []
            for req, use in grants:
                c0 = self._consumed[req.rid]
                ids = list((req.tokens or ())[c0: c0 + use])
                chunks.append((torch.tensor([ids], dtype=torch.int32,
                                            device=dev),
                               self._slot_of[req.rid][1]))
            toks = mask = None
            if decode_rows:
                self._participants[d] = [
                    (r, self._slot_of[r.rid][1]) for r in decode_rows]
                toks = self._feed_tokens(st)
                if chunks or self.prefilling[d]:
                    # prefilling residents have LIVE table rows: mask the
                    # decode half to the actively-decoding slots
                    m = [False] * len(st.slots)
                    for _r, s in self._participants[d]:
                        m[s] = True
                    mask = torch.tensor(m, dtype=torch.bool, device=dev)
            jobs.append((d, st.cache, toks, tuple(chunks), mask))
        if not jobs:
            return None
        self.busy = True
        self.steps += 1
        self._step_active = sum(len(v) for v in self._participants.values())
        self._step_rows = sum(len(self._dp[d].slots)
                              for d, _c, toks, _ch, _m in jobs
                              if toks is not None)
        epoch = self.epoch
        post = self._post
        self._worker.submit(lambda: self._exec_mixed(jobs, epoch, post))
        return ASYNC

    def _exec_mixed(self, jobs, epoch: int, post) -> None:
        # worker thread: one fused mixed step per DP with decode rows
        # (masked when prefilling residents share the cache), a plain
        # paged decode when nothing is prefilling, a serial chunk loop
        # when nothing is decoding
        t0 = time.monotonic()
        cfg, params = self.spec.cfg, self.spec.params
        try:
            res: Dict[int, Tuple[Dict, List[int]]] = {}
            cres: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
            for dp_id, cache, toks, chunks, mask in jobs:
                nxt: List[int] = []
                if toks is None:
                    new_cache = cache
                    clogits = []
                    for ctoks, slot in chunks:
                        lg, new_cache = paged_prefill_step(
                            cfg, params, ctoks, new_cache, slot)
                        clogits.append(lg)
                elif mask is not None:
                    logits, clogits, new_cache = mixed_step(
                        cfg, params, toks, cache, chunks, mask)
                    if chunks:
                        self.mixed_steps += 1
                    nxt = logits.argmax(dim=-1).tolist()
                else:
                    logits, new_cache = paged_decode_step(cfg, params, toks,
                                                          cache)
                    clogits = ()
                    nxt = logits.argmax(dim=-1).tolist()
                res[dp_id] = (new_cache, nxt)
                # (first token, the logits it was sampled from)
                cres[dp_id] = [(int(lg[0].argmax()), lg[0]) for lg in clogits]
            self._result = res
            self._chunk_result = cres
        except BaseException as e:      # surface on the runtime thread
            self._error = e
        dur = time.monotonic() - t0
        self.step_samples.append((dur, self._step_active, self._step_rows))
        post("step_end", (self, epoch, dur))

    def finish_step(self, now: float, dp_states) -> List[Request]:
        cres = self._chunk_result or {}
        self._chunk_result = None
        grants, self._grants = self._grants, {}
        stalled, self._stalled = self._stalled, set()
        by_id = {s.dp_id: s for s in dp_states}
        # disjoint-stall steps: detach the stalled DPs' rows so the
        # parent pass emits nothing for them (that stall IS the ablation)
        saved = {d: self.running[d] for d in stalled}
        for d in stalled:
            self.running[d] = []
        finished = super().finish_step(now, dp_states)
        for d, rows in saved.items():
            self.running[d] = rows + self.running[d]
        # prefill half: account granted tokens; a completed prompt
        # publishes its first token (argmax of the chunk's last position)
        # and graduates to the decode rows — no handoff, same pool
        for d, lst in grants.items():
            st = self._dp[d]
            sched = by_id[d]
            firsts = cres.get(d, [])
            q = self.prefilling[d]
            for i, (req, use) in enumerate(lst):
                self._consumed[req.rid] += use
                req.remaining_prefill = max(
                    req.input_len - self._consumed[req.rid], 0)
                self.prefill_tokens += use
                if self._consumed[req.rid] < req.input_len:
                    continue
                first, _logits = firsts[i]
                q.remove(req)
                del self._consumed[req.rid]
                self.bus.publish(req.rid, None, first)
                sched.step(1)               # the emitted token's KV entry
                req.generated += 1
                if req.first_token_time is None:
                    req.first_token_time = now
                self._record_emit(req.rid, now)
                slot = self._slot_of[req.rid][1]
                if req.generated >= self._target_len(req):
                    req.finish_time = now
                    sched.release(req.input_len + req.generated,
                                  reserve_len=req.input_len + req.output_len)
                    self._last_emit.pop(req.rid, None)
                    self._slot_of.pop(req.rid)
                    st.leave(req.rid, slot)
                    finished.append(req)
                else:
                    st.next_tok[slot] = first
                    self.running[d].append(req)
        return finished

    def drain(self) -> Dict[int, List[Request]]:
        # prefilling residents have no parked generation state: drop
        # their partial KV (pages back to the pool) and restart prefill
        # wherever re-dispatch lands them
        self._require_idle()
        pre: Dict[int, List[Request]] = {}
        for d in self.dp_ids:
            q = self.prefilling[d]
            if not q:
                self._starve[d] = 0
                continue
            pre[d] = list(q)
            q.clear()
            st = self._dp[d]
            for req in pre[d]:
                _dp, slot = self._slot_of.pop(req.rid)
                st.leave(req.rid, slot)
                del self._consumed[req.rid]
                req.remaining_prefill = req.input_len
            self._starve[d] = 0
        out = super().drain()
        for d, reqs in pre.items():
            out.setdefault(d, []).extend(reqs)
        self._grants = {}
        self._chunk_result = None
        self._stalled = set()
        return out
