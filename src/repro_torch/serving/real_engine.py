"""Real PyTorch engine backends for the EnginePlane contract.

Counterpart of `repro/serving/real_engine.py`: `EngineSpec`,
`PageHandoff`, `GenState`, `KVHandoffBus`, `_Worker`/`_WorkerOwner`,
`_PrefillCtx`/`_PagedPrefillCtx` and `RealPrefillEngine` (dense and
page-native), `_DPDecodeState`/`_DPPagedState`, `_ShardedGroup`/
`_DPShardedState`, `RealDecodeEngine` (padded, paged and sharded) and
`RealUnifiedEngine`.  They plug
into `ClusterRuntime` exactly where the simulated instances do — same
scheduler feedback, same DecodeDPState accounting — but every pass/step
is a real forward of the port's model on the engine's worker thread.
The runtime runs in realtime mode: `start_pass`/`start_step` return
ASYNC and the worker posts the `pass_end`/`step_end` completion to the
runtime's event loop.

Prefill (P/D deployment) is true chunked prefill with two cache
backends:

  dense (default)        each granted (request, tokens) slice extends the
      request's row of the engine's pool of dense batch-1 caches via
      `prefill_chunk` (a graph per chunk length over a static working
      cache, or the eager step on the row); completion publishes a copy
      of the row and resets it.
  page-native (opt-in)   chunks write straight into the engine's
      `BlockPool` pages via `paged_prefill_step`.  With `share_prefix`, a
      `PagePrefixBinder` resolves each new prompt's longest cached prefix
      to live pages at enqueue time, so those chunks are never computed
      (an exact full-prompt hit runs no chunk and replays the stored
      first token).  Completion gathers only the pages the request holds
      (`paged_gather_blocks`) into a `PageHandoff`.

Either way the first token (argmax of the last chunk's logits) and the
cache or handoff are published on the `KVHandoffBus` — the paper's P/D
KV transfer, priced by `transfer_time` on the runtime heap and realised
at join time.

Decode is continuous batched decode with two cache backends behind one
engine:

  padded (block_size=0)  each DP owns a `max_batch`-row dense cache
      (`init_cache`, max_len per row, a ring of the window for SWA
      models; per-row SSM and conv state for SSM layers); a free SLOT is
      the admission token.  Joins copy the parked batch-1 cache into the
      row (`cache_join`).  The plane of SSM models (SSM state has no
      page form).
  paged  (block_size>0)  each DP owns a `BlockPool` + block-table cache
      (`init_paged_cache`); a request's lifetime pages are reserved at
      join and returned at leave/drain, so admission is by free-block
      count.  Joins scatter a batch-1 cache into the pages
      (`paged_cache_join`); a `PageHandoff` joins by
      `paged_adopt_blocks`, and with `share_prefix` its prefix pages
      already resident on the DP are pointed at, not copied, its pages
      are published into the DP's binder, and the partial tail block is
      copied on write at join.  A hybrid's SSM layers keep their state
      per slot beside the pages, as the reference's: a join sets the
      slot's rows, preemption and drain take them with the pages
      (`paged_cache_take`), and the decode step returns new ones.  A
      paged spec of a config without attention raises ValueError
      (`paged_layout`).  Page-native prefill, page sharing and the
      unified engine are attention-only, as in the reference, and raise
      ValueError for a hybrid: its paged plane is P/D with dense
      prefill.

Every step runs one batched `decode_step`/`paged_decode_step` per
occupied DP behind the instance sync barrier; finished requests leave
their slot (paged: also their table row and pages).  The unified engine
(paged only) runs chunked prefill inside the same steps (`mixed_step`).

With a `mesh` (`EngineSpec(mesh=, parallel=)`, paged only) the spec is
SHARDED, as the reference's: its params are placed on the mesh
(`distributed.sharding.place_params`: expert weights split over the
expert axes, the rest replicated), its paged steps run under the mesh
context (`distributed.annotate.activate(..., ep_shard_map=True)`), so
MoE layers take the explicit all-to-all of `models.moe_ep`, and a
decode instance merges its DP units' rows into ONE cache held as one
shard per (data, model) rank (`merged_paged_cache`; `_ShardedGroup`).
A mesh with a "model" axis of M > 1 ranks runs tensor parallelism
inside each DP: each rank holds only its share of the heads (or, where
they do not divide, of d_model: the row-parallel form), dense FFN and
shared-expert columns and vocabulary (`ShardedParams.ranks`, no whole
replica) and of the pools' KV heads, and the partial outputs meet in
all-reduces over the DP's ranks (`distributed.transfer`), counted per
step in `tp_samples`; the page surgery acts on every rank of the DP.
Each step is then one cross-DP step over every DP's rows, with the EP
exchange in each MoE layer (a hybrid's SSM_MOE layers too; its SSM
layers decode each shard's rows from their per-slot state): the
paper's DP sync barrier on this plane.  A dense prefill chunk runs
outside the mesh context, as the reference's `jit_prefill_chunk`, so
its MoE is the single-program one over the split expert weights and no
chunk length has to divide over the mesh's devices: on the lead device
without model ranks, under TP on DP 0's model ranks, its rows split
over them (`split_dense_cache`) and handed off rank to rank; a TP
page-native prefill engine's pool is split over DP 0's ranks as well.
A TP spec runs no step on whole weights.  Each DP keeps
its own admission control (`_DPShardedState`: a `BlockPool` of global
block ids from its base offset, its own slot range, a private binder)
and reads the merged cache through its view.  Every sharded step and
page surgery runs under the spec's `step_lock` (the reference's mesh
lock); the exchanges each step made (`ep_samples`) are counted beside
its `step_samples`.  With step graphs (the default) every sharded step
replays CUDA graphs as the reference runs its mesh programs: the
merged decode step (key ("decode", "merged"), captured when the engine
is built), each page-native chunk on its shard's cache (("prefill",
shard, chunk length); under TP on the DP's ranks, `dp_view`) and a
sharded P/D prefill engine's dense chunk;
on shards that share a card each step is one graph, on separate cards
one graph a card between the moves that cross cards
(`repro_torch.serving.step_graphs`).

Differences from the JAX engines:

  * no jit and no mesh: with `EngineSpec.step_graphs` (the default)
    every decode step and every prefill chunk, dense (the SSM prefill
    included) or page-native, replays a CUDA graph
    (`repro_torch.serving.step_graphs`; decode graphs and a prefill
    engine's full-chunk graph are captured when the engine is built,
    shorter chunks' at a length's first use), and only the page surgery
    and a dense row's copies run op by op; `step_graphs=False` runs
    every step eagerly.  Every engine thread queues its work on the
    device's default stream (so it serialises, and a handoff cache
    written by a prefill worker is complete before the runtime thread's
    join reads it, and a page the runtime thread clears or stages is
    ready before the worker's next chunk reads it); with step graphs
    each engine queues its steps (a dense chunk with its row's copies)
    under the spec's `step_lock`, the reference's `_mesh_lock`, under
    which graphs are also captured;
  * the step functions write the K/V caches in place (see
    `repro_torch.models.model`), so a worker step mutates the DP's cache
    while the runtime thread waits for `step_end`.  The runtime thread
    touches a cache only between steps (joins, leaves, preemption), never
    while `busy`.  `drain` — the watchdog's, which finds the instance
    busy by definition — first waits (at most `drain_wait_s`) for the
    in-flight step to return, and raises if it does not, so no slot or
    page is handed back while a step can still write it.  It then parks
    the PRE-step snapshot, as the JAX engine does: the step's result is
    dropped (its `step_end` is stale by epoch), and the one K/V entry the
    abandoned step already wrote, at the row's cursor, is rewritten by
    the re-joined row's next step before any query reads it (a ring
    index it overwrote held a position one window back, which the window
    already masks).  SSM and conv states are never written by a step (it
    returns new ones), so the snapshot holds them as they were;
  * in-place writes and shared pages: a page a binder has published is
    never written again.  Every write lands at a position at or past the
    writer's own cursor: a prefill chunk past its claimed, block-aligned
    prefix (a full hit never runs a chunk), a decode step past the
    prompt.  So a decode DP copies the partial tail block a join shares
    before the row's first step (the eager copy-on-write), and a
    completed prefill gathers its payload (a copy) before it drops its
    pages.  The runtime thread stages page-native prefill rows (clears
    fresh pages, installs the table row and cursor) only while no pass is
    in flight, and reads no cursor or table back to the host;
  * the sharded plane is single-controller as in the reference, on
    an `EngineMesh` of torch devices that may repeat (logical shards
    on one card or the CPU); a join copies a handed-off payload onto
    the destination shard's device.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import (
    PAGED_SLOTS_FACTOR, ModelConfig, ParallelConfig,
)
from repro_torch.core.types import DispatchCommand, Request, RequestPhase
from repro_torch.distributed import annotate
from repro_torch.distributed.sharding import (
    axis_size, data_axes_of, expert_axes_of, is_merged,
    model_size, params_on, place_params, shard_paged_cache,
)
from repro_torch.distributed.transfer import count_collectives
from repro_torch.models.model import (
    _require_pageable_prefill, cache_clear_row, cache_join, cache_row,
    cache_take, decode_step, init_cache, init_paged_cache, mixed_step,
    paged_adopt_blocks,
    paged_cache_clear_slot, paged_cache_join, paged_cache_take,
    paged_clear_rows, paged_copy_block, paged_decode_masked,
    paged_decode_step, paged_gather_blocks, paged_install_row,
    paged_layout, paged_prefill_step, paged_set_table, prefill_chunk,
    dp_view, require_servable, shard_slot, split_dense_cache, with_dp,
    with_shard,
)
from repro_torch.models.moe_ep import count_exchanges
from repro_torch.serving.engine import SimDecodeInstance, SimPrefillInstance
from repro_torch.serving.kv_pool import BlockPool, pad_block_table
from repro_torch.serving.page_share import PagePrefixBinder
from repro_torch.serving.plane import (
    ASYNC, PassResult, StartResult, UnifiedEngine,
)
from repro_torch.serving.step_graphs import IN_PLACE, StepGraphs


# ---------------------------------------------------------------------------
# Shared engine spec + KV handoff bus
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineSpec:
    """Model + device context shared by every engine of one deployment.

    `max_batch` is the decode-plane MEMORY budget: the padded plane
    allocates max_batch rows of max_len tokens per DP; the paged plane
    (block_size > 0) spends the SAME token budget on a shared `BlockPool`
    of max_batch·max_len/block_size blocks (+ the null block), with
    `decode_slots` (default 2×max_batch) cheap batch rows on top.  A
    page-native prefill engine owns a pool of its own
    (`paged_prefill_blocks`) with `paged_prefill_slots` rows; a dense
    prefill engine a pool of `paged_prefill_slots` dense rows, grown by
    as many again whenever every row is taken.

    `step_graphs` (default) runs every decode step and prefill chunk
    (dense or page-native) through each engine's `StepGraphs`: CUDA
    graphs on the card, the same static buffers around direct calls on
    the CPU; the dense chunks' graphs are the spec's, shared by its
    prefill engines (`dense_graphs`).  False runs every step eagerly
    (the A/B and the tests).

    A `mesh` (an `EngineMesh` of "data" ranks, one per decode DP unit,
    each with "model" ranks of tensor parallelism) makes the spec
    SHARDED (`_init_sharded`): paged only, its device the mesh's lead,
    its step graphs captured across the mesh's devices.
    `parallel` (a `ParallelConfig`) names the expert axes; the default
    is EP over the whole mesh when the expert count divides it."""
    cfg: ModelConfig
    params: Any
    max_len: int = 256
    max_batch: int = 8          # decode slots per DP unit (= memory budget)
    max_new: int = 0            # 0 = no cap on generated tokens
    block_size: int = 0         # paged KV block size (0 = padded slots)
    decode_slots: int = 0       # paged batch rows per DP (0 = 2×max_batch)
    pool_blocks: int = 0        # physical blocks per DP (0 = equal-memory)
    prefill_slots: int = 0      # page-native prefill rows (0 = auto)
    prefill_pool_blocks: int = 0  # page-native prefill pool (0 = auto)
    device: str = "cuda"
    step_graphs: bool = True    # compiled decode steps and prefill chunks
    mesh: Any = None            # EngineMesh -> sharded engines
    parallel: Any = None        # ParallelConfig (None = EP over the mesh)

    def __post_init__(self):
        require_servable(self.cfg)
        if self.block_size:
            self.nbt, _ = paged_layout(self.cfg, self.max_len,
                                       self.block_size)
        if self.mesh is not None:
            self.device = self.mesh.lead
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
        # held by every engine of the spec while it queues a step, and
        # while it captures one (step graphs only); on a sharded spec by
        # every step and every page surgery (the reference's mesh lock)
        self.step_lock = threading.RLock()
        self._dense: Optional[Tuple[StepGraphs, Dict]] = None
        self.n_dp = 1
        self.axis_map = None
        if self.mesh is not None:
            self._init_sharded()

    def _init_sharded(self) -> None:
        """Place the params on the mesh and record the axis map the
        steps' mesh context carries: tokens over the data axes, experts
        over the expert axes (EP over the whole mesh when E divides it,
        as the reference's `launch/dryrun` default), and on a mesh with
        model ranks the model axis (tensor parallelism inside each
        DP)."""
        if not self.block_size:
            raise ValueError(
                "sharded engines are paged-only (set block_size > 0)")
        mesh = self.mesh
        if mesh.size != mesh.shape.get("data", 0) * model_size(mesh):
            raise ValueError(f"a sharded spec on {mesh}: the mesh has "
                             f"axes other than data and model")
        if self.parallel is None:
            par = ParallelConfig()
            mc = self.cfg.moe
            E = mc.num_experts if mc is not None else 0
            for cand in (("data", "model"), ("model",)):
                if E and E % axis_size(mesh, [a for a in cand
                                              if a in mesh.shape]) == 0:
                    par = dataclasses.replace(par, expert_axes=cand)
                    break
            self.parallel = par
        par = self.parallel
        self.n_dp = mesh.shape["data"]
        self.axis_map = {"tokens": data_axes_of(mesh, par),
                         "experts": expert_axes_of(mesh, par)}
        if model_size(mesh) > 1:
            self.axis_map["model"] = par.model_axis
        self.params = place_params(self.cfg, self.params, mesh, par)

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def device_lock(self):
        """The step lock on a sharded spec, else a no-op context (the
        reference's `device_lock`)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return self.step_lock

    def _on_mesh(self):
        """The mesh context a sharded spec's paged steps run under."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return annotate.activate(self.mesh, self.axis_map, ep_shard_map=True)

    def merged_paged_cache(self) -> Dict:
        """ONE instance-wide decode cache holding every DP unit's rows
        (sharded plane), as one shard per (data, model) rank on its
        device, each with its share of the KV and SSM heads under TP:
        slot s belongs to DP s // paged_slots, physical block b to DP
        b // paged_pool_blocks, matching the per-DP `BlockPool(base=...)`
        allocators."""
        M = model_size(self.mesh)
        return {"shards": [init_paged_cache(
                    self.cfg, self.paged_slots, self.paged_pool_blocks,
                    self.max_len, self.block_size, dtype=self.dtype,
                    device=dev, tp=M)
                    for dev in self.mesh.devices],
                "slots": self.paged_slots, "blocks": self.paged_pool_blocks,
                "model": M}

    def shard_cache(self, cache: Dict) -> Dict:
        """A paged cache of n_dp·paged_slots rows over n_dp·pool blocks in
        global ids as the merged form (no-op for unsharded specs)."""
        if self.mesh is None:
            return cache
        return shard_paged_cache(cache, self.mesh, self.cfg)

    def step_graphs_for(self) -> Optional[StepGraphs]:
        """A new engine's compiled steps (None on the eager path)."""
        if not self.step_graphs:
            return None
        return StepGraphs(self.params, self.device, self.step_lock,
                          devices=None if self.mesh is None
                          else self.mesh.distinct)

    def dense_graphs(self) -> Tuple[Optional[StepGraphs], Optional[Dict]]:
        """A new dense prefill engine's compiled chunks and the static
        batch-1 working cache they run on ((None, None) on the eager
        path).  Both are the spec's, as the reference compiles each chunk
        shape once for every engine of a spec: the first engine gets the
        runner that owns them, every later one a runner over the same
        graphs with counters of its own (`StepGraphs.share`), so a chunk
        length is captured once, not once an engine.  `dense_prefill`
        holds `step_lock` from the copy into the working cache to the
        copy back, so the engines' chunks take turns on it."""
        if not self.step_graphs:
            return None, None
        with self.step_lock:
            if self._dense is None:
                self._dense = (self.step_graphs_for(), self.request_cache())
                return self._dense
            graphs, work = self._dense
            return graphs.share(), work

    # the steps the graphs capture: fn(cache, **static inputs); a
    # sharded spec runs its paged steps under the mesh context
    def decode_fn(self, cache, token):
        step = paged_decode_step if self.paged else decode_step
        with self._on_mesh():
            return step(self.cfg, self.params, token, cache)

    def masked_decode_fn(self, cache, token, mask):
        with self._on_mesh():
            return paged_decode_masked(self.cfg, self.params, token, cache,
                                       mask)

    def prefill_fn(self, cache, tokens, slot):
        with self._on_mesh():
            return paged_prefill_step(self.cfg, self.params, tokens, cache,
                                      slot)

    def shard_prefill_fn(self, k: int):
        """The page-native chunk step of shard k of a merged cache without
        model ranks: on that shard's cache, with its device's replica of
        the params and a slot local to the shard (what
        `paged_prefill_step` does for a merged cache, with the shard
        picked on the host)."""
        params = params_on(self.params, self.mesh.devices[k])

        def fn(cache, tokens, slot):
            with self._on_mesh():
                return paged_prefill_step(self.cfg, params, tokens, cache,
                                          slot)
        return fn

    def prefill_chunk_fn(self, cache, tokens):
        return prefill_chunk(self.cfg, self.params, tokens, cache)

    def paged_prefill(self, graphs: Optional[StepGraphs], tokens, cache,
                      slot, unit: int = 0):
        """One page-native prefill chunk into the cache of `unit` (the
        unified engine's DP; a prefill engine has one cache): the graph
        of its length, or the eager step.  On a merged cache the chunk
        runs on the shard that holds `slot` (key ("prefill", shard,
        length); under TP on its DP's model ranks, a `dp_view`, key
        ("prefill", DP, length)) and its logits come back to the spec's
        device; a length
        that does not divide over the mesh's devices takes the
        single-program MoE (`models.moe._ep_route`, the reference's
        rule), so no chunk is padded."""
        if is_merged(cache) and model_size(self.mesh) > 1:
            # tensor parallelism: the chunk runs on the DP's model ranks
            # (a prefill engine's pool is one DP's)
            d = slot // cache["slots"]
            view = dp_view(cache, d)
            local = slot - d * cache["slots"]
            if graphs is None:
                logits, new = self.prefill_fn(view, tokens, local)
            else:
                logits, new = graphs.run(("prefill", d, tokens.shape[1]),
                                         self.prefill_fn, view,
                                         tokens=tokens, slot=local)
            return logits, with_dp(cache, d, new)
        if is_merged(cache):
            k, shard, local = shard_slot(cache, slot)
            dev = shard["cur"].device
            fn = self.shard_prefill_fn(k)
            tokens = tokens.to(dev, non_blocking=True)
            if graphs is None:
                logits, new = fn(shard, tokens, local)
            else:
                logits, new = graphs.run(("prefill", k, tokens.shape[1]), fn,
                                         shard, tokens=tokens, slot=local)
            return (logits.to(self.device, non_blocking=True),
                    with_shard(cache, k, new))
        if graphs is None:
            return self.prefill_fn(cache, tokens, slot)
        return graphs.run(("prefill", unit, tokens.shape[1]),
                          self.prefill_fn, cache, tokens=tokens, slot=slot)

    def dense_prefill(self, graphs: Optional[StepGraphs], tokens, cache,
                      row: int, at: int, work: Optional[Dict] = None):
        """One dense prefill chunk of the prompt in row `row` of the
        dense batch cache `cache` (a prefill engine's pool), whose first
        `at` tokens are in the row: the eager step on the row itself, or
        the graph of the chunk's length over the engine's static batch-1
        cache `work`, into which the row's K/V (its first min(at, S)
        entries, the only ones written) and kv_pos are copied before
        the replay and from which they are copied back after it.  The
        row's cursor and SSM and conv states are set to the step's new
        ones.  Returns the last position's logits (1, V)."""
        if graphs is None:
            logits, new = self.prefill_chunk_fn(cache_row(cache, row),
                                                tokens)
            _set_row(cache, row, new)
            return logits
        S = (cache["shards"][0] if is_merged(cache) else cache)[
            "kv_pos"].shape[1]
        with self.step_lock:
            _copy_kv(work, 0, cache, row, min(at, S))
            logits, new = graphs.run(("prefill-dense", tokens.shape[1]),
                                     self.prefill_chunk_fn,
                                     _dense_step(work, cache, row),
                                     tokens=tokens)
            _copy_kv(cache, row, work, 0, min(at + tokens.shape[1], S))
            _set_row(cache, row, new)
        return logits

    @property
    def paged(self) -> bool:
        return self.block_size > 0

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

    @property
    def prefix_sharable(self) -> bool:
        """Page sharing needs every cached layer to live in pool pages —
        attention-only decoder-only configs."""
        if not self.paged:
            return False
        try:
            _require_pageable_prefill(self.cfg)
        except ValueError:
            return False
        return True

    @property
    def paged_prefill_slots(self) -> int:
        """Concurrent in-flight prompts per page-native prefill engine."""
        return self.prefill_slots or max(8, 2 * self.max_batch)

    @property
    def paged_prefill_blocks(self) -> int:
        """Prefill-pool size: 2× the slot working set, so completed pages
        can stay resident in the prefix cache while fresh prompts stage."""
        if self.prefill_pool_blocks:
            return self.prefill_pool_blocks
        per_slot = self.max_len // self.block_size
        return 2 * self.paged_prefill_slots * per_slot + 1

    @property
    def tp(self) -> int:
        """Tensor-parallel ranks a DP (1 without a mesh)."""
        return 1 if self.mesh is None else model_size(self.mesh)

    def request_cache(self, batch: int = 1) -> Dict:
        """A dense prefill cache of `batch` rows (a dense prefill
        engine's pool; batch 1: its graphs' working cache); under TP
        split over DP 0's model ranks (`split_dense_cache`), where the
        chunks run."""
        if self.tp > 1:
            return split_dense_cache(self.cfg, batch, self.max_len,
                                     self.dtype, self.mesh.devices[:self.tp])
        return init_cache(self.cfg, batch, self.max_len, dtype=self.dtype,
                          device=self.device)

    def batch_cache(self) -> Dict:
        """One DP unit's padded decode cache (max_batch rows)."""
        return init_cache(self.cfg, self.max_batch, self.max_len,
                          dtype=self.dtype, device=self.device)

    def paged_cache(self) -> Dict:
        return init_paged_cache(
            self.cfg, self.paged_slots, self.paged_pool_blocks,
            self.max_len, self.block_size, dtype=self.dtype,
            device=self.device)

    def prefill_paged_cache(self) -> Dict:
        """A page-native prefill engine's paged cache; under TP a merged
        cache of one DP over DP 0's model ranks (its chunks run there,
        `_tp_prefill`; its payloads hand off rank to rank)."""
        if self.tp > 1:
            M = self.tp
            return {"shards": [init_paged_cache(
                        self.cfg, self.paged_prefill_slots,
                        self.paged_prefill_blocks, self.max_len,
                        self.block_size, dtype=self.dtype, device=dev, tp=M)
                        for dev in self.mesh.devices[:M]],
                    "slots": self.paged_prefill_slots,
                    "blocks": self.paged_prefill_blocks, "model": M}
        return init_paged_cache(
            self.cfg, self.paged_prefill_slots, self.paged_prefill_blocks,
            self.max_len, self.block_size, dtype=self.dtype,
            device=self.device)

    def upload(self, ids: Sequence[int]) -> torch.Tensor:
        """A prefill chunk's tokens as a (1, n) int32 tensor on the spec's
        device.  On the card the copy is queued from pinned host memory
        without waiting: one from pageable memory first waits for all the
        work queued on the stream, other engines' steps included."""
        t = torch.tensor([list(ids)], dtype=torch.int32)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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


def _copy_kv(dst: Dict, drow: int, src: Dict, srow: int, n: int) -> None:
    """Row `srow` of the dense cache `src` into row `drow` of `dst`, in
    place: the first `n` entries of every layer's K/V and the whole
    kv_pos row (the rest of the K/V row is read only where kv_pos says
    it was written); of split caches, each rank's."""
    if is_merged(dst):
        for d, s in zip(dst["shards"], src["shards"]):
            _copy_kv(d, drow, s, srow, n)
        return
    for name in ("k", "v"):
        if name in dst and n:
            dst[name][:, drow, :n] = src[name][:, srow, :n]
    dst["kv_pos"][drow] = src["kv_pos"][srow]


def _dense_step(work: Dict, cache: Dict, row: int) -> Dict:
    """What a dense chunk's graph runs on: the static working cache
    `work` (K/V and kv_pos, written in place) with the cursor and SSM
    and conv states of row `row` of `cache` (copied in by the runner);
    of split caches, each rank's."""
    if is_merged(work):
        return dict(work, shards=[_dense_step(w, c, row) for w, c in zip(
            work["shards"], cache["shards"])])
    step = dict(work)
    step.update({name: t for name, t in cache_row(cache, row).items()
                 if name not in IN_PLACE})
    return step


def _set_row(cache: Dict, row: int, new: Dict) -> None:
    """Write a batch-1 step's new cursor and SSM and conv states into
    row `row` of the dense batch cache `cache`, in place (split caches:
    each rank's)."""
    if is_merged(cache):
        for c, n in zip(cache["shards"], new["shards"]):
            _set_row(c, row, n)
        return
    view = cache_row(cache, row)
    for name, t in new.items():
        if name not in IN_PLACE:
            view[name].copy_(t)


@dataclasses.dataclass
class PageHandoff:
    """Block-granular prefill→decode KV payload (`paged_gather_blocks`
    output, nbt-padded): only the pages the prompt occupies travel, not a
    max_len dense cache.  `n_tokens` is the prompt length the payload
    covers (payload row i holds tokens [i·bs, (i+1)·bs))."""
    payload: Dict
    n_tokens: int


@dataclasses.dataclass
class GenState:
    """Per-request generation context carried across the P/D handoff.
    `cache` is a parked dense batch-1 cache (a dense prefill, a drain or
    a preemption re-park), a `PageHandoff` (page-native prefill), or None
    while resident."""
    rid: int
    cache: Optional[Any]
    tokens: List[int]


class KVHandoffBus:
    """Generation-state registry (one per deployment).  The prefill plane
    publishes a finished request's cache + first token (the unified plane
    only the first token); the decode plane takes the cache at join time;
    a drained or preempted request's cache is parked here until it
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
    re-raised on the runtime thread by the next start/finish call.
    `_inflight` is set once the last submitted job has returned."""

    def __init__(self, tag: str):
        self._tag = tag
        self._worker: Optional[_Worker] = None
        self._error: Optional[BaseException] = None
        self._inflight: Optional[threading.Event] = None

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

    def _submit(self, job) -> None:
        """Run `job` on the worker; a fresh `_inflight` event is set when
        it returns (runtime thread only)."""
        done = threading.Event()
        self._inflight = done

        def run():
            try:
                job()
            finally:
                done.set()
        self._worker.submit(run)

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ---------------------------------------------------------------------------
# Real prefill (dense and page-native)
# ---------------------------------------------------------------------------


class _DenseRows:
    """A dense prefill engine's pool of max_len-wide rows: batch caches
    of `n` rows each (the reference allocates a batch-1 cache per
    request; a graph holds raw addresses, so the port keeps the rows and
    copies a finished prompt out).  A request takes a row at its first
    chunk; when none is free a further batch cache of `n` rows is
    allocated (`grown` counts those), so a row is never waited for.
    A released row is reset in place (`cache_clear_row`)."""

    def __init__(self, spec: EngineSpec, n: int):
        self.spec = spec
        self.n = n
        self.caches: List[Dict] = []
        self.free: List[Tuple[int, int]] = []
        self.grown = 0
        self._add()

    def _add(self) -> None:
        self.caches.append(self.spec.request_cache(self.n))
        b = len(self.caches) - 1
        self.free.extend((b, i) for i in reversed(range(self.n)))

    def take(self) -> Tuple[int, int]:
        """A free row: (batch cache index, row)."""
        if not self.free:
            self._add()
            self.grown += 1
        return self.free.pop()

    def release(self, row: Tuple[int, int]) -> None:
        cache_clear_row(self.caches[row[0]], row[1])
        self.free.append(row)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for c in self.caches
                   for s in (c["shards"] if is_merged(c) else [c])
                   for t in s.values())


class _PrefillCtx:
    """Model-side state of one in-flight dense prefill: its row of the
    engine's `_DenseRows` ((batch cache index, row))."""

    def __init__(self, row: Tuple[int, int]):
        self.row = row
        self.consumed = 0
        self.first_token: Optional[int] = None


class _PagedPrefillCtx:
    """Model-side state of one PAGE-NATIVE prefill: a row of the
    engine-shared paged cache plus the request's block table.  `slot` is
    None until the engine stages the request (allocates its fresh blocks
    and installs its table row); a full-prefix cache hit never stages —
    `consumed` starts at `input_len` and the stored first token replays."""

    def __init__(self, table: List[int], claimed: int,
                 first_token: Optional[int] = None):
        self.slot: Optional[int] = None
        self.table = table          # physical blocks (claimed prefix first)
        self.claimed = claimed      # prefix tokens resolved from cache
        self.consumed = claimed     # prompt tokens whose KV is in pages
        self.first_token = first_token


class RealPrefillEngine(SimPrefillInstance, _WorkerOwner):
    """Chunked-prefill engine: scheduler-side queueing/batch-forming and
    EndForward bookkeeping are inherited from the simulated instance —
    only the pass execution differs (`prefill_chunk` or
    `paged_prefill_step` on the worker thread instead of a cost-model
    duration).

    With `page_native=True` chunks write straight into `BlockPool` pages,
    and `share_prefix=True` adds a `PagePrefixBinder`: at enqueue time a
    new prompt's longest cached prefix is CLAIMED (refcounted pages, no
    copy) so its chunks are never computed.  The claim must equal the hit
    the scheduler credited — both sides resolve against the same binder
    in the same runtime-thread tick (`page_share.EngineBackedPrefixIndex`),
    so a mismatch is a wiring bug and raises."""

    def __init__(self, instance_id: int, dp_ids: Sequence[int], chunk: int,
                 spec: EngineSpec, bus: KVHandoffBus,
                 page_native: bool = False, share_prefix: bool = False,
                 cache_budget_tokens: Optional[int] = None):
        super().__init__(instance_id, dp_ids, chunk, cost=None)
        _WorkerOwner.__init__(self, f"prefill-{instance_id}")
        self.spec = spec
        self.bus = bus
        self._post = None
        self._ctx: Dict[int, _PrefillCtx] = {}
        self.page_native = bool(page_native)
        self.binder: Optional[PagePrefixBinder] = None
        if self.page_native:
            if not spec.prefix_sharable:
                raise ValueError(
                    "page_native prefill needs block_size > 0 and an "
                    "attention-only decoder-only config")
            self.pool = BlockPool(spec.paged_prefill_blocks, spec.block_size)
            self.cache = spec.prefill_paged_cache()
            if share_prefix:
                self.binder = PagePrefixBinder(
                    self.pool, budget_tokens=cache_budget_tokens)
            self._free_slots: List[int] = list(
                range(spec.paged_prefill_slots))
            self._pctx: Dict[int, _PagedPrefillCtx] = {}
            self.graphs = spec.step_graphs_for()
        elif share_prefix:
            raise ValueError("share_prefix requires page_native=True")
        else:
            self.rows = _DenseRows(spec, spec.paged_prefill_slots)
            # the spec's chunk graphs and their static batch-1 cache
            # (every chunk length's), shared by its dense prefill engines
            self.graphs, self._work = spec.dense_graphs()
        if self.graphs is not None:
            # capture the full chunk's graph now, before the runtime's
            # threads start; a prompt's last chunk (any shorter length)
            # is captured at that length's first use (dense: the first
            # use by any engine of the spec)
            tokens = torch.zeros((1, chunk), dtype=torch.int32,
                                 device=spec.device)
            if self.page_native:
                self.graphs.prepare(("prefill", 0, chunk), spec.prefill_fn,
                                    self.cache, tokens=tokens,
                                    slot=self._free_slots[-1])
            else:
                self.graphs.prepare(("prefill-dense", chunk),
                                    spec.prefill_chunk_fn,
                                    _dense_step(self._work,
                                                self.rows.caches[0], 0),
                                    tokens=tokens)
        # page-native stats (read after the run; only the worker writes
        # chunks_run, only the runtime thread writes full_hits)
        self.chunks_run = 0
        self.full_hits = 0

    # -- lifecycle -------------------------------------------------------
    def bind_loop(self, loop) -> None:
        self._post = loop.post

    # -- EnginePlane -----------------------------------------------------
    def enqueue(self, cmd: DispatchCommand, now: float) -> None:
        if self.page_native:
            for lst in cmd.assignments.values():
                for req, tok in lst:
                    if req.rid not in self._pctx:
                        self._claim_prefix(req, tok)
        super().enqueue(cmd, now)

    def _claim_prefix(self, req: Request, tok: int) -> None:
        """First sight of a request: resolve its cached prefix to pages.
        The scheduler already credited `expected` hit tokens (it granted
        `tok` now and debited `remaining_prefill` by grant + hit), so the
        engine-side claim must match exactly — the claimed chunks will
        never be granted again."""
        expected = req.input_len - req.remaining_prefill - tok
        toks = (req.tokens or ())[:req.input_len]
        if self.binder is not None and toks:
            claim, blocks, first = self.binder.claim(toks)
            self.binder.record(claim, req.input_len)
        else:
            claim, blocks, first = 0, [], None
        if claim != expected:
            raise RuntimeError(
                f"request {req.rid}: scheduler credited a {expected}-token "
                f"prefix hit but the engine binder resolved {claim} — "
                f"cache-aware dispatch on the real plane must match "
                f"through EngineBackedPrefixIndex")
        if claim >= req.input_len:
            self.full_hits += 1
        self._pctx[req.rid] = _PagedPrefillCtx(list(blocks), claim, first)

    def _stage(self, req: Request, ctx: _PagedPrefillCtx) -> bool:
        """Give an unstaged request a cache row + its fresh blocks, and
        install its table row and cursor.  Runs on the runtime thread with
        no pass in flight, so the cache mutation cannot race the worker.
        Returns False (leaving ctx untouched) under slot/page exhaustion —
        the caller requeues the request's chunks."""
        if not self._free_slots:
            return False
        need = self.pool.blocks_for(req.input_len) - len(ctx.table)
        if need > self.pool.free_count and self.binder is not None:
            self.binder.ensure_free(need)
        if need > self.pool.free_count:
            return False
        fresh = self.pool.alloc(need)
        ctx.table = ctx.table + fresh
        ctx.slot = self._free_slots.pop()
        cache = self.cache
        if fresh:
            # reused pages keep their previous tenant's kv_pos; any stale
            # pos <= the reader's cursor would alias as valid history
            cache = paged_clear_rows(cache, self.spec.table(fresh))
        self.cache = paged_install_row(cache, ctx.slot,
                                       self.spec.table(ctx.table),
                                       ctx.claimed)
        return True

    def start_pass(self, now: float) -> StartResult:
        self._raise_worker_error()
        with self.spec.device_lock():
            return self._start_pass(now)

    def _start_pass(self, now: float) -> StartResult:
        if self.page_native and not self.busy:
            # stage before batch-forming, in queue order, so _begin_pass
            # only hands the worker requests with a live cache row
            staged = set()
            for d in self.dp_ids:
                for req, _tok in self.queues[d]:
                    ctx = self._pctx.get(req.rid)
                    if (ctx is None or ctx.slot is not None
                            or ctx.consumed >= req.input_len
                            or req.rid in staged):
                        continue
                    if not self._stage(req, ctx):
                        break       # exhausted: later arrivals wait too
                    staged.add(req.rid)
        batch = self._begin_pass(now)
        if batch is None:
            return None
        if self.page_native:
            batch = self._strip_unstaged(batch)
            if batch is None:
                return None
        post = self._post        # bound per run: an abandoned job cannot
        self._submit(            # post into a later run's loop
            lambda: self._exec_pass(batch, post))
        return ASYNC

    def _strip_unstaged(self, batch: Dict[int, List[Tuple[Request, int]]]
                        ) -> Optional[Dict[int, List[Tuple[Request, int]]]]:
        """Drop batch items whose request has no cache row (page/slot
        exhaustion) and requeue them at the FRONT of their queue; roll
        the pass back entirely if nothing runnable remains.  Full-hit
        requests (consumed == input_len, slot None) always stay — their
        zero-token markers complete without touching the device."""
        kept: Dict[int, List[Tuple[Request, int]]] = {}
        dropped = 0
        for d, taken in batch.items():
            keep: List[Tuple[Request, int]] = []
            back: List[Tuple[Request, int]] = []
            for req, tok in taken:
                ctx = self._pctx[req.rid]
                if ctx.slot is None and ctx.consumed < req.input_len:
                    back.append((req, tok))
                else:
                    keep.append((req, tok))
            if keep:
                kept[d] = keep
            for item in reversed(back):
                self.queues[d].appendleft(item)
            dropped += len(back)
        if not kept:
            # nothing runnable: undo _begin_pass bookkeeping and idle
            self._current = None
            self.busy = False
            self.passes -= 1
            self.capacity_offered -= len(self.dp_ids) * self.chunk
            return None
        if dropped:
            self._current = kept
        return kept

    def _exec_pass(self, batch: Dict[int, List[Tuple[Request, int]]],
                   post) -> None:
        # worker thread: pure model execution on engine-private contexts
        try:
            for taken in batch.values():
                for req, tok in taken:
                    with self.spec.device_lock():
                        self._run_chunk(req, tok)
        except BaseException as e:      # surface on the runtime thread
            self._error = e
        post("pass_end", self)

    def _run_chunk(self, req: Request, tok: int) -> None:
        if self.page_native:
            self._run_chunk_paged(req, tok)
            return
        ctx = self._ctx.get(req.rid)
        if ctx is None:
            ctx = self._ctx[req.rid] = _PrefillCtx(self.rows.take())
        ids = (req.tokens or ())[ctx.consumed: ctx.consumed + tok]
        if ids:
            arr = self.spec.upload(ids)
            b, row = ctx.row
            logits = self.spec.dense_prefill(
                self.graphs, arr, self.rows.caches[b], row, ctx.consumed,
                self._work)
            ctx.consumed += len(ids)
            if ctx.consumed >= req.input_len and ctx.first_token is None:
                # a host sync: the row is complete once this returns
                ctx.first_token = int(logits[0].argmax())

    def _run_chunk_paged(self, req: Request, tok: int) -> None:
        # worker thread: extend the request's cache row in place; the
        # engine-shared cache is only rebound here and, with no pass in
        # flight, on the runtime thread (_stage, _complete_paged)
        ctx = self._pctx[req.rid]
        ids = (req.tokens or ())[ctx.consumed: ctx.consumed + tok]
        if not ids:
            return
        arr = self.spec.upload(ids)
        logits, self.cache = self.spec.paged_prefill(self.graphs, arr,
                                                     self.cache, ctx.slot)
        self.chunks_run += 1
        ctx.consumed += len(ids)
        if ctx.consumed >= req.input_len and ctx.first_token is None:
            ctx.first_token = int(logits[0].argmax())

    def finish_pass(self, now: float) -> PassResult:
        self._raise_worker_error()
        res = super().finish_pass(now)
        with self.spec.device_lock():
            self._publish(res.completed)
        return res

    def _publish(self, completed: Sequence[Request]) -> None:
        for req in completed:
            if self.page_native:
                self._complete_paged(req)
                continue
            ctx = self._ctx.pop(req.rid, None)
            if ctx is None or ctx.first_token is None:
                raise RuntimeError(
                    f"request {req.rid} completed prefill without model "
                    f"state (tokens shorter than input_len?)")
            # the paper's KV transfer: park a copy of the row + the first
            # token on the bus (the bus never holds a pool row), then
            # reset the row for its next tenant
            b, row = ctx.row
            self.bus.publish(req.rid, cache_take(self.rows.caches[b], row),
                             ctx.first_token)
            self.rows.release(ctx.row)
            req.generated = 1

    def _complete_paged(self, req: Request) -> None:
        """Page-native completion: gather ONLY the prompt's pages as the
        handoff payload, publish the pages into the prefix cache, then
        release the engine's row and references.  Ordering matters: the
        gather copies page contents before any free (a later tenant of a
        freed page writes it in place); `binder.insert` increfs newly
        bound pages before the engine's own references are dropped, so
        published pages never transit refcount 0."""
        ctx = self._pctx.pop(req.rid, None)
        if ctx is None or ctx.first_token is None:
            raise RuntimeError(
                f"request {req.rid} completed prefill without model "
                f"state (tokens shorter than input_len?)")
        payload = paged_gather_blocks(self.spec.cfg, self.cache,
                                      self.spec.table(ctx.table))
        self.bus.publish(req.rid, PageHandoff(payload, req.input_len),
                         ctx.first_token)
        req.generated = 1
        if self.binder is not None and req.tokens:
            # a prompt's pages are frozen from here on (prefill never
            # writes past input_len), so the partial tail is publishable
            # together with its first-token payload
            self.binder.insert(req.tokens[:req.input_len], ctx.table,
                               first_token=ctx.first_token)
        if ctx.slot is not None:
            self.cache = paged_cache_clear_slot(self.cache, ctx.slot)
            self._free_slots.append(ctx.slot)
        self.pool.free(ctx.table)


# ---------------------------------------------------------------------------
# Real decode (padded and paged)
# ---------------------------------------------------------------------------


class _DPDecodeState:
    """One DP unit's padded continuous batch: `max_batch` dense rows (the
    cache is allocated at the first join).  A free slot is the admission
    token."""

    def __init__(self, spec: EngineSpec, n_slots: Optional[int] = None):
        self.cache: Optional[Dict] = None
        n = n_slots if n_slots is not None else spec.max_batch
        self.slots: List[Optional[Request]] = [None] * n
        self.next_tok: List[int] = [0] * n

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def occupied(self) -> bool:
        return any(r is not None for r in self.slots)

    def can_admit(self, need_tokens: int, extra_blocks: int = 0,
                  shared_blocks: int = 0) -> bool:
        return self.free_slot() is not None

    def leave(self, rid: int, slot: int) -> None:
        """Free the row; it keeps stepping on garbage until the next join
        overwrites it whole."""
        self.slots[slot] = None


class _DPPagedState(_DPDecodeState):
    """One DP unit's paged continuous batch: `paged_slots` batch rows
    over a shared `BlockPool` (the cache is allocated at the first
    join).  Admission is by free-block count — a request's lifetime
    blocks are reserved at join and returned at leave/drain.

    With `share_prefix`, the unit also owns a `PagePrefixBinder`: joined
    prompts publish their pages, and later prompts with a matching prefix
    point at the resident pages instead of re-copying their handoff
    payload rows.  Pool pressure evicts cache entries before refusing an
    admission (`binder.ensure_free`)."""

    def __init__(self, spec: EngineSpec, share_prefix: bool = False):
        super().__init__(spec, n_slots=spec.paged_slots)
        self.pool = BlockPool(spec.paged_pool_blocks, spec.block_size)
        self.held: Dict[int, List[int]] = {}       # rid -> block ids
        self.binder: Optional[PagePrefixBinder] = (
            PagePrefixBinder(self.pool) if share_prefix else None)

    def can_admit(self, need_tokens: int, extra_blocks: int = 0,
                  shared_blocks: int = 0) -> bool:
        need = self.pool.blocks_for(need_tokens)
        if need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request needs {need} blocks, pool holds only "
                f"{self.pool.num_blocks - 1} — raise max_len/pool_blocks")
        # `shared_blocks` prefix pages are already claimed (refs held):
        # they will be pointed at, never allocated, so only the remainder
        # must come out of the free store
        need -= shared_blocks
        if self.binder is not None:
            self.binder.ensure_free(need + extra_blocks)
        return (self.free_slot() is not None
                and need + extra_blocks <= self.pool.free_count)

    def leave(self, rid: int, slot: int) -> None:
        """Drop the slot's table row FIRST (the inactive slot keeps
        stepping on garbage, which must route to the null block), then
        return its pages."""
        self.cache = paged_cache_clear_slot(self.cache, slot)
        self.slots[slot] = None
        self.pool.free(self.held.pop(rid))


class _ShardedGroup:
    """Instance-wide device state of the SHARDED decode plane: ONE merged
    paged cache (slot s ↔ DP s // paged_slots, physical block b ↔ DP
    b // paged_pool_blocks), one shard per data rank on its device.  A
    step is a single cross-DP step: the paper's DP sync barrier is the
    step's own EP exchanges, not the worker's serial per-DP job loop the
    single-device plane approximates it with."""

    def __init__(self, spec: EngineSpec):
        n = spec.n_dp
        self.cache: Dict = spec.merged_paged_cache()
        self.slots: List[Optional[Request]] = [None] * (n * spec.paged_slots)
        self.next_tok: List[int] = [0] * (n * spec.paged_slots)


class _DPShardedState(_DPPagedState):
    """One DP unit's VIEW of the merged sharded cache.  Admission control
    stays strictly per-DP — the `BlockPool` hands out GLOBAL block ids
    from this DP's base-offset range, `free_slot` scans this DP's global
    slot range, the optional prefix binder is private — while `cache`
    reads and writes through to the shared group (as the merged cache
    with "home": this DP's shard, which the page surgery of
    `models.model` works on), so the inherited joins, leaves and
    `finish_step` work unchanged."""

    def __init__(self, spec: EngineSpec, group: _ShardedGroup, k: int,
                 share_prefix: bool = False):
        self.group = group
        self.k = k
        S = spec.paged_slots
        self.lo, self.hi = k * S, (k + 1) * S
        self.slots = group.slots            # SHARED global slot list
        self.next_tok = group.next_tok      # SHARED global feed tokens
        self.pool = BlockPool(spec.paged_pool_blocks, spec.block_size,
                              base=k * spec.paged_pool_blocks)
        self.held: Dict[int, List[int]] = {}
        self.binder: Optional[PagePrefixBinder] = (
            PagePrefixBinder(self.pool) if share_prefix else None)

    @property
    def cache(self) -> Dict:
        return dict(self.group.cache, home=self.k)

    @cache.setter
    def cache(self, value: Dict) -> None:
        self.group.cache = {n: v for n, v in value.items() if n != "home"}

    def free_slot(self) -> Optional[int]:
        for i in range(self.lo, self.hi):
            if self.slots[i] is None:
                return i
        return None

    def occupied(self) -> bool:
        return any(r is not None for r in self.slots[self.lo:self.hi])


class RealDecodeEngine(SimDecodeInstance, _WorkerOwner):
    """Continuous batched decode: join-on-handoff / leave-on-finish per
    step.  Request/DPState bookkeeping is inherited from the simulated
    instance; this class adds the padded or paged caches and the real
    step."""

    drain_wait_s = 30.0     # longest drain() waits for an in-flight step

    def __init__(self, instance_id: int, dp_ids: Sequence[int],
                 spec: EngineSpec, bus: KVHandoffBus,
                 share_prefix: bool = False):
        super().__init__(instance_id, dp_ids, cost=None)
        _WorkerOwner.__init__(self, f"decode-{instance_id}")
        self.spec = spec
        self.bus = bus
        self._post = None
        if share_prefix and not spec.prefix_sharable:
            raise ValueError(
                "share_prefix requires a paged attention-only config")
        self._group: Optional[_ShardedGroup] = None
        if spec.sharded:
            if len(dp_ids) != spec.n_dp:
                raise ValueError(
                    f"a sharded decode instance must own exactly the "
                    f"mesh's data axis: {len(dp_ids)} dp_ids vs "
                    f"data={spec.n_dp}")
            self._group = _ShardedGroup(spec)
            self._dp: Dict[int, _DPDecodeState] = {
                d: _DPShardedState(spec, self._group, k,
                                   share_prefix=share_prefix)
                for k, d in enumerate(dp_ids)}
        else:
            self._dp = {
                d: (_DPPagedState(spec, share_prefix=share_prefix)
                    if spec.paged else _DPDecodeState(spec))
                for d in dp_ids}
        self._pending: List[Tuple[int, Request]] = []
        self._deferred: set = set()   # rids whose join failed can_admit
        self._slot_of: Dict[int, Tuple[int, int]] = {}   # rid -> (dp, slot)
        self._participants: Dict[int, List[Tuple[Request, int]]] = {}
        self._result: Optional[Dict[int, Tuple[Dict, List[int]]]] = None
        self._join_finished: List[Request] = []
        self.peak_resident = 0      # max concurrent resident requests
        self.cow_copies = 0         # eager tail copy-on-writes at join
        self.blocks_shared = 0      # payload rows skipped via shared pages
        # per-step samples (worker appends, read after the run):
        # (wall seconds, active decode rows, cache rows stepped)
        self.step_samples: List[Tuple[float, int, int]] = []
        # sharded: (EP exchanges, bytes between EP ranks, their device
        # seconds on the card, else None) of each step, beside its
        # step_samples entry; and the TP collectives of each step ({kind:
        # calls}, bytes between model ranks)
        self.ep_samples: List[Tuple[int, int, Optional[float]]] = []
        self.tp_samples: List[Tuple[Dict[str, int], int]] = []
        self._tp_stats = None
        self._step_active = 0
        self._step_rows = 0
        self.graphs = spec.step_graphs_for()
        if self.graphs is not None and self.graphs.cuda:
            # capture every DP's decode step now (the sharded plane: the
            # merged step over every DP's rows), before the runtime's
            # threads start (on the CPU the static buffers are made at
            # the first step, on the cache the DP has then)
            if self._group is not None:
                self._prepare_decode(-1, self._group)
            else:
                for d, st in self._dp.items():
                    st.cache = (spec.paged_cache() if spec.paged
                                else spec.batch_cache())
                    self._prepare_decode(d, st)

    @staticmethod
    def _decode_key(dp_id: int) -> Tuple:
        """The decode graph of DP `dp_id`; -1 is the sharded plane's
        merged job."""
        return ("decode", "merged" if dp_id < 0 else dp_id)

    def _prepare_decode(self, dp_id: int, st) -> None:
        self.graphs.prepare(self._decode_key(dp_id), self.spec.decode_fn,
                            st.cache, token=self._feed_tokens(st))

    def _decode(self, dp_id: int, cache: Dict, toks):
        """One batched decode step of DP `dp_id` (-1: the merged job): its
        graph, or the eager step."""
        if self.graphs is None:
            return self.spec.decode_fn(cache, toks)
        return self.graphs.run(self._decode_key(dp_id), self.spec.decode_fn,
                               cache, token=toks)

    # -- lifecycle -------------------------------------------------------
    def bind_loop(self, loop) -> None:
        self._post = loop.post

    # -- EnginePlane -----------------------------------------------------
    def free_kv_tokens(self, dp_id: int,
                       tokens: Optional[Sequence[int]] = None
                       ) -> Optional[int]:
        st = self._dp[dp_id]
        if self.spec.paged:
            free = st.pool.free_count * self.spec.block_size
            if tokens and st.binder is not None:
                # credit the claimable block-aligned prefix already
                # resident in this DP's binder: those pages will be
                # POINTED AT, not allocated, so they are headroom for
                # this prompt even though the pool holds them (the same
                # credit EngineBackedPrefixIndex grants at dispatch)
                claim, _full = st.binder.peek(tokens)
                free += st.pool.blocks_for(claim) * self.spec.block_size
            return free
        return sum(1 for r in st.slots if r is None) * self.spec.max_len

    def admit(self, dp_id: int, req: Request) -> None:
        # buffered: joins are applied between steps (start_step), never
        # while a worker-thread step is in flight
        self._pending.append((dp_id, req))

    def pending_waits(self) -> List[Request]:
        """Joins deferred by device-side capacity: the real plane's
        overload signal, on which the runtime preempts residents."""
        return [r for _, r in self._pending if r.rid in self._deferred]

    def _take(self, st: _DPDecodeState, slot: int) -> Dict:
        """Slot `slot`'s KV as a new dense batch-1 cache (parked on the
        bus by preemption and drain)."""
        if self.spec.paged:
            return paged_cache_take(self.spec.cfg, st.cache, slot)
        return cache_take(st.cache, slot)

    def preempt(self, rid: int) -> Optional[Request]:
        """Request-level preemption: park the victim's KV on the bus as a
        dense batch-1 cache and free its slot (paged: and its pages; a
        shared page only loses this row's reference).  Re-admission goes
        through the normal join path — a re-parked cache is NOT a
        `PageHandoff`, so it re-joins through `paged_cache_join` with its
        generated KV intact.  Refused (None) while a worker step is in
        flight."""
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
        with self.spec.device_lock():
            self.bus.gen(rid).cache = self._take(st, slot)
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
        """Join parked requests (a dense batch-1 cache or a `PageHandoff`
        on the bus) into a free slot (paged: with their lifetime pages);
        retry next step when the DP's slots or pool are full."""
        by_id = {s.dp_id: s for s in dp_states}
        still: List[Tuple[int, Request]] = []
        for dp_id, req in self._pending:
            st = self._dp[dp_id]
            gen = self.bus.gen(req.rid)
            if req.generated >= self._target_len(req):
                self._finish_at_join(now, by_id, dp_id, req, gen)
                continue
            # padded: admission token = a free slot; paged: a free slot
            # AND the request's lifetime blocks (reserved up front so a
            # resident request never stalls mid-generation on a page;
            # share_prefix holds one block of slack for the eager tail
            # copy-on-write in _join_pages)
            life = self.spec.lifetime_tokens(req)
            use_binder = (self.spec.paged and st.binder is not None
                          and st.pool.blocks_for(life)
                          < st.pool.num_blocks - 1)
            # CLAIM FIRST: take the refs on the resident prefix before
            # the admission check so (a) the check credits pages that
            # will be pointed at rather than allocated and (b)
            # ensure_free's LRU eviction can never free the pages between
            # the check and the join
            claim, shared = 0, []
            toks = (req.tokens or ())[:req.input_len]
            if (use_binder and toks
                    and isinstance(gen.cache, PageHandoff)):
                claim, shared, _first = st.binder.claim(toks)
            if not st.can_admit(life, extra_blocks=1 if use_binder else 0,
                                shared_blocks=len(shared)):
                if shared:
                    st.pool.free(shared)     # drop the claim's refs
                self._deferred.add(req.rid)
                still.append((dp_id, req))   # retry after this step
                continue
            self._deferred.discard(req.rid)
            slot = st.free_slot()
            if st.cache is None:
                st.cache = (self.spec.paged_cache() if self.spec.paged
                            else self.spec.batch_cache())
            if self.spec.paged and isinstance(gen.cache, PageHandoff):
                self._join_pages(st, gen, req, slot, use_binder,
                                 claim, shared)
            elif self.spec.paged:
                ids = st.pool.alloc(st.pool.blocks_for(life))
                st.held[req.rid] = ids
                st.cache = paged_cache_join(self.spec.cfg, st.cache,
                                            gen.cache, slot,
                                            self.spec.table(ids))
            else:
                st.cache = cache_join(st.cache, gen.cache, slot)
            gen.cache = None        # resident now; parked copy released
            st.slots[slot] = req
            st.next_tok[slot] = gen.tokens[-1]
            self._slot_of[req.rid] = (dp_id, slot)
            self.running[dp_id].append(req)
            self.peak_resident = max(self.peak_resident, len(self._slot_of))
        self._pending = still

    def _join_pages(self, st: _DPPagedState, gen: GenState, req: Request,
                    slot: int, use_binder: bool,
                    claim: int = 0, shared: Sequence[int] = ()) -> None:
        """Adopt a `PageHandoff` into this DP: prefix blocks already
        resident (binder claim — taken by the CALLER before the admission
        check, refs held) are POINTED AT, the rest of the payload is
        copied into fresh blocks, growth blocks get their stale kv_pos
        cleared.  Then the prompt's pages are published into the DP's own
        prefix cache; binding makes the partial tail block shared, and
        the request's first decode write lands exactly there — so the
        copy-on-write divergence is handled EAGERLY, now, while no step
        is in flight, leaving the cached tail frozen at input_len."""
        ph: PageHandoff = gen.cache
        cfg, bs = self.spec.cfg, self.spec.block_size
        toks = (req.tokens or ())[:req.input_len]
        n_all = st.pool.blocks_for(self.spec.lifetime_tokens(req))
        n_payload = st.pool.blocks_for(req.input_len)
        if use_binder and toks:
            # hit stats recorded only on a successful join — a deferred
            # admission must not double-count its retries
            st.binder.record(claim, req.input_len)
        n_shared = len(shared)
        self.blocks_shared += n_shared
        table = list(shared) + st.pool.alloc(n_all - n_shared)
        st.held[req.rid] = table
        idx = torch.arange(self.spec.nbt, device=self.spec.device)
        copy_mask = (idx >= n_shared) & (idx < n_payload)
        clear_mask = (idx >= n_payload) & (idx < n_all)
        st.cache = paged_adopt_blocks(cfg, st.cache, ph.payload, slot,
                                      self.spec.table(table), copy_mask,
                                      clear_mask, req.input_len)
        if not use_binder or not toks:
            return
        st.binder.insert(toks, table[:n_payload],
                         first_token=gen.tokens[0])
        lw = req.input_len // bs
        if req.input_len % bs and st.pool.is_shared(table[lw]):
            # eager COW: the admission slack block becomes the private
            # tail; the cached copy stays frozen for future exact hits
            new = st.pool.alloc(1)[0]
            old = table[lw]
            cache = paged_copy_block(cfg, st.cache, old, new)
            st.cache = paged_set_table(cache, slot, lw, new)
            table[lw] = new
            st.pool.free([old])
            self.cow_copies += 1

    def _feed_tokens(self, st):
        """Each row's next token, (rows, 1) int32 on the spec's device; for
        the sharded group one (S, 1) tensor a shard, on its device (the
        merged step's static inputs)."""
        rows = [[t] for t in st.next_tok]
        if isinstance(st, _ShardedGroup):
            return self._per_shard(rows, torch.int32)
        return torch.tensor(rows, dtype=torch.int32, device=self.spec.device)

    def _per_shard(self, rows: List, dtype) -> List[torch.Tensor]:
        """Values of the merged slot axis as one tensor a shard (its DP's
        paged_slots rows) on the shard's device."""
        S = self.spec.paged_slots
        M = model_size(self.spec.mesh)
        return [torch.tensor(rows[i // M * S:(i // M + 1) * S], dtype=dtype,
                             device=dev)
                for i, dev in enumerate(self.spec.mesh.devices)]

    def start_step(self, dp_states, now: Optional[float] = None
                   ) -> StartResult:
        self._raise_worker_error()
        if self.busy:
            return None
        if self._pending:
            with self.spec.device_lock():
                self._apply_joins(now if now is not None else 0.0,
                                  dp_states)
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
            if self._group is None:
                jobs.append((d, st.cache, self._feed_tokens(st)))
        g = self._group
        if g is not None and self._participants:
            # the instance sync barrier lives INSIDE the step: one step
            # over the merged cache advances every DP's rows under the
            # same exchanges (dp_id -1 marks the merged job)
            jobs.append((-1, g.cache, self._feed_tokens(g)))
        self._step_active = sum(len(v) for v in self._participants.values())
        self._step_rows = (len(g.slots) if g is not None
                           else sum(len(self._dp[d].slots)
                                    for d in self._participants))
        epoch = self.epoch
        post = self._post
        self._submit(lambda: self._exec_step(jobs, epoch, post))
        return ASYNC

    def _exec_step(self, jobs, epoch: int, post) -> None:
        # worker thread: one batched decode step per occupied DP (the
        # instance-level sync barrier = all DPs in one serial job), or
        # one merged cross-DP step on the sharded plane
        t0 = time.monotonic()
        with self._counted() as ep:
            try:
                res: Dict[int, Tuple[Dict, List[int]]] = {}
                for dp_id, cache, toks in jobs:
                    with self.spec.device_lock():
                        logits, new_cache = self._decode(dp_id, cache, toks)
                        # a host sync: the step's cache writes are done
                        nxt = logits.argmax(dim=-1).tolist()
                    if dp_id < 0:
                        # merged job: slots are global, so the same
                        # (cache, next tokens) pair fans back to every
                        # participating DP
                        for d in self._participants:
                            res[d] = (new_cache, nxt)
                    else:
                        res[dp_id] = (new_cache, nxt)
                self._result = res
            except BaseException as e:      # surface on the runtime thread
                self._error = e
        self._sample(time.monotonic() - t0, ep)
        post("step_end", (self, epoch, self.step_samples[-1][0]))

    @contextlib.contextmanager
    def _counted(self):
        """Counts the EP exchanges and the TP collectives of a sharded
        step, and on the card times the exchanges of an eager step (a
        replayed graph records no event); yields the exchange counts
        (None off the sharded plane)."""
        if self._group is None:
            yield None
            return
        with count_exchanges(timed=self.spec.device.type == "cuda"
                             and self.graphs is None) as ep, \
                count_collectives() as tp:
            self._tp_stats = tp
            yield ep

    def _sample(self, dur: float, ep) -> None:
        self.step_samples.append((dur, self._step_active, self._step_rows))
        if ep is not None:
            self.ep_samples.append((ep.exchanges, ep.bytes,
                                    ep.seconds() if self._error is None
                                    else None))
            tp = self._tp_stats
            self.tp_samples.append((dict(tp.calls), tp.bytes))

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
        with self.spec.device_lock():
            for req in finished:
                dp_id, slot = self._slot_of.pop(req.rid)
                self._dp[dp_id].leave(req.rid, slot)     # leave-on-finish
        if self._join_finished:
            # requests satisfied at join time (never occupied a slot):
            # report them with this step's completions
            finished = self._join_finished + finished
            self._join_finished = []
        return finished

    def _settle(self) -> None:
        """Wait, at most `drain_wait_s`, for the in-flight step to return:
        it writes the caches in place, so no slot or page it can still
        write may be handed back.  A step that does not return (a wedged
        worker) raises rather than leave corrupted caches behind."""
        done = self._inflight
        if self.busy and done is not None \
                and not done.wait(self.drain_wait_s):
            raise RuntimeError(
                f"decode instance {self.instance_id}: the in-flight step "
                f"did not return within {self.drain_wait_s} s; refusing "
                f"to drain caches it may still write")

    def drain(self) -> Dict[int, List[Request]]:
        self._settle()
        out = super().drain()   # clears running, bumps epoch, unlocks
        # migrate resident KV back to the bus (the pre-step snapshot: the
        # settled step's result is dropped) so re-dispatch can re-join
        # the requests, with their generation state, on a healthy instance
        with self.spec.device_lock():
            for rid, (dp_id, slot) in list(self._slot_of.items()):
                st = self._dp[dp_id]
                self.bus.gen(rid).cache = self._take(st, slot)
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
                 starve_limit: int = 4, piggyback: bool = True,
                 share_prefix: bool = False):
        if not spec.paged:
            raise ValueError(
                "the unified mixed-batch engine needs a paged spec "
                "(block_size > 0)")
        _require_pageable_prefill(spec.cfg)
        super().__init__(instance_id, dp_ids, spec, bus,
                         share_prefix=share_prefix)
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
        self.forced_grants = 0      # starvation-bound activations
        self.mixed_steps = 0        # steps that ran decode+prefill fused

    def _prepare_decode(self, dp_id: int, st) -> None:
        # one graph per DP (the sharded plane: one merged graph) for both
        # decode branches: the decode half of mixed_step, with every row
        # masked in when nothing prefills
        self.graphs.prepare(self._decode_key(dp_id),
                            self.spec.masked_decode_fn, st.cache,
                            token=self._feed_tokens(st),
                            mask=self._all_rows(st))

    def _decode_masked(self, dp_id: int, token, cache: Dict, mask):
        """The decode half of DP `dp_id`'s mixed step (-1: the merged
        job): its graph, or the eager step."""
        if self.graphs is None:
            return self.spec.masked_decode_fn(cache, token, mask)
        return self.graphs.run(self._decode_key(dp_id),
                               self.spec.masked_decode_fn, cache,
                               token=token, mask=mask)

    def _all_rows(self, st):
        if isinstance(st, _ShardedGroup):
            return self._per_shard([True] * len(st.slots), torch.bool)
        return torch.ones(len(st.slots), dtype=torch.bool,
                          device=self.spec.device)

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
            st.cache = paged_install_row(paged_clear_rows(st.cache, tab),
                                         slot, tab, 0)
            st.slots[slot] = req
            self._slot_of[req.rid] = (dp_id, slot)
            self._consumed[req.rid] = 0
            self.prefilling[dp_id].append(req)
            self.peak_resident = max(self.peak_resident, len(self._slot_of))
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
            self.forced_grants += 1
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
            with self.spec.device_lock():
                self._apply_joins(now if now is not None else 0.0,
                                  dp_states)
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
        if self._group is not None:
            jobs = self._merge_sharded_jobs(jobs)
        self.busy = True
        self.steps += 1
        self._step_active = sum(len(v) for v in self._participants.values())
        self._step_rows = (
            len(self._group.slots) if self._group is not None
            else sum(len(self._dp[d].slots)
                     for d, _c, toks, _ch, _m in jobs if toks is not None))
        epoch = self.epoch
        post = self._post
        self._submit(lambda: self._exec_mixed(jobs, epoch, post))
        return ASYNC

    def _merge_sharded_jobs(self, jobs):
        """Collapse the per-DP mixed jobs into ONE cross-DP step over the
        merged cache: global decode-token rows, every DP's chunk grant in
        one tuple (slot ids are already global; grant order matches
        `self._grants` iteration order, which the fan-back in
        `_exec_mixed` relies on), one decode mask over the merged slot
        axis (as the tokens, one tensor a shard).  The mask is unconditional whenever anything decodes: all
        DPs share the one cache, so another DP's prefilling (or
        disjoint-stalled) resident rows must never see a decode write."""
        g = self._group
        chunks = tuple(c for _d, _c, _t, cs, _m in jobs for c in cs)
        if not self._participants:
            return [(-1, g.cache, None, chunks, None)]
        m = [False] * len(g.slots)
        for lst in self._participants.values():
            for _r, s in lst:
                m[s] = True
        return [(-1, g.cache, self._feed_tokens(g), chunks,
                 self._per_shard(m, torch.bool))]

    def _exec_mixed(self, jobs, epoch: int, post) -> None:
        # worker thread: one fused mixed step per DP with decode rows
        # (masked when prefilling residents share the cache), a plain
        # paged decode when nothing is prefilling, a serial chunk loop
        # when nothing is decoding; one merged job on the sharded plane
        t0 = time.monotonic()
        with self._counted() as ep:
            self._run_mixed(jobs)
        self._sample(time.monotonic() - t0, ep)
        post("step_end", (self, epoch, self.step_samples[-1][0]))

    def _run_mixed(self, jobs) -> None:
        cfg, params = self.spec.cfg, self.spec.params
        try:
            res: Dict[int, Tuple[Dict, List[int]]] = {}
            cres: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
            for dp_id, cache, toks, chunks, mask in jobs:
                nxt: List[int] = []

                def decode(token, c, m, _d=dp_id):
                    return self._decode_masked(_d, token, c, m)

                def prefill(ctoks, c, slot, _d=dp_id):
                    return self.spec.paged_prefill(self.graphs, ctoks, c,
                                                   slot, _d)
                with self.spec.device_lock():
                    if toks is None:
                        new_cache = cache
                        clogits = []
                        for ctoks, slot in chunks:
                            lg, new_cache = prefill(ctoks, new_cache, slot)
                            clogits.append(lg)
                    elif mask is not None or self.graphs is not None:
                        # with step graphs a plain decode step is the
                        # masked one with every row masked in (one graph
                        # per DP)
                        if mask is None:
                            mask = self._all_rows(self._dp[dp_id])
                        logits, clogits, new_cache = mixed_step(
                            cfg, params, toks, cache, chunks, mask, decode,
                            prefill)
                        if chunks:
                            self.mixed_steps += 1
                        nxt = logits.argmax(dim=-1).tolist()
                    else:
                        logits, new_cache = paged_decode_step(
                            cfg, params, toks, cache)
                        clogits = ()
                        nxt = logits.argmax(dim=-1).tolist()
                    # (first token, the logits it was sampled from)
                    firsts = [(int(lg[0].argmax()), lg[0]) for lg in clogits]
                if dp_id < 0:
                    # merged cross-DP job: one cache and next-token list
                    # fan back to every decoding DP (slots are global);
                    # the chunk firsts split by per-DP grant counts in
                    # the order _merge_sharded_jobs flattened them
                    i = 0
                    for d, lst in self._grants.items():
                        cres[d] = firsts[i:i + len(lst)]
                        i += len(lst)
                    for d in self._participants or self.dp_ids[:1]:
                        res[d] = (new_cache, nxt)
                    continue
                res[dp_id] = (new_cache, nxt)
                cres[dp_id] = firsts
            self._result = res
            self._chunk_result = cres
        except BaseException as e:      # surface on the runtime thread
            self._error = e

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
                    with self.spec.device_lock():
                        st.leave(req.rid, slot)
                    finished.append(req)
                else:
                    st.next_tok[slot] = first
                    self.running[d].append(req)
        return finished

    def drain(self) -> Dict[int, List[Request]]:
        # prefilling residents have no parked generation state: drop
        # their partial KV (pages back to the pool) and restart prefill
        # wherever re-dispatch lands them (after the in-flight step, which
        # writes their pages, has returned)
        self._settle()
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
                with self.spec.device_lock():
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
