"""Compiled serving steps: every decode step and every prefill chunk,
dense or page-native, replays a CUDA graph.

Counterpart of the jit lines of the reference's `EngineSpec.__post_init__`
(`repro/serving/real_engine.py`): there each step is one compiled XLA
program, traced once per shape, with `slot` a traced scalar.  Here each
engine owns a `StepGraphs`, and each step it runs through `run` is
captured once as a `torch.cuda.CUDAGraph` per key — (decode, DP unit),
whose rows and table width are fixed; (prefill, cache, chunk length),
since a prompt's last chunk can be any length (a page-native prefill
engine has one cache, the unified engine one per DP unit); or
(prefill-dense, chunk length), a dense prefill chunk over the engine's
static batch-1 working cache, into which `EngineSpec.dense_prefill`
copies a pool row's K/V and kv_pos before the replay and from which it
copies them back after — and replayed from then on.
All graphs of one engine share one memory pool a device: they replay
one at a time, on the engine's worker thread.  The dense chunks are
the exception: their graphs and working cache are the spec's
(`EngineSpec.dense_graphs`), as the reference compiles a chunk shape
once for all the engines of a spec, and each dense prefill engine
replays them through its own runner (`StepGraphs.share`: the same
graphs, pools and lock, counters of its own) under the spec's
`step_lock`.

A sharded spec's steps (the reference's mesh programs) run through the
same runner: the merged decode step, plain or masked, as ("decode",
"merged") over the merged cache, whose shards each get their own
static buffers and in-place addresses on their own device and whose
tokens and mask are one static tensor a shard; a page-native chunk as
("prefill", shard, chunk length) over its shard's cache with the slot
local to it; the dense chunk of a sharded P/D prefill engine as
("prefill-dense", chunk length).  Where every shard shares one device
(logical shards of one card) a step is one graph.  Where the shards
sit on several cards a step is captured in SEGMENTS, one graph a
device between two moves that cross devices (the EP exchanges, the EP
layer's token slices and combined rows, the logits' return;
`repro_torch.distributed.transfer`); a replay runs each segment's
graphs and then the copies of its moves into static receive buffers,
which the copies' events order on both devices' streams with no host
sync.  A step whose capture fails raises, on every layout.

A graph holds raw pointers, so a step's inputs live in STATIC buffers:

  * copied in before every replay: the tokens, the decode mask, the
    prefill slot, and the cache entries a step replaces rather than
    writes (`cur`, `block_tab`, the SSM and conv states), since joins,
    leaves and earlier steps hand the engine new tensors for them;
  * used in place: the K/V pools or dense K/V rows and the kv_pos map,
    which the step writes as in eager mode, and an encoder-decoder's
    per-slot encoder K/V, which it only reads.  At every replay each of
    them, and each weight, must be the storage the graph was captured
    on (its `data_ptr`); a mismatch raises (no silent re-capture, no
    eager fallback);
  * cloned out after the replay: the logits and every entry the step
    returns new (`cur`, SSM and conv states).  They are never copied
    into the pre-step cache's tensors: the watchdog's drain parks the
    PRE-step snapshot and relies on a step leaving `cur` and the SSM
    and conv states it read as they were.

The host sync (the caller's argmax) stays after the replay, outside the
graph, and nothing inside a step may sync: capture raises on one.  The
kernel wrappers' Python checks therefore run at capture only.  The
wrappers count their calls (`<wrapper>.launches`) and a replay makes
none, so each graph records the calls made while it was captured, adds
them at every replay, and takes back those of the warm-up and the
capture.  The EP exchanges and bytes a capture made are added to the
caller's `count_exchanges` block at every replay in the same way
(`models.moe_ep.add_exchanges`), and so are the tensor-parallel
collectives to its `count_collectives` block
(`distributed.transfer.add_collectives`).

Capture runs in `thread_local` error mode (across cards `relaxed`,
see `_Cuts`) on a side stream a device, under the
spec's `step_lock`, which every engine of the spec also holds while it
queues a step (the reference's `_mesh_lock`): the P/D server's prefill
and decode workers share the card's default stream from separate
threads.  Decode graphs and a prefill engine's full-chunk graph are
captured when the engine is built, before the runtime's threads start;
other prefill chunk lengths at their first use (a dense one at its
first use by any engine of the spec, so the servers a sweep builds on
one spec capture it once).  On the CPU nothing is
captured: the same static buffers are filled and the step function is
called on them, so the CPU parity tests run this buffer handling.  A spec with `step_graphs=False` does not use
this module (the eager path, kept for the A/B and the tests).
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import param_leaves
from repro_torch.distributed.transfer import (
    add_collectives, count_collectives, cutting,
)

# cache entries a step replaces (copied into static buffers) and entries
# it writes or reads in place (the same storage at every replay)
REPLACED = ("cur", "block_tab", "ssm", "conv_x", "conv_bc")
IN_PLACE = ("k", "v", "kv_pos", "enc_k", "enc_v")


def _wrappers() -> List:
    """The kernel wrappers whose `launches` counters a replay updates."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    return [paged_decode_attention, paged_prefill_attention, flash_prefill,
            decode_attention, ssd_chunk]


def _counts(wrappers) -> List[int]:
    return [w.launches for w in wrappers]


def settle_counts(wrappers, before: List[int], warm: List[int],
                  after: List[int]) -> List[int]:
    """After a capture whose warm-up ran between the counts `before` and
    `warm` and whose capture ran between `warm` and `after`: take both
    back from the wrappers' counters and return the calls one replay
    stands for (the capture's)."""
    for w, a, b in zip(wrappers, after, before):
        w.launches -= a - b
    return [a - m for a, m in zip(after, warm)]


def add_counts(wrappers, per_replay: List[int]) -> None:
    """Count one replay's wrapper calls."""
    for w, n in zip(wrappers, per_replay):
        w.launches += n


def _first_tensor(tree) -> torch.Tensor:
    """The first tensor of a cache (a merged cache: of its first shard)."""
    if isinstance(tree, torch.Tensor):
        return tree
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (torch.Tensor, dict, list, tuple)):
            return _first_tensor(v)
    raise ValueError("a step cache without tensors")


def _static(cache: Dict, ptrs: Dict, path: Tuple) -> Dict:
    """The static form of a step's cache: clones of the entries the step
    replaces, the caller's tensors for those it writes in place (their
    addresses noted in `ptrs` under `path` + name).  A merged cache
    ({"shards": [...], "slots", "blocks"[, "home"]}) keeps its ints and
    gets each shard's static form, on the shard's device."""
    if "shards" in cache:
        out: Dict = {}
        for name, v in cache.items():
            if name == "shards":
                out[name] = [_static(c, ptrs, path + (k,))
                             for k, c in enumerate(v)]
            elif isinstance(v, int):
                out[name] = v
            else:
                raise ValueError(f"merged cache entry {name!r} is not an "
                                 f"int")
        return out
    unknown = set(cache) - set(REPLACED) - set(IN_PLACE)
    if unknown:
        raise ValueError(f"cache entries {sorted(unknown)} are neither "
                         f"replaced nor written in place")
    out = {}
    for name, t in cache.items():
        if name in IN_PLACE:
            out[name] = t
            ptrs[path + (name,)] = t.data_ptr()
        else:
            out[name] = t.clone()
    return out


def _load(static: Dict, cache: Dict, ptrs: Dict, path: Tuple, tag) -> None:
    """Check `cache` against the static form and copy it in."""
    if set(cache) != set(static):
        raise RuntimeError(f"step {tag}: cache entries {sorted(cache)} "
                           f"differ from the capture's {sorted(static)}")
    where = f" of shard {path[-1]}" if path else ""
    if "shards" in static:
        if len(cache["shards"]) != len(static["shards"]):
            raise RuntimeError(f"step {tag}: {len(cache['shards'])} shards, "
                               f"captured with {len(static['shards'])}")
        for name, v in cache.items():
            if name != "shards" and v != static[name]:
                raise RuntimeError(f"step {tag}: merged cache {name}={v}, "
                                   f"captured with {static[name]}")
        for k, (s, c) in enumerate(zip(static["shards"], cache["shards"])):
            _load(s, c, ptrs, path + (k,), tag)
        return
    for name, t in cache.items():
        if name in IN_PLACE:
            if t.data_ptr() != ptrs[path + (name,)]:
                raise RuntimeError(
                    f"step {tag}: cache entry {name!r}{where} is not the "
                    f"storage the step was captured on")
        else:
            _copy(static[name], t, tag, name)


def _unload(out: Dict, static: Dict, cache: Dict) -> Dict:
    """The step's new cache: clones of what it computed, the caller's
    own tensors for what it passed through or wrote in place."""
    if "shards" in out:
        res = {name: v for name, v in out.items() if name != "shards"}
        res["shards"] = [_unload(o, s, c) for o, s, c in zip(
            out["shards"], static["shards"], cache["shards"])]
        return res
    res: Dict = {}
    for name, t in out.items():
        if t is static.get(name):
            res[name] = cache[name]       # passed through, or in place
        else:
            res[name] = t.clone()
    return res


class _Entry:
    """One captured step: its static inputs, the in-place tensors'
    addresses, the graphs and copies of its segments and its outputs
    (CUDA), and the wrapper calls and EP exchanges one replay stands
    for."""

    def __init__(self, cache: Dict, args: Dict):
        self.ptrs: Dict[Tuple, int] = {}
        self.cache = _static(cache, self.ptrs, ())
        self.args: Dict = {}
        for name, a in args.items():
            if isinstance(a, torch.Tensor):
                self.args[name] = a.clone()
            elif isinstance(a, (list, tuple)):   # one tensor a shard
                self.args[name] = [t.clone() for t in a]
            else:                       # an int (the prefill slot)
                self.args[name] = torch.full(
                    (1,), int(a), dtype=torch.long,
                    device=_first_tensor(cache).device)
        # [(one graph a device, the copies after them)], CUDA only
        self.segments: Optional[List[Tuple[List, List]]] = None
        self.out: Optional[Tuple] = None
        self.launches: List[int] = []
        self.exchanges: Tuple[int, int] = (0, 0)
        self.collectives: Tuple[Dict[str, int], int] = ({}, 0)

    def load(self, cache: Dict, args: Dict, tag) -> None:
        """Check the caller's inputs against the capture and copy them
        into the static buffers."""
        if set(args) != set(self.args):
            raise RuntimeError(f"step {tag}: inputs {sorted(args)} differ "
                               f"from the capture's {sorted(self.args)}")
        _load(self.cache, cache, self.ptrs, (), tag)
        for name, a in args.items():
            if isinstance(a, torch.Tensor):
                _copy(self.args[name], a, tag, name)
            elif isinstance(a, (list, tuple)):
                if len(a) != len(self.args[name]):
                    raise RuntimeError(f"step {tag}: {len(a)} tensors for "
                                       f"{name}, captured with "
                                       f"{len(self.args[name])}")
                for dst, src in zip(self.args[name], a):
                    _copy(dst, src, tag, name)
            else:
                self.args[name].fill_(int(a))

    def unload(self, cache: Dict, logits, out: Dict):
        """New tensors for what the step computed (clones of the graph's
        outputs); the caller's own tensors for what it passed through or
        wrote in place."""
        return logits.clone(), _unload(out, self.cache, cache)

    def replay(self) -> None:
        """Each segment's graphs (one a device), then its copies."""
        for graphs, copies in self.segments:
            for g in graphs:
                g.replay()
            for src, dst in copies:
                dst.copy_(src, non_blocking=True)


def _copy(dst: torch.Tensor, src: torch.Tensor, tag, name) -> None:
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise RuntimeError(
            f"step {tag}: {name} is {tuple(src.shape)} {src.dtype}, "
            f"captured as {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


class _Cuts:
    """The segments of one capture over `devices` (on one device a step
    is one segment): `begin` starts a graph on each device's capture
    stream, `cut`
    (called by `distributed.transfer.move` where a move crosses devices)
    ends them, makes a static receive buffer for each crossing tensor
    and records its copy, and begins the next segment's graphs.  Each
    graph first bumps its device's mark, so none is empty.  Across cards
    the captures run in `relaxed` error mode: ending one card's graph
    (which instantiates it) while the other cards' captures are still
    open is a call the stricter modes refuse."""

    def __init__(self, devices, pools: Dict, marks: Dict):
        self.devices = devices
        self.pools = pools
        self.marks = marks
        self.mode = "thread_local" if len(devices) == 1 else "relaxed"
        self.segments: List[Tuple[List, List]] = []
        self._open: List = []

    def begin(self) -> None:
        for d in self.devices:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.device(d):
                g.capture_begin(pool=self.pools[d],
                                capture_error_mode=self.mode)
            self._open.append((d, g))
            if d in self.marks:
                self.marks[d].add_(1)

    def _close(self) -> List:
        graphs = []
        for d, g in self._open:
            with torch.cuda.device(d):
                g.capture_end()
            graphs.append(g)
        self._open = []
        return graphs

    def cut(self, tensors: List[torch.Tensor], devices: List
            ) -> List[torch.Tensor]:
        graphs = self._close()
        out, copies = [], []
        for t, d in zip(tensors, devices):
            if t.device == d:
                out.append(t)
                continue
            buf = torch.empty_like(t, device=d)
            copies.append((t, buf))
            out.append(buf)
        self.segments.append((graphs, copies))
        self.begin()
        return out

    def end(self) -> None:
        self.segments.append((self._close(), []))

    def abandon(self) -> None:
        """End the open captures of a failed step (its own error is the
        one that matters)."""
        for d, g in self._open:
            try:
                with torch.cuda.device(d):
                    g.capture_end()
            except BaseException:
                pass
        self._open = []


class StepGraphs:
    """One engine's compiled steps (see the module note).

    `run(key, fn, cache, **args)` runs `fn(cache, **args) -> (logits,
    cache)` through the static buffers of `key`, capturing it on the
    key's first use on CUDA.  `devices` (default: `device` alone) are
    the distinct devices a step may touch (a sharded spec's mesh): with
    more than one, each step is captured in segments.  Counters for the
    serve reports: steps captured (`graphs`), CUDA graphs they hold
    (`segment_graphs`: one a step on one device), replays, seconds
    spent capturing (warm-up included), and the bytes of the graphs'
    memory pools (`pool_bytes`)."""

    def __init__(self, params, device: torch.device, lock: threading.RLock,
                 devices: Optional[Sequence] = None):
        self.params = params
        self.device = torch.device(device)
        self.devices: List[torch.device] = []
        for d in (devices or [self.device]):
            if torch.device(d) not in self.devices:
                self.devices.append(torch.device(d))
        self.lock = lock
        self.cuda = self.device.type == "cuda"
        self._entries: Dict = {}
        self._weights: Optional[List[int]] = None
        self._wrappers = _wrappers()
        self._pools: Dict = {}
        self._streams: Dict = {}
        self._marks: Dict = {}
        if self.cuda:
            for d in self.devices:
                self._pools[d] = torch.cuda.graph_pool_handle()
                self._streams[d] = torch.cuda.Stream(d)
                if len(self.devices) > 1:
                    self._marks[d] = torch.zeros(1, device=d)
        self.captured = 0
        self.replays = 0
        self.capture_s = 0.0
        self._owns_pools = True

    def share(self) -> "StepGraphs":
        """Another runner over this one's steps: the same captured graphs,
        static buffers, memory pools, streams and lock, with counters of
        its own and no pools of its own (`pool_bytes` 0).  A step either
        runner captures, both replay."""
        other = copy.copy(self)
        other.captured, other.replays, other.capture_s = 0, 0, 0.0
        other._owns_pools = False
        return other

    def pool_bytes(self) -> int:
        """Bytes of the segments the graphs' memory pools hold (0 for a
        runner made by `share`: the pools are its origin's)."""
        if not self.cuda or not self._owns_pools:
            return 0
        pools = {tuple(p) for p in self._pools.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)

    def stats(self) -> Dict:
        return {"graphs": self.captured, "replays": self.replays,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes(),
                "segment_graphs": sum(
                    len(g) for e in self._entries.values()
                    for g, _c in (e.segments or ()))}

    def prepare(self, key, fn: Callable, cache: Dict, **args) -> None:
        """Capture `key` now (the decode graphs, at engine build)."""
        with self.lock:
            if key not in self._entries:
                self._entries[key] = self._capture(key, fn, cache, args)

    def run(self, key, fn: Callable, cache: Dict, **args):
        """(logits, cache) of one step, as `fn(cache, **args)` returns
        them, through the static buffers of `key`."""
        from repro_torch.models.moe_ep import add_exchanges
        with self.lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = self._capture(key, fn, cache,
                                                           args)
            self._check_weights(key)
            entry.load(cache, args, key)
            if entry.segments is None:
                logits, out = fn(entry.cache, **entry.args)
            else:
                entry.replay()
                self.replays += 1
                add_counts(self._wrappers, entry.launches)
                add_exchanges(*entry.exchanges)
                add_collectives(*entry.collectives)
                logits, out = entry.out
            return entry.unload(cache, logits, out)

    def _check_weights(self, key) -> None:
        ptrs = [t.data_ptr() for t in param_leaves(self.params)]
        if self._weights is None:
            self._weights = ptrs
        elif ptrs != self._weights:
            raise RuntimeError(f"step {key}: the weights are not the "
                               f"storage the steps were captured on")

    @contextlib.contextmanager
    def _on_streams(self):
        """Every device's capture stream as its current stream."""
        with contextlib.ExitStack() as stack:
            for d in self.devices:
                stack.enter_context(torch.cuda.stream(self._streams[d]))
            yield

    def _capture(self, key, fn: Callable, cache: Dict, args: Dict) -> _Entry:
        from repro_torch.models.moe_ep import count_exchanges
        entry = _Entry(cache, args)
        if not self.cuda:
            return entry
        t0 = time.monotonic()
        self._check_weights(key)
        before = _counts(self._wrappers)
        cur = {d: torch.cuda.current_stream(d) for d in self.devices}
        for d in self.devices:
            self._streams[d].wait_stream(cur[d])
        # warm-up on the capture streams (lazy handles and workspaces),
        # on the inputs of the replay that follows: K/V it writes in
        # place are written again, with the same values, by that
        # replay; its exchanges and those of the capture are counted
        # apart from the caller's (a replay adds the capture's)
        with self._on_streams(), count_exchanges(), count_collectives():
            fn(entry.cache, **entry.args)
        warm = _counts(self._wrappers)
        cuts = _Cuts(self.devices, self._pools, self._marks)
        with self._on_streams(), count_exchanges() as ex, \
                count_collectives() as tp:
            cuts.begin()
            try:
                with cutting(cuts.cut):
                    out = fn(entry.cache, **entry.args)
            except BaseException:
                cuts.abandon()
                raise
            cuts.end()
        for d in self.devices:
            cur[d].wait_stream(self._streams[d])
        entry.launches = settle_counts(self._wrappers, before, warm,
                                       _counts(self._wrappers))
        entry.exchanges = (ex.exchanges, ex.bytes)
        entry.collectives = (dict(tp.calls), tp.bytes)
        entry.segments = cuts.segments
        entry.out = out
        self.captured += 1
        self.capture_s += time.monotonic() - t0
        return entry
