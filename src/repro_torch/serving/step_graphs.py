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
All graphs of one engine share one memory pool: they replay one at a
time, on the engine's worker thread.

A graph holds raw pointers, so a step's inputs live in STATIC buffers:

  * copied in before every replay: the tokens, the decode mask, the
    prefill slot, and the cache entries a step replaces rather than
    writes (`cur`, `block_tab`, the SSM and conv states), since joins,
    leaves and earlier steps hand the engine new tensors for them;
  * used in place: the K/V pools or dense K/V rows and the kv_pos map,
    which the step writes as in eager mode.  At every replay each of
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
capture.

Capture runs in `thread_local` error mode on a side stream, under the
spec's `step_lock`, which every engine of the spec also holds while it
queues a step (the reference's `_mesh_lock`): the P/D server's prefill
and decode workers share the card's default stream from separate
threads.  Decode graphs and a prefill engine's full-chunk graph are
captured when the engine is built, before the runtime's threads start;
other prefill chunk lengths at their first use.  On the CPU nothing is captured: the same static buffers are
filled and the step function is called on them, so the CPU parity tests
run this buffer handling.  A spec with `step_graphs=False` does not use
this module (the eager path, kept for the A/B and the tests).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# cache entries a step replaces (copied into static buffers) and entries
# it writes in place (the same storage at every replay)
REPLACED = ("cur", "block_tab", "ssm", "conv_x", "conv_bc")
IN_PLACE = ("k", "v", "kv_pos")


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


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of a params tree (dicts and lists), in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


class _Entry:
    """One captured step: its static inputs, the in-place tensors'
    addresses, the graph and its outputs (CUDA), and the wrapper calls
    one replay stands for."""

    def __init__(self, cache: Dict, args: Dict):
        unknown = set(cache) - set(REPLACED) - set(IN_PLACE)
        if unknown:
            raise ValueError(f"cache entries {sorted(unknown)} are neither "
                             f"replaced nor written in place")
        self.cache: Dict = {}
        self.ptrs: Dict[str, int] = {}
        for name, t in cache.items():
            if name in IN_PLACE:
                self.cache[name] = t
                self.ptrs[name] = t.data_ptr()
            else:
                self.cache[name] = t.clone()
        self.args: Dict = {}
        for name, a in args.items():
            if isinstance(a, torch.Tensor):
                self.args[name] = a.clone()
            else:                       # an int (the prefill slot)
                self.args[name] = torch.full(
                    (1,), int(a), dtype=torch.long,
                    device=next(iter(cache.values())).device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Tuple] = None
        self.launches: List[int] = []

    def load(self, cache: Dict, args: Dict, tag) -> None:
        """Check the caller's inputs against the capture and copy them
        into the static buffers."""
        if set(cache) != set(self.cache) or set(args) != set(self.args):
            raise RuntimeError(f"step {tag}: inputs {sorted(cache)}, "
                               f"{sorted(args)} differ from the capture's")
        for name, t in cache.items():
            if name in IN_PLACE:
                if t.data_ptr() != self.ptrs[name]:
                    raise RuntimeError(
                        f"step {tag}: cache entry {name!r} is not the "
                        f"storage the step was captured on")
            else:
                _copy(self.cache[name], t, tag, name)
        for name, a in args.items():
            if isinstance(a, torch.Tensor):
                _copy(self.args[name], a, tag, name)
            else:
                self.args[name].fill_(int(a))

    def unload(self, cache: Dict, logits, out: Dict):
        """New tensors for what the step computed (clones of the graph's
        outputs); the caller's own tensors for what it passed through or
        wrote in place."""
        res: Dict = {}
        for name, t in out.items():
            if t is self.cache.get(name):
                res[name] = cache[name]       # passed through, or in place
            else:
                res[name] = t.clone()
        return logits.clone(), res


def _copy(dst: torch.Tensor, src: torch.Tensor, tag, name) -> None:
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise RuntimeError(
            f"step {tag}: {name} is {tuple(src.shape)} {src.dtype}, "
            f"captured as {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


class StepGraphs:
    """One engine's compiled steps (see the module note).

    `run(key, fn, cache, **args)` runs `fn(cache, **args) -> (logits,
    cache)` through the static buffers of `key`, capturing it on the
    key's first use on CUDA.  Counters for the serve reports: graphs
    captured, replays, seconds spent capturing (warm-up included), and
    the bytes of the graphs' memory pool (`pool_bytes`)."""

    def __init__(self, params, device: torch.device, lock: threading.RLock):
        self.params = params
        self.device = torch.device(device)
        self.lock = lock
        self.cuda = self.device.type == "cuda"
        self._entries: Dict = {}
        self._weights: Optional[List[int]] = None
        self._wrappers = _wrappers()
        self._pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.captured = 0
        self.replays = 0
        self.capture_s = 0.0

    def pool_bytes(self) -> int:
        """Bytes of the segments the graphs' memory pool holds."""
        if not self.cuda:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    def stats(self) -> Dict:
        return {"graphs": self.captured, "replays": self.replays,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes()}

    def prepare(self, key, fn: Callable, cache: Dict, **args) -> None:
        """Capture `key` now (the decode graphs, at engine build)."""
        with self.lock:
            if key not in self._entries:
                self._entries[key] = self._capture(key, fn, cache, args)

    def run(self, key, fn: Callable, cache: Dict, **args):
        """(logits, cache) of one step, as `fn(cache, **args)` returns
        them, through the static buffers of `key`."""
        with self.lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = self._capture(key, fn, cache,
                                                           args)
            self._check_weights(key)
            entry.load(cache, args, key)
            if entry.graph is None:
                logits, out = fn(entry.cache, **entry.args)
            else:
                entry.graph.replay()
                self.replays += 1
                add_counts(self._wrappers, entry.launches)
                logits, out = entry.out
            return entry.unload(cache, logits, out)

    def _check_weights(self, key) -> None:
        ptrs = [t.data_ptr() for t in _leaves(self.params, [])]
        if self._weights is None:
            self._weights = ptrs
        elif ptrs != self._weights:
            raise RuntimeError(f"step {key}: the weights are not the "
                               f"storage the steps were captured on")

    def _capture(self, key, fn: Callable, cache: Dict, args: Dict) -> _Entry:
        entry = _Entry(cache, args)
        if not self.cuda:
            return entry
        t0 = time.monotonic()
        self._check_weights(key)
        before = _counts(self._wrappers)
        cur = torch.cuda.current_stream(self.device)
        s = self._stream
        # warm-up on the capture stream (lazy handles and workspaces),
        # on the inputs of the replay that follows: K/V it writes in
        # place are written again, with the same values, by that replay
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            fn(entry.cache, **entry.args)
        warm = _counts(self._wrappers)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = fn(entry.cache, **entry.args)
            except BaseException:
                try:                     # end the failed capture; the
                    graph.capture_end()  # step's own error is the one
                except BaseException:    # that matters
                    pass
                raise
            graph.capture_end()
        cur.wait_stream(s)
        entry.launches = settle_counts(self._wrappers, before, warm,
                                       _counts(self._wrappers))
        entry.graph = graph
        entry.out = out
        self.captured += 1
        self.capture_s += time.monotonic() - t0
        return entry
