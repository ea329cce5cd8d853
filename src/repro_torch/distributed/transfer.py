"""Moves between the devices of an engine mesh, the tensor-parallel
collectives built on them, and the cuts of a step captured across
devices.

Model code moves a tensor to another shard's device only through `move`:
the EP all-to-all (`models.moe_ep`), the token slices and the combined
rows of the EP layer's tensor form, expert rows to their home device
(`models.moe._experts`), the merged decode step's logits
(`models.model`), and the collectives of tensor parallelism (TP) inside
a DP unit below.  Eagerly each move is `tensor.to(device,
non_blocking=True)` (the tensor itself where it is there already).

The TP collectives act on one tensor a shard, over groups of shards
(the model ranks of each DP unit), all groups in one `move`:
`all_reduce` (the sum of the partial outputs of a split projection, on
every rank of the group), `all_gather` (the pieces of a split row or
token axis, joined on every rank), `gather_to`/`reduce_to` (logits pieces or
partials joined on one device).  A sum runs in one fixed order, rank 0
first, in fp32, on every rank alike, so the ranks of a DP hold the same
bits after it (a split that summed in another order on some rank would
let the ranks of one DP drift apart).  Each collective counts itself
into the thread's `count_collectives` block (calls by kind, and the
bytes that cross between ranks); a replayed step graph adds the counts
its capture made (`add_collectives`).

A CUDA graph records the work of one device's stream, and a copy to
another device issued while it captures is not part of it.  So a step
whose shards sit on several cards is captured as SEGMENTS
(`repro_torch.serving.step_graphs`): one graph per device for the work
between two moves that cross devices.  The capture installs a cutter
(`cutting`) that `move` calls where a move crosses devices: it ends
every device's graph, allocates a static receive buffer on each
destination and records the copy into it, begins the next segment's
graphs, and returns the receive buffers (the tensor itself where it
stays on its device).  A replay runs each segment's graphs, then its
copies.  Where every shard shares one device no move crosses devices,
the cutter is never called and the step is one graph.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, List, Sequence

import torch

_CUTTER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_cutter", default=None)
_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tp_stats", default=None)


def move(tensors: Sequence[torch.Tensor], devices: Sequence
         ) -> List[torch.Tensor]:
    """`tensors[i]` on `devices[i]`, for every i.  Inside a segmented
    capture a move that crosses devices is a cut (see the module note);
    all the moves of one call share it."""
    if len(tensors) != len(devices):
        raise ValueError(f"{len(tensors)} tensors for {len(devices)} "
                         f"devices")
    devs = [torch.device(d) for d in devices]
    cutter = _CUTTER.get()
    if cutter is not None and any(t.device != d
                                  for t, d in zip(tensors, devs)):
        return cutter(list(tensors), devs)
    return [t.to(d, non_blocking=True) for t, d in zip(tensors, devs)]


@contextlib.contextmanager
def cutting(cutter: Callable):
    """Within it, `move` calls `cutter(tensors, devices)` where a move
    crosses devices (this thread only)."""
    token = _CUTTER.set(cutter)
    try:
        yield
    finally:
        _CUTTER.reset(token)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives
# ---------------------------------------------------------------------------

class CollectiveStats:
    """TP collectives by kind ("all_reduce", "all_gather", "gather",
    "reduce", "broadcast"), and the bytes that crossed between ranks."""

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.bytes = 0

    def add(self, calls: Dict[str, int], nbytes: int) -> None:
        for kind, n in calls.items():
            self.calls[kind] = self.calls.get(kind, 0) + n
        self.bytes += nbytes


@contextlib.contextmanager
def count_collectives():
    """Yields a `CollectiveStats` that counts this thread's TP
    collectives inside the block."""
    stats = CollectiveStats()
    token = _STATS.set(stats)
    try:
        yield stats
    finally:
        _STATS.reset(token)


def add_collectives(calls: Dict[str, int], nbytes: int) -> None:
    """Count `calls` moving `nbytes` into this thread's
    `count_collectives` block, if any (a step graph's replay: the
    collectives its capture made)."""
    stats = _STATS.get()
    if stats is not None:
        stats.add(calls, nbytes)


def _count(kind: str, nbytes: int) -> None:
    add_collectives({kind: 1}, nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order, in fp32, cast back."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(parts[0].dtype)


def _exchange(parts: Sequence[torch.Tensor],
              groups: Sequence[Sequence[int]]) -> List[List[torch.Tensor]]:
    """For every shard i of every group, all the group's parts (in rank
    order) on shard i's device: one `move` for all groups."""
    srcs, dsts = [], []
    for g in groups:
        for i in g:
            for j in g:
                srcs.append(parts[j])
                dsts.append(parts[i].device)
    moved = move(srcs, dsts)
    out: List[List[torch.Tensor]] = [[] for _ in parts]
    at = 0
    for g in groups:
        for i in g:
            out[i] = moved[at:at + len(g)]
            at += len(g)
    return out


def all_reduce(parts: Sequence[torch.Tensor],
               groups: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """The sum of each group's parts (one tensor a shard, on its device),
    on every shard of the group: every shard receives the group's parts
    and sums them in rank order (`_ordered_sum`), so the ranks hold the
    same bits."""
    recv = _exchange(parts, groups)
    out = list(parts)
    for g in groups:
        for i in g:
            out[i] = _ordered_sum(recv[i])
    _count("all_reduce", sum(_nbytes(parts[j]) * (len(g) - 1)
                             for g in groups for j in g))
    return out


def all_gather(parts: Sequence[torch.Tensor],
               groups: Sequence[Sequence[int]], dim: int
               ) -> List[torch.Tensor]:
    """Each group's parts joined along `dim` in rank order, on every
    shard of the group."""
    recv = _exchange(parts, groups)
    out = list(parts)
    for g in groups:
        for i in g:
            out[i] = torch.cat(recv[i], dim=dim)
    _count("all_gather", sum(_nbytes(parts[j]) * (len(g) - 1)
                             for g in groups for j in g))
    return out


def _to_one(parts: Sequence[torch.Tensor], groups: Sequence[Sequence[int]],
            device) -> List[List[torch.Tensor]]:
    device = torch.device(device)
    moved = move([parts[j] for g in groups for j in g],
                 [device] * sum(len(g) for g in groups))
    out, at = [], 0
    for g in groups:
        out.append(moved[at:at + len(g)])
        at += len(g)
    return out


def gather_to(parts: Sequence[torch.Tensor], groups: Sequence[Sequence[int]],
           dim: int, device) -> List[torch.Tensor]:
    """Each group's parts joined along `dim` in rank order, on `device`
    (one tensor a group)."""
    out = [torch.cat(ps, dim=dim) for ps in _to_one(parts, groups, device)]
    _count("gather", sum(_nbytes(parts[j]) for g in groups for j in g[1:]))
    return out


def reduce_to(parts: Sequence[torch.Tensor], groups: Sequence[Sequence[int]],
           device) -> List[torch.Tensor]:
    """Each group's parts summed in rank order (`_ordered_sum`), on
    `device` (one tensor a group)."""
    out = [_ordered_sum(ps) for ps in _to_one(parts, groups, device)]
    _count("reduce", sum(_nbytes(parts[j]) for g in groups for j in g[1:]))
    return out


def broadcast(t: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """`t` on each of `devices` (a group's ranks, the first holding it)."""
    out = move([t] * len(devices), devices)
    _count("broadcast", _nbytes(t) * (len(devices) - 1))
    return out
