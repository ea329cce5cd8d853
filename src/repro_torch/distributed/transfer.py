"""Moves between the devices of an engine mesh, and the cuts of a step
captured across devices.

Model code moves a tensor to another shard's device only through `move`:
the EP all-to-all (`models.moe_ep`), the token slices and the combined
rows of the EP layer's tensor form, expert rows to their home device
(`models.moe._experts`), the merged decode step's logits
(`models.model`).  Eagerly each move is `tensor.to(device,
non_blocking=True)` (the tensor itself where it is there already).

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
from typing import Callable, List, Sequence

import torch

_CUTTER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_cutter", default=None)


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
