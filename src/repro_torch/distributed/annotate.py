"""The mesh context the model code reads.

Counterpart of `repro/distributed/annotate.py` (`activate`, `active`).
Model code is mesh-agnostic; the sharded engine spec activates a mesh
and a logical-axis map around each step, and the MoE layer reads it to
take the explicit all-to-all EP path (`repro_torch.models.moe_ep`).  The
context is a `contextvars.ContextVar`, so it is local to the thread that
set it: the engines' worker threads each see only their own step's.
The reference's `constrain` (a GSPMD sharding annotation) has no
counterpart: the port places every tensor explicitly.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple, Union

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def activate(mesh, axis_map: Dict[str, Union[str, Tuple[str, ...], None]],
             ep_shard_map: bool = False):
    """axis_map: logical name ("tokens", "experts", ...) -> mesh axis or
    tuple of axes.  `ep_shard_map=True` routes MoE blocks through the
    explicit all-to-all EP path where the shapes divide."""
    token = _CTX.set({"mesh": mesh, "map": dict(axis_map),
                      "ep": ep_shard_map})
    try:
        yield
    finally:
        _CTX.reset(token)


def active() -> Optional[Dict]:
    return _CTX.get()


def axes_of(ctx: Dict, name: str) -> Tuple[str, ...]:
    """The mesh axes a logical name maps to, as a tuple."""
    a = ctx["map"].get(name) or ()
    return (a,) if isinstance(a, str) else tuple(a)
