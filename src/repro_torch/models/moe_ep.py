"""Expert-parallel MoE with an explicit all-to-all over an `EngineMesh`.

Counterpart of `repro/models/moe_ep.py` (`moe_block_ep`; its
`_local_dispatch` is `repro_torch.models.moe._local_dispatch`, which the
single-program `moe_block` shares): each mesh device routes its slice
of the tokens into per-expert capacity buckets, an all-to-all moves only
the bucketed rows to the devices that hold their experts, experts
compute locally, the inverse all-to-all brings the rows home, and the
combine is a local gather.  The reference runs the body under
`shard_map` from one process; the port is single-controller too: one
thread runs every device's body in turn, and `ep_all_to_all` moves the
blocks between the devices with `distributed.transfer.move` (peer
copies between cards, a local permutation where the devices repeat; a
cut between graph segments in a step captured across cards).

Semantics, as in the reference: capacity is enforced PER SOURCE device,
C_dev = max(ceil(T_loc·k/E·cf), 1) with T_loc = T / n_dev, so each
source keeps its first C_dev (token, expert) pairs per expert in token
order and drops the rest; with a non-binding capacity factor the output
equals the single-program `moe_block`.  `moe_block_ep_reference` is the
plain version: the same per-source semantics on one device (the MoE of
each token slice alone).

`ep_all_to_all` counts its exchanges, the bytes that cross between EP
ranks and, when asked, the device time of each exchange, into the
`count_exchanges` block around it (a context variable, so each
engine's worker thread counts its own steps).  A replayed step graph
runs no Python: `add_exchanges` counts the exchanges its capture made,
and a replay records no event, so exchange device time comes from an
eager step (`timed`) or from the profiler.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import MoEConfig
from repro_torch.distributed.sharding import ExpertShards, axis_size
from repro_torch.distributed.transfer import move
from repro_torch.models import moe as _moe


# ---------------------------------------------------------------------------
# Exchange counters
# ---------------------------------------------------------------------------

class ExchangeStats:
    """Exchanges, the bytes that crossed between EP ranks, and (with
    `timed`) a CUDA event pair per receiving device of each exchange."""

    def __init__(self, timed: bool = False):
        self.exchanges = 0
        self.bytes = 0
        self.timed = timed
        self._events: List[List[Tuple[torch.cuda.Event,
                                      torch.cuda.Event]]] = []

    def seconds(self) -> Optional[float]:
        """Device time of the exchanges (each the longest of its receiving
        devices' copies), once they have run; None when not timed."""
        if not self.timed:
            return None
        total = 0.0
        for pairs in self._events:
            for _s, e in pairs:
                e.synchronize()
            total += max(s.elapsed_time(e) for s, e in pairs) / 1e3
        return total


_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ep_stats", default=None)


def add_exchanges(exchanges: int, nbytes: int) -> None:
    """Count `exchanges` exchanges moving `nbytes` bytes between EP ranks
    into this thread's `count_exchanges` block, if any (a step graph's
    replay: the exchanges its capture made)."""
    stats = _STATS.get()
    if stats is not None:
        stats.exchanges += exchanges
        stats.bytes += nbytes


@contextlib.contextmanager
def count_exchanges(timed: bool = False):
    """Yields an `ExchangeStats` that counts this thread's exchanges
    inside the block (`timed`: and their device time, on CUDA)."""
    stats = ExchangeStats(timed)
    token = _STATS.set(stats)
    try:
        yield stats
    finally:
        _STATS.reset(token)


def ep_all_to_all(blocks: Sequence[torch.Tensor], mesh,
                  group: Optional[Sequence[int]] = None
                  ) -> List[torch.Tensor]:
    """The tiled all-to-all of one EP group: `group` lists the flat mesh
    indices of its devices in EP-rank order (default: the whole mesh),
    `blocks[s]` is rank s's (G, ...) tensor on its device.  Slice g of
    every source goes to rank g; `out[g]` stacks the received slices by
    source (G, ...) on rank g's device.  Between devices each slice is a
    copy queued on the receiving device; where the whole group sits on
    one device the exchange is one local permutation."""
    group = list(range(mesh.size)) if group is None else list(group)
    G = len(group)
    if len(blocks) != G or any(b.shape[0] != G for b in blocks):
        raise ValueError(f"ep_all_to_all: {len(blocks)} blocks of leading "
                         f"sizes {[b.shape[0] for b in blocks]} for a "
                         f"group of {G}")
    devs = [mesh.devices[i] for i in group]
    stats = _STATS.get()
    timed = (stats is not None and stats.timed
             and blocks[0].device.type == "cuda")

    def mark(dev):
        with torch.cuda.device(dev):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return ev
    starts = [mark(d) for d in dict.fromkeys(devs)] if timed else []
    if all(d == devs[0] for d in devs):
        out = list(torch.stack(list(blocks), dim=1).unbind(0))
    else:
        # one `move` for the whole exchange: one cut in a segmented
        # capture (`repro_torch.distributed.transfer`)
        moved = move([b[g] for g in range(G) for b in blocks],
                     [dev for dev in devs for _b in blocks])
        out = [torch.stack(moved[g * G:(g + 1) * G]) for g in range(G)]
    if stats is not None:
        stats.exchanges += 1
        # every source keeps its own slice and sends the other G - 1
        stats.bytes += sum(b.numel() // G * b.element_size() * (G - 1)
                           for b in blocks)
        if timed:
            stats._events.append(list(zip(starts, [
                mark(d) for d in dict.fromkeys(devs)])))
    return out


# ---------------------------------------------------------------------------
# The EP layer
# ---------------------------------------------------------------------------

def _token_slots(mesh, token_axes: Sequence[str]) -> List[int]:
    """The token slice each mesh device owns: its rank over the token
    axes, then over the other axes (which split the replicated block),
    as the reference's body slices it."""
    other = tuple(a for a in mesh.axis_names if a not in token_axes)
    n_rep = axis_size(mesh, other)
    return [mesh.index(c, token_axes) * n_rep + mesh.index(c, other)
            for c in map(mesh.coords, range(mesh.size))]


def _ep_groups(mesh, ep_axes: Sequence[str]) -> List[List[int]]:
    """The EP groups: devices that agree on every non-EP axis, each in
    EP-rank order."""
    rest = tuple(a for a in mesh.axis_names if a not in ep_axes)
    groups: Dict[int, Dict[int, int]] = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        groups.setdefault(mesh.index(c, rest), {})[mesh.index(c, ep_axes)] = i
    return [[g[r] for r in sorted(g)] for _k, g in sorted(groups.items())]


def moe_block_ep(x, params: Dict, mc: MoEConfig, mesh,
                 token_axes: Tuple[str, ...], ep_axes: Tuple[str, ...]):
    """EP MoE with the explicit all-to-all.  `x` is a tensor (..., D),
    whose T tokens are cut into `mesh.size` equal slices (T_loc each)
    owned as `_token_slots` says and moved to their devices, the result
    coming back on x's device in x's shape; or a list of `mesh.size`
    tensors (T_loc, ..., D), mesh device i's slice on device i, with a
    list of outputs in the same places and a list of each device's aux
    loss on it (the merged decode step's form).
    `params` is the layer's "moe" dict: expert weights as
    `ExpertShards` over `ep_axes` (or whole tensors, split here), router
    and shared experts read from each device's replica.  Requires
    E % G == 0 (G the size of `ep_axes`).  Returns (out, aux loss)."""
    E = mc.num_experts
    G = axis_size(mesh, ep_axes)
    if E % G:
        raise ValueError(f"{E} experts over {G} EP ranks")
    E_per = E // G
    n_dev = mesh.size
    listed = isinstance(x, (list, tuple))
    if listed:
        if len(x) != n_dev:
            raise ValueError(f"{len(x)} token slices for {n_dev} devices")
        D = x[0].shape[-1]
        shapes = [t.shape for t in x]
        xs = [t.reshape(-1, D) for t in x]
        T_loc = xs[0].shape[0]
        if any(t.shape[0] != T_loc for t in xs):
            raise ValueError("token slices of unequal size")
    else:
        D = x.shape[-1]
        x2d = x.reshape(-1, D)
        T = x2d.shape[0]
        if T % n_dev:
            raise ValueError(f"{T} tokens over {n_dev} devices")
        T_loc = T // n_dev
        slots = _token_slots(mesh, token_axes)
        xs = move([x2d[s * T_loc:(s + 1) * T_loc] for s in slots],
                  mesh.devices)
    C = _moe.capacity(T_loc, mc)                  # C_dev, per source
    weights = {name: (params[name] if isinstance(params[name], ExpertShards)
                      else ExpertShards(params[name], mesh, ep_axes))
               for name in ("w_gate", "w_up", "w_down")}

    reps = [replica_on(params, dev) for dev in mesh.devices]
    routed = []
    for i in range(n_dev):
        top_w, top_e, probs = _moe.route(xs[i], reps[i], mc)
        buckets, pos_tk = _moe._local_dispatch(xs[i], top_w, top_e, E, C)
        routed.append((top_w, top_e, pos_tk, _moe.aux_loss(probs, top_e, E),
                       buckets.reshape(G, E_per * C, D)))
    back: List[Optional[torch.Tensor]] = [None] * n_dev
    for group in _ep_groups(mesh, ep_axes):
        recv = ep_all_to_all([routed[i][4] for i in group], mesh, group)
        ys = []
        for g, i in enumerate(group):
            h = recv[g].reshape(G, E_per, C, D).transpose(0, 1)
            y = _moe._experts(h.reshape(E_per, G * C, D),
                              {n: w.shards[i] for n, w in weights.items()})
            ys.append(y.reshape(E_per, G, C, D).transpose(0, 1)
                      .reshape(G, E_per * C, D))
        for s, y in zip(group, ep_all_to_all(ys, mesh, group)):
            back[s] = y.reshape(E, C, D)
    outs = []
    for i in range(n_dev):
        top_w, top_e, pos_tk, _l, _b = routed[i]
        y_pad = torch.cat([back[i], back[i].new_zeros(E, 1, D)], dim=1)
        contrib = y_pad[top_e, pos_tk]                        # (T_loc, k, D)
        out = (contrib * top_w[..., None].to(y_pad.dtype)).sum(dim=1)
        if mc.num_shared:
            out = out + _moe._shared(xs[i], reps[i])
        outs.append(out)
    if listed:
        return ([o.reshape(s) for o, s in zip(outs, shapes)],
                [r[3] for r in routed])
    order = sorted(range(n_dev), key=lambda i: slots[i])
    back_home = move([outs[i] for i in order] + [r[3] for r in routed],
                     [x.device] * (2 * n_dev))
    out = torch.cat(back_home[:n_dev])
    laux = torch.stack(back_home[n_dev:]).mean()
    return out.reshape(x.shape), laux


def replica_on(params: Dict, device) -> Dict:
    """An MoE layer's params as `device` holds them: its replica of the
    router (and selection bias) and shared experts (`place_params` keeps
    every device's under "replicas"; under TP the MoE dict of the
    device's first model rank, whose shared experts are that rank's
    columns: the TP callers join split shared experts themselves,
    `blocks.mlp_shards`; unplaced params are moved, a no-op where they
    already live)."""
    reps = params.get("replicas")
    if reps is not None:
        return reps[torch.device(device)]
    return {name: t.to(device) for name, t in params.items()
            if name not in ("w_gate", "w_up", "w_down")}


def moe_block_ep_reference(x, params: Dict, mc: MoEConfig, n_slices: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `moe_block_ep` on one device: the MoE of each
    of the `n_slices` equal token slices alone (`moe_block` over T_loc
    tokens has the per-source capacity C_dev and drops the same pairs).
    `params` holds whole expert tensors.  Returns (out of x's shape, the
    slices' mean aux loss)."""
    D = x.shape[-1]
    x2d = x.reshape(-1, D)
    if x2d.shape[0] % n_slices:
        raise ValueError(f"{x2d.shape[0]} tokens over {n_slices} slices")
    parts = [_moe.moe_block(s, params, mc) for s in x2d.chunk(n_slices)]
    out = torch.cat([o for o, _l in parts])
    return out.reshape(x.shape), torch.stack([l for _o, l in parts]).mean()
