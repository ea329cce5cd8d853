"""Placement rules of the sharded serving plane on an `EngineMesh`.

Counterpart of the parts of `repro/distributed/sharding.py` the data
mesh of the real plane needs: `param_pspecs` (`place_params`: where each
weight lives), `paged_cache_pspecs` (`shard_paged_cache`: the merged
decode cache held as one shard per data rank) and `data_axes_of`.  JAX
annotates one array with a PartitionSpec and lets GSPMD place the
pieces; the port places the pieces itself:

  * expert weights (`w_gate`, `w_up`, `w_down` of an MoE layer) are split
    along E over the expert axes: an `ExpertShards` holds, for every
    mesh device, the slice of that device's EP rank (a view where the
    device already holds the weight, so nothing is copied when the
    devices repeat);
  * everything else (router, shared experts, attention, norms,
    embeddings) is replicated, one copy per distinct device
    (`ShardedParams.replicas`; each MoE dict also maps every device to
    its replica of that layer's MoE dict under "replicas");
  * the merged paged cache is a dict {"shards": [one paged cache per
    data rank], "slots": S, "blocks": B}: global slot s lives in shard
    s // S as local slot s % S, global block b in shard b // B as local
    block b % B, which is what `BlockPool(base=k·B)` hands out to DP k
    (its ids run k·B+1 .. (k+1)·B-1, so local block 0, global k·B, is
    the shard's null block).  Block tables in a shard hold local ids.  A
    hybrid's per-slot SSM states and conv tails go with their slots
    (shard k holds rows [k·S, (k+1)·S)), as the reference's
    `paged_cache_pspecs` shard them over the data axes.

The TPU-production rules (FSDP over data, the pod axis, tensor-parallel
heads and FFN, sequence-parallel long-context decode) are not ported
(ROADMAP Queue 1 item 11-rest).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.config.base import ParallelConfig

_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
# a hybrid's per-slot entries of a paged cache (and the SSM entries of a
# dense one), (L_ssm, rows, ...)
SSM_STACKS = ("ssm", "conv_x", "conv_bc")


def axis_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def data_axes_of(mesh, par: ParallelConfig) -> Tuple[str, ...]:
    axes = tuple(a for a in par.data_axes if a in mesh.axis_names)
    if "pod" in mesh.axis_names and "pod" not in axes:
        axes = ("pod",) + axes
    return axes


def expert_axes_of(mesh, par: ParallelConfig) -> Tuple[str, ...]:
    return tuple(a for a in par.expert_axes if a in mesh.axis_names)


class ExpertShards:
    """One stacked expert weight (E, ...) split along E over the mesh's
    expert axes `ep_axes` (G = their size, E_per = E / G experts per EP
    rank).  `shards[i]` holds EP rank `ranks[i]`'s experts on mesh
    device i; devices that repeat share one tensor."""

    def __init__(self, w: torch.Tensor, mesh, ep_axes: Sequence[str]):
        G = axis_size(mesh, ep_axes)
        E = w.shape[0]
        if E % G:
            raise ValueError(f"{E} experts do not split over {G} EP ranks")
        self.num_experts, self.G, self.E_per = E, G, E // G
        self.ranks: List[int] = [mesh.index(mesh.coords(i), ep_axes)
                                 for i in range(mesh.size)]
        made: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self.shards: List[torch.Tensor] = []
        for r, dev in zip(self.ranks, mesh.devices):
            if (r, dev) not in made:
                made[(r, dev)] = w[r * self.E_per:(r + 1) * self.E_per].to(dev)
            self.shards.append(made[(r, dev)])
        self.dtype = w.dtype

    def home(self, g: int) -> torch.Tensor:
        """EP rank g's experts on the first device that holds them."""
        return self.shards[self.ranks.index(g)]


class ShardedParams(dict):
    """The params of a sharded spec: the lead device's replica (a params
    tree whose MoE expert weights are `ExpertShards`), with every
    distinct device's replica in `replicas`."""
    replicas: Dict[torch.device, Dict]


def param_leaves(params) -> List[torch.Tensor]:
    """Every weight tensor of `params` once, in a fixed order: the tensors
    of a plain params tree (dicts and lists); of `ShardedParams`, every
    distinct device's replica and every `ExpertShards` slice (the
    "replicas" maps of the MoE dicts point back into the replicas and
    are not walked).  A step graph holds these addresses."""
    out: List[torch.Tensor] = []
    seen = set()

    def walk(tree):
        if isinstance(tree, torch.Tensor):
            if id(tree) not in seen:
                seen.add(id(tree))
                out.append(tree)
        elif isinstance(tree, ExpertShards):
            for t in tree.shards:
                walk(t)
        elif isinstance(tree, dict):
            for k, v in tree.items():
                if k != "replicas":
                    walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    replicas = getattr(params, "replicas", None)
    for tree in ([params] if replicas is None else replicas.values()):
        walk(tree)
    return out


def params_on(params, device) -> Dict:
    """The replica of `params` on `device` (`params` itself when it is
    not sharded)."""
    replicas = getattr(params, "replicas", None)
    if replicas is None:
        return params
    return replicas[torch.device(device)]


def place_params(cfg, params: Dict, mesh, par: ParallelConfig
                 ) -> ShardedParams:
    """`params` (a tree on the mesh's lead device) placed on `mesh`: the
    expert weights split over `par`'s expert axes, everything else
    replicated on every distinct device."""
    ep_axes = expert_axes_of(mesh, par)
    experts = [{name: ExpertShards(p["moe"][name], mesh, ep_axes)
                for name in _EXPERT_WEIGHTS} if "moe" in p else None
               for p in params["layers"]]

    def on(tree, dev, shards=None):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        if isinstance(tree, list):
            return [on(t, dev, s) for t, s in zip(tree, experts)]
        out = {}
        for k, v in tree.items():
            if k == "moe" and shards is not None:
                out[k] = {kk: shards.get(kk) or on(vv, dev)
                          for kk, vv in v.items()}
            else:
                out[k] = on(v, dev, shards)
        return out

    lead = ShardedParams(on(params, mesh.lead))
    lead.replicas = {d: (lead if d == mesh.lead else on(params, d))
                     for d in mesh.distinct}
    # each replica's MoE dicts reach every device's (the EP body routes
    # each device's tokens with that device's router)
    for l, shards in enumerate(experts):
        if shards is None:
            continue
        on_dev = {d: r["layers"][l]["moe"] for d, r in lead.replicas.items()}
        for m in on_dev.values():
            m["replicas"] = on_dev
    return lead


# ---------------------------------------------------------------------------
# The merged paged decode cache
# ---------------------------------------------------------------------------

def is_merged(cache: Dict) -> bool:
    return "shards" in cache


def _local_table(tab: torch.Tensor, base: int, blocks: int) -> torch.Tensor:
    loc = torch.where(tab >= 0, tab - base, -1)
    bad = (tab >= 0) & ((loc <= 0) | (loc >= blocks))
    if bool(bad.any()):
        raise ValueError(f"a block table names blocks outside its shard's "
                         f"range [{base + 1}, {base + blocks})")
    return loc.to(torch.int32)


def shard_paged_cache(cache: Dict, mesh) -> Dict:
    """A paged cache of n·S slots over n·B blocks, in global ids, as the
    merged form over the n data ranks of a data-axis mesh: shard k holds
    slots [k·S, (k+1)·S) (their per-slot SSM entries too) and blocks
    [k·B, (k+1)·B) in local ids, on mesh device k."""
    devs = mesh.devices
    n = len(devs)
    slots, nblocks = cache["cur"].shape[0], cache["kv_pos"].shape[0]
    if slots % n or nblocks % n:
        raise ValueError(f"{slots} slots and {nblocks} blocks do not split "
                         f"over {n} data ranks")
    S, B = slots // n, nblocks // n
    shards = []
    for k, dev in enumerate(devs):
        s, b = slice(k * S, (k + 1) * S), slice(k * B, (k + 1) * B)
        shards.append({
            "cur": cache["cur"][s].to(dev, copy=True),
            "kv_pos": cache["kv_pos"][b].to(dev, copy=True),
            "block_tab": _local_table(cache["block_tab"][s], k * B,
                                      B).to(dev),
            "k": cache["k"][:, b].to(dev, copy=True),
            "v": cache["v"][:, b].to(dev, copy=True),
        })
        for name in SSM_STACKS:
            if name in cache:
                shards[-1][name] = cache[name][:, s].to(dev, copy=True)
    return {"shards": shards, "slots": S, "blocks": B}


def unshard_paged_cache(merged: Dict, device) -> Dict:
    """The inverse of `shard_paged_cache`: one paged cache in global ids
    on `device` (tests and checks)."""
    B = merged["blocks"]
    shards = merged["shards"]
    tabs = [torch.where(c["block_tab"] >= 0, c["block_tab"] + k * B, -1)
            for k, c in enumerate(shards)]
    out = {
        "cur": torch.cat([c["cur"].to(device) for c in shards]),
        "kv_pos": torch.cat([c["kv_pos"].to(device) for c in shards]),
        "block_tab": torch.cat([t.to(device) for t in tabs]).to(torch.int32),
    }
    for name in ("k", "v") + SSM_STACKS:
        if name in shards[0]:
            out[name] = torch.cat([c[name].to(device) for c in shards], 1)
    return out
