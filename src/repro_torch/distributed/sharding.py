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
    `paged_cache_pspecs` shard them over the data axes, and so do an
    encoder-decoder's per-slot encoder K/V ("enc_k"/"enc_v").

Tensor parallelism (TP) inside a DP unit, on a mesh with a "model" axis
of M > 1 ranks (`ShardedParams.ranks`: one params tree a (device, model
rank), views or slices of that device's replica), follows the
reference's `_leaf_spec`: a GQA layer's `w_q`/`w_k`/`w_v` split by head
and `w_o` by its H rows when both head counts divide M (`heads_split`);
a dense FFN's `w_gate`/`w_up` by column and `w_down` by row; `embed`
(and an untied `lm_head`) over the vocabulary when V divides M, else
over d_model; norms, routers and the MoE's shared experts replicated,
the experts over the expert axes as above.  The merged cache then holds
one shard a (data, model) rank, row-major (shard d·M + m): the DP's
slots and blocks, with K/M KV heads of each pool when the heads split
(`paged_cache_pspecs` puts KV heads on "model"), and "model": M.  Where
the heads do not divide M, the attention weights and pools are whole
on every rank and the attention runs replicated (the reference shards
its projections by row and its attention by sequence, "attn_seq"); a
decoder layer's cross-attention and its per-slot encoder K/V are
replicated too.  MLA and SSM layers under TP are refused (ROADMAP
Queue 1 item 11-rest).  The TPU-production rules (FSDP over data, the
pod axis, sequence-parallel long-context decode) are not ported (item
15).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import (
    AttentionKind, LayerKind, ModelConfig, ParallelConfig,
)

_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
# a hybrid's per-slot entries of a paged cache (and the SSM entries of a
# dense one), (L_ssm, rows, ...)
SSM_STACKS = ("ssm", "conv_x", "conv_bc")
# an encoder-decoder's encoder K/V of every decoder layer, (L, rows, Se,
# K, hd): per slot beside the pages in a paged cache
ENC_STACKS = ("enc_k", "enc_v")
SLOT_STACKS = SSM_STACKS + ENC_STACKS


def axis_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def model_size(mesh) -> int:
    """Tensor-parallel ranks inside each DP unit (1 without a "model"
    axis)."""
    return mesh.shape.get("model", 1)


def heads_split(cfg: ModelConfig, M: int) -> bool:
    """Whether a GQA layer's heads split over M > 1 model ranks: its
    query and KV head counts both divide M."""
    return (M > 1 and cfg.num_heads % M == 0
            and cfg.num_kv_heads % M == 0)


def require_tp(cfg: ModelConfig, M: int) -> None:
    """Refuse what tensor parallelism does not take yet: MLA and SSM
    layers under M > 1 model ranks."""
    if M <= 1:
        return
    what = []
    if cfg.attention == AttentionKind.MLA:
        what.append("MLA layers (w_uq/w_uk/w_uv)")
    if any(k in (LayerKind.SSM, LayerKind.SSM_MOE)
           for k in cfg.layer_kinds()):
        what.append("SSM layers (w_zx, w_dt, out_proj, conv_*)")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over model={M} ranks for "
            f"{' and '.join(what)} is not ported (ROADMAP Queue 1 item "
            f"11-rest: TP for MLA and SSM layers)")


def tp_axis(cfg: ModelConfig, path: Sequence[str], shape, M: int
            ) -> Optional[int]:
    """The axis of the served weight at `path` (its keys from the params'
    root) that M > 1 model ranks split, or None (replicated): the
    reference's `_leaf_spec` for the leaves the port serves (see the
    module note for where it differs)."""
    name = path[-1]
    if M <= 1 or "xattn" in path or "moe" in path:
        return None

    def fits(i):
        return shape[i] % M == 0
    if name == "embed":                          # (V, D)
        return 0 if fits(0) else (1 if fits(1) else None)
    if name == "lm_head":                        # (D, V)
        return 1 if fits(1) else (0 if fits(0) else None)
    if name in ("w_q", "w_k", "w_v"):            # (D, H|K, hd)
        return 1 if heads_split(cfg, M) else None
    if name == "w_o":                            # (H, hd, D)
        return 0 if heads_split(cfg, M) else None
    if name in ("w_gate", "w_up") and len(shape) == 2:   # dense (D, ff)
        return 1 if fits(1) else None
    if name == "w_down" and len(shape) == 2:     # dense (ff, D)
        return 0 if fits(0) else None
    return None


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
    distinct device's replica in `replicas` and, under TP, each (device,
    model rank)'s tree in `ranks`."""
    replicas: Dict[torch.device, Dict]
    ranks: Dict[Tuple[torch.device, int], Dict]


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
    for tree in getattr(params, "ranks", {}).values():
        walk(tree)
    return out


def params_on(params, device) -> Dict:
    """The replica of `params` on `device` (`params` itself when it is
    not sharded)."""
    replicas = getattr(params, "replicas", None)
    if replicas is None:
        return params
    return replicas[torch.device(device)]


def rank_params(params, device, m: int, M: int) -> Dict:
    """The params model rank m of M holds on `device`: its TP tree
    (`place_params` on a mesh with a model axis), or the device's
    replica when M is 1."""
    if M == 1:
        return params_on(params, device)
    ranks = getattr(params, "ranks", None)
    if not ranks:
        raise ValueError(f"a cache split over model={M} ranks needs params "
                         f"placed on that mesh (place_params)")
    return ranks[(torch.device(device), m)]


def _rank_tree(cfg: ModelConfig, tree: Dict, m: int, M: int) -> Dict:
    """Model rank m's tree from a device's replica: each leaf `tp_axis`
    splits cut to its m-th piece (a view on dim 0, a copy otherwise);
    the MoE dicts (experts already split by EP rank) shared."""
    def walk(node, path):
        if isinstance(node, torch.Tensor):
            ax = tp_axis(cfg, path, node.shape, M)
            if ax is None:
                return node
            n = node.shape[ax] // M
            return node.narrow(ax, m * n, n).contiguous()
        if isinstance(node, dict):
            if path and path[-1] == "moe":
                return node
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
    return {k: walk(tree[k], (k,))
            for k in ("embed", "ln_f", "lm_head", "layers") if k in tree}


def place_params(cfg, params: Dict, mesh, par: ParallelConfig
                 ) -> ShardedParams:
    """`params` (a tree on the mesh's lead device) placed on `mesh`: the
    expert weights split over `par`'s expert axes, everything else
    replicated on every distinct device; with a model axis of M > 1
    ranks, each (device, model rank)'s tree split by `tp_axis` in
    `ranks` (MLA and SSM layers refused, `require_tp`)."""
    M = model_size(mesh)
    require_tp(cfg, M)
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
    lead.ranks = {}
    if M > 1:
        for i, dev in enumerate(mesh.devices):
            m = mesh.coords(i)["model"]
            if (dev, m) not in lead.ranks:
                lead.ranks[(dev, m)] = _rank_tree(cfg, lead.replicas[dev],
                                                  m, M)
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


def cache_model(cache: Dict) -> int:
    """The model ranks of each DP unit of a merged cache (1 where it
    does not say)."""
    return cache.get("model", 1)


def dp_groups(cache: Dict) -> List[List[int]]:
    """The shard indices of each DP unit of a merged cache (its model
    ranks, in rank order)."""
    M = cache_model(cache)
    return [list(range(d * M, (d + 1) * M))
            for d in range(len(cache["shards"]) // M)]


def head_share(t: torch.Tensor, m: int, M: int) -> torch.Tensor:
    """Model rank m's share of the KV heads (axis -2) of a K/V tensor."""
    n = t.shape[-2] // M
    return t[..., m * n:(m + 1) * n, :]


def kv_split(cfg: ModelConfig, M: int) -> bool:
    """Whether a merged cache over M model ranks splits the pools' KV
    heads: a GQA model whose heads split (`heads_split`)."""
    return cfg.attention != AttentionKind.MLA and heads_split(cfg, M)


def shard_paged_cache(cache: Dict, mesh, cfg: Optional[ModelConfig] = None
                      ) -> Dict:
    """A paged cache of n·S slots over n·B blocks, in global ids, as the
    merged form over the n data ranks of an engine mesh: shard d·M + m
    (data rank d, model rank m of M) holds slots [d·S, (d+1)·S) (their
    per-slot SSM and encoder entries too) and blocks [d·B, (d+1)·B) in
    local ids, on mesh device d·M + m; with M > 1 (`cfg` required) the
    pools' KV heads split over the model ranks where `kv_split` says."""
    devs = mesh.devices
    M = model_size(mesh)
    n = len(devs) // M
    if M > 1 and cfg is None:
        raise ValueError("a merged cache over model ranks needs the config")
    split = M > 1 and kv_split(cfg, M)
    slots, nblocks = cache["cur"].shape[0], cache["kv_pos"].shape[0]
    if slots % n or nblocks % n:
        raise ValueError(f"{slots} slots and {nblocks} blocks do not split "
                         f"over {n} data ranks")
    S, B = slots // n, nblocks // n
    shards = []
    for i, dev in enumerate(devs):
        k, m = divmod(i, M)
        s, b = slice(k * S, (k + 1) * S), slice(k * B, (k + 1) * B)
        shard = {
            "cur": cache["cur"][s].to(dev, copy=True),
            "kv_pos": cache["kv_pos"][b].to(dev, copy=True),
            "block_tab": _local_table(cache["block_tab"][s], k * B,
                                      B).to(dev),
        }
        for name in ("k", "v"):
            t = cache[name][:, b]
            shard[name] = (head_share(t, m, M) if split else t).to(
                dev, copy=True).contiguous()
        for name in SLOT_STACKS:
            if name in cache:
                shard[name] = cache[name][:, s].to(dev, copy=True)
        shards.append(shard)
    return {"shards": shards, "slots": S, "blocks": B, "model": M}


def unshard_paged_cache(merged: Dict, device,
                        cfg: Optional[ModelConfig] = None) -> Dict:
    """The inverse of `shard_paged_cache`: one paged cache in global ids
    on `device` (tests and checks), each DP's entries from its model
    rank 0 and its KV heads joined over its ranks where they split
    (`cfg` required over model ranks)."""
    B, M = merged["blocks"], cache_model(merged)
    if M > 1 and cfg is None:
        raise ValueError("a merged cache over model ranks needs the config")
    split = M > 1 and kv_split(cfg, M)
    groups = dp_groups(merged)
    shards = [merged["shards"][g[0]] for g in groups]
    tabs = [torch.where(c["block_tab"] >= 0, c["block_tab"] + k * B, -1)
            for k, c in enumerate(shards)]
    out = {
        "cur": torch.cat([c["cur"].to(device) for c in shards]),
        "kv_pos": torch.cat([c["kv_pos"].to(device) for c in shards]),
        "block_tab": torch.cat([t.to(device) for t in tabs]).to(torch.int32),
    }
    for name in ("k", "v"):
        parts = [torch.cat([merged["shards"][i][name].to(device)
                            for i in g], -2) if split
                 else shards[k][name].to(device)
                 for k, g in enumerate(groups)]
        out[name] = torch.cat(parts, 1)
    for name in SLOT_STACKS:
        if name in shards[0]:
            out[name] = torch.cat([c[name].to(device) for c in shards], 1)
    return out
