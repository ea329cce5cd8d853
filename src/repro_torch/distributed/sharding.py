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
  * on a mesh without model ranks everything else (router, shared
    experts, attention, norms, embeddings) is replicated, one copy per
    distinct device (`ShardedParams.replicas`; each MoE dict also maps
    every device to its replica of that layer's MoE dict under
    "replicas"); with model ranks, see tensor parallelism below;
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
rank), with no whole replica beside them), follows the reference's
`_leaf_spec` (`tp_axis`): a GQA layer's `w_q`/`w_k`/`w_v` split by head
and `w_o` by its H rows when both head counts divide M (`heads_split`),
else the row-parallel form (`w_q`/`w_k`/`w_v` by d_model rows, `w_o` by
its d_model columns); a decoder layer's cross-attention (`xattn`) the
same way; a dense FFN's `w_gate`/`w_up` by column and `w_down` by row,
and the MoE's shared experts alike; `embed` (and an untied `lm_head`)
over the vocabulary when V divides M, else over d_model; norms and
routers replicated, the experts over the expert axes as above.  The
merged cache then holds one shard a (data, model) rank, row-major (shard
d·M + m): the DP's slots and blocks, with K/M KV heads of each pool when
the heads split (`paged_cache_pspecs` puts KV heads on "model") and its
heads of each slot's encoder K/V, and "model": M.  Under the
row-parallel form the pools are whole on every rank of a DP, as
`paged_cache_pspecs` leaves them: each rank projects its d_model slice,
the partial q|k|v are all-reduced, the attention runs whole on every
rank and writes the same K/V, and the output's d_model slices are
all-gathered.  An MLA layer's `w_uq`/`w_uk`/`w_uv` split by head and
its `w_o` by row when its H heads divide M; its down-projections, rope
key and norms are replicated, and its latent and rope pools have no
head axis, so every rank of a DP holds them whole and writes the same
rows.  An SSM layer splits by heads (`ssm_split`, `tp_axis`): rank m
holds heads m·nh/M .. (m+1)·nh/M - 1, their columns of z and of x, of
w_dt and the x conv, their A_log, D_skip, dt_bias and gated-norm
weights, their rows of out_proj, and their per-slot SSM state and x
conv tail ("ssm", "conv_x"; `cache_tp_axis`); the B/C projection, its
conv and "conv_bc" stay whole (one group).  Its gated norm reduces over
the whole d_inner, so the ranks all-reduce their sums of squares before
they normalise (`models.blocks.ssm_shards`).  A dense prefill row split
over a DP's ranks is the same form ({"shards": one dense cache a rank,
"model": M}, `models.model.split_dense_cache`).

The TPU-production rules follow at the end: `ShardingRules`,
`param_pspecs`, `cache_pspecs`, `paged_cache_pspecs`, `batch_pspecs`
and `opt_pspecs`, the reference's functions over an `EngineMesh` (the
dry-run's logical 16 x 16 or 2 x 16 x 16 mesh of `meta` devices,
`launch.mesh.make_production_mesh`).  They read only `.shape`, so they
take `meta` tensors, and return the reference's trees with a tuple a
leaf (`PSpec`: one entry a dim, None, an axis name or a tuple of
names; its `str` is the reference's `PartitionSpec`'s).  The dry-run
(`launch.dryrun`) is their only user; the serving plane places by
`tp_axis`.
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


def attn_heads_split(cfg: ModelConfig, M: int) -> bool:
    """Whether an attention layer's heads split over M > 1 model ranks:
    a GQA layer's where `heads_split` says, an MLA layer's where its H
    query heads divide M (its latent has no head axis)."""
    if cfg.attention == AttentionKind.MLA:
        return M > 1 and cfg.num_heads % M == 0
    return heads_split(cfg, M)


def ssm_split(cfg: ModelConfig, M: int) -> bool:
    """Whether an SSM layer's heads split over M > 1 model ranks: its
    nh = d_inner / head_dim heads divide M (one group, as kernel #4
    takes it: B and C are shared by every head)."""
    sc = cfg.ssm
    if M <= 1 or sc is None or sc.n_groups != 1 or not any(
            k in (LayerKind.SSM, LayerKind.SSM_MOE)
            for k in cfg.layer_kinds()):
        return False
    return (cfg.d_model * sc.expand // sc.head_dim) % M == 0


# the leaves of a Mamba2 mixer that a model rank holds by heads: its
# columns of the [z|x] projection (`_rank_tree` cuts z and x each), of
# w_dt and the x conv, its entries of the per-head (and per-channel)
# vectors and its rows of out_proj
_SSM_BY_HEAD = {"w_zx": 1, "w_dt": 1, "conv_wx": 1, "conv_bx": 0,
                "A_log": 0, "D_skip": 0, "dt_bias": 0, "norm": 0,
                "out_proj": 0}


def row_parallel(cfg: ModelConfig, M: int) -> bool:
    """Whether a GQA attention (self or cross) takes the row-parallel form
    over M > 1 model ranks: its head counts do not both divide M.  Its
    projections then split by d_model rows and its output projection by
    d_model columns, as the reference's `_leaf_spec` splits them where
    the heads do not divide ("row-parallel fallback")."""
    return M > 1 and not heads_split(cfg, M)


def tp_axis(cfg: ModelConfig, path: Sequence[str], shape, M: int
            ) -> Optional[int]:
    """The axis of the served weight at `path` (its keys from the params'
    root) that M > 1 model ranks split, or None (replicated).  This is
    the serving plane's rule.  It follows the reference's `_leaf_spec`
    (`param_pspecs`, below, is the port's copy of it), cross-attention
    (`xattn`) and the MoE's shared experts included, with these
    deliberate differences: an SSM layer's per-head vectors (A_log,
    D_skip, dt_bias), its gated norm's weight and conv_bx split with its
    heads (GSPMD replicates the vectors and reshards around them; a rank
    here holds only what its heads read), and its [z|x] projection
    splits z and x each by heads (a contiguous half of the columns would
    give rank 0 only z); where a GQA layer's query heads divide M and
    its KV heads do not, `w_q` splits by d_model rows and `w_o` by
    d_model columns with the rest of the layer (`_leaf_spec` splits
    those two by heads and lets GSPMD reshard between them; the
    row-parallel form keeps kernels #1 and #2 at their G = H/K over
    whole pools, and each rank holds as many bytes); an MLA layer's
    `w_o` stays whole where its heads do not divide M (`_leaf_spec`:
    by d_model).  The encoder K/V of a slot split by heads where
    `xattn` does (`cache_tp_axis`), which `paged_cache_pspecs` leaves
    whole."""
    name = path[-1]
    if M <= 1:
        return None

    def fits(i):
        return shape[i] % M == 0
    if "moe" in path:
        if name in ("shared_gate", "shared_up"):     # (D, f·n)
            return 1 if fits(1) else None
        if name == "shared_down":                    # (f·n, D)
            return 0 if fits(0) else None
        return None                                  # experts: EP; router
    if "mamba" in path:
        return _SSM_BY_HEAD.get(name) if ssm_split(cfg, M) else None
    if name == "embed":                          # (V, D)
        return 0 if fits(0) else (1 if fits(1) else None)
    if name == "lm_head":                        # (D, V)
        return 1 if fits(1) else (0 if fits(0) else None)
    gqa = "xattn" in path or cfg.attention != AttentionKind.MLA
    if name in ("w_q", "w_k", "w_v"):            # (D, H|K, hd)
        if heads_split(cfg, M):
            return 1
        return 0 if fits(0) else None            # row-parallel
    if name in ("w_uq", "w_uk", "w_uv"):         # (qin|r, H, dn|dv)
        return 1 if attn_heads_split(cfg, M) else None
    if name == "w_o":                            # (H, hd, D)
        if not gqa:
            return 0 if attn_heads_split(cfg, M) else None
        if heads_split(cfg, M):
            return 0
        return 2 if fits(2) else None            # row-parallel
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
    """The params of a sharded spec.  Without model ranks: the lead
    device's replica (a params tree whose MoE expert weights are
    `ExpertShards`), with every distinct device's replica in `replicas`.
    Under TP (M > 1 model ranks): each (device, model rank)'s tree in
    `ranks` and no replica (`replicas` empty); the dict itself is the
    lead device's model rank 0 tree."""
    replicas: Dict[torch.device, Dict]
    ranks: Dict[Tuple[torch.device, int], Dict]


def param_leaves(params) -> List[torch.Tensor]:
    """Every weight tensor of `params` once, in a fixed order: the tensors
    of a plain params tree (dicts and lists); of `ShardedParams`, every
    distinct device's replica, every model rank's tree and every
    `ExpertShards` slice (the "replicas" maps of the MoE dicts point
    back into those trees and are not walked).  A step graph holds these
    addresses."""
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
    not sharded).  Params placed over model ranks hold no replica: a
    rank's tree is `rank_params`'."""
    if getattr(params, "ranks", None):
        raise ValueError("params placed over model ranks hold no whole "
                         "replica; take a rank's tree (rank_params)")
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


def _piece(t: torch.Tensor, name: str, ax: int, m: int, M: int
           ) -> torch.Tensor:
    """Model rank m's piece of weight `t` split on `ax` (a view; [z|x]:
    z's and x's each by heads, joined)."""
    if name == "w_zx":
        di = t.shape[1] // 2
        n = di // M
        return torch.cat([t[:, m * n:(m + 1) * n],
                          t[:, di + m * n:di + (m + 1) * n]], 1)
    n = t.shape[ax] // M
    return t.narrow(ax, m * n, n)


def _rank_tree(cfg: ModelConfig, params: Dict, m: int, M: int, dev,
               whole: Dict[int, torch.Tensor], experts: List) -> Dict:
    """Model rank m's tree on `dev`, from the caller's tree: each leaf
    `tp_axis` splits as rank m's piece in storage of its own (never a
    view of the caller's tensor, so dropping that tree frees it); the
    others placed once on `dev` (`whole`, by the caller's tensor) and
    shared by the device's ranks; each MoE layer's expert weights its
    `ExpertShards`."""
    def walk(node, path):
        if isinstance(node, torch.Tensor):
            ax = tp_axis(cfg, path, node.shape, M)
            if ax is None:
                if id(node) not in whole:
                    whole[id(node)] = node.to(dev)
                return whole[id(node)]
            piece = _piece(node, path[-1], ax, m, M)
            return torch.empty(piece.shape, dtype=piece.dtype,
                               device=dev).copy_(piece)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return [walk(v, path + (str(i),)) for i, v in enumerate(node)]

    tree = {k: walk(params[k], (k,))
            for k in ("embed", "ln_f", "lm_head") if k in params}
    tree["layers"] = []
    for l, (p, shards) in enumerate(zip(params["layers"], experts)):
        path = ("layers", str(l))
        layer = {}
        for k, v in p.items():
            if k == "moe":
                layer[k] = {kk: (shards[kk] if kk in shards
                                 else walk(vv, path + (k, kk)))
                            for kk, vv in v.items()}
            else:
                layer[k] = walk(v, path + (k,))
        tree["layers"].append(layer)
    return tree


def place_params(cfg, params: Dict, mesh, par: ParallelConfig
                 ) -> ShardedParams:
    """`params` (a tree on the mesh's lead device) placed on `mesh`: the
    expert weights split over `par`'s expert axes; without model ranks
    everything else replicated on every distinct device; with a model
    axis of M > 1 ranks, each (device, model rank)'s tree in `ranks`
    (`_rank_tree`: its pieces of what `tp_axis` splits, the rest once a
    device) and no whole replica.  A GQA model whose attention splits
    neither by heads nor by d_model rows raises: TP runs no layer on
    whole weights in its place."""
    M = model_size(mesh)
    ep_axes = expert_axes_of(mesh, par)
    experts = [{name: ExpertShards(p["moe"][name], mesh, ep_axes)
                for name in _EXPERT_WEIGHTS} if "moe" in p else None
               for p in params["layers"]]
    if M > 1:
        if (any("attn" in p and "w_q" in p["attn"] for p in params["layers"])
                and row_parallel(cfg, M) and cfg.d_model % M):
            raise ValueError(f"{cfg.name}: {cfg.num_heads} heads over "
                             f"{cfg.num_kv_heads} KV heads and d_model "
                             f"{cfg.d_model} do not split over {M} model "
                             f"ranks")
        return _place_ranks(cfg, params, mesh, M, experts)

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
    _link_moe(experts, [(d, r["layers"]) for d, r in lead.replicas.items()])
    lead.ranks = {}
    return lead


def _link_moe(experts: List, layers_on: List[Tuple[torch.device, List]]
              ) -> None:
    """Give every MoE dict of the trees in `layers_on` ((device, the
    tree's layer list) pairs) a "replicas" map from each device to the
    MoE dict of its first tree there: the EP body routes each device's
    tokens with that device's router."""
    for l, shards in enumerate(experts):
        if shards is None:
            continue
        on_dev = {}
        for dev, layers in layers_on:
            on_dev.setdefault(dev, layers[l]["moe"])
        for _dev, layers in layers_on:
            layers[l]["moe"]["replicas"] = on_dev


def _place_ranks(cfg, params: Dict, mesh, M: int, experts: List
                 ) -> ShardedParams:
    """`place_params` over M > 1 model ranks: one tree a (device, model
    rank) of the mesh, in mesh order."""
    ranks: Dict[Tuple[torch.device, int], Dict] = {}
    whole: Dict[torch.device, Dict[int, torch.Tensor]] = {}
    for i, dev in enumerate(mesh.devices):
        m = mesh.coords(i)["model"]
        if (dev, m) not in ranks:
            ranks[(dev, m)] = _rank_tree(cfg, params, m, M, dev,
                                         whole.setdefault(dev, {}),
                                         experts)
    _link_moe(experts, [(dev, t["layers"]) for (dev, _m), t in
                        ranks.items()])
    lead = ShardedParams(ranks[(mesh.lead, mesh.coords(0)["model"])])
    lead.replicas = {}
    lead.ranks = ranks
    return lead


def weight_storage(params) -> Dict[torch.device, int]:
    """The bytes of weight storage each device holds for `params`: every
    distinct storage that `param_leaves` reaches, once, on its device.
    A view counts its whole source storage, which it keeps alive."""
    seen = set()
    out: Dict[torch.device, int] = {}
    for t in param_leaves(params):
        st = t.untyped_storage()
        key = (t.device, st.data_ptr())
        if key not in seen:
            seen.add(key)
            out[t.device] = out.get(t.device, 0) + st.nbytes()
    return out


def _at(tree, path):
    """The node of `tree` at `path` (keys; list indices as strings)."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def tp_weight_report(cfg: ModelConfig, params: Dict, placed, mesh,
                     par: ParallelConfig) -> Dict:
    """What each device holds of `placed` (`place_params(cfg, params,
    mesh, par)`, M > 1 model ranks) against the count `tp_axis` gives:
    a leaf it splits, one piece a model rank of the device; any other
    leaf, once a device; the expert weights as EP placed them (each
    distinct storage of the device's `ExpertShards` slices: a slice of
    the caller's stack on its own device is a view of it).  The placed
    trees are counted by storage (`weight_storage`).  `whole` lists the
    (device, rank, path) of every leaf `tp_axis` splits that a rank
    holds whole or as a view of a larger storage.  Returns {"held":
    {device: bytes}, "expected": {device: bytes}, "whole": [...]}."""
    M = model_size(mesh)
    on_dev: Dict[torch.device, set] = {}
    for i, dev in enumerate(mesh.devices):
        on_dev.setdefault(dev, set()).add(mesh.coords(i)["model"])
    expected = {dev: 0 for dev in on_dev}
    lead_tree = next(iter(placed.ranks.values()))
    whole = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
            return
        nbytes = node.numel() * node.element_size()
        if "moe" in path and path[-1] in _EXPERT_WEIGHTS:
            shards = _at(lead_tree, path)
            for dev in on_dev:
                expected[dev] += sum(
                    {t.untyped_storage().data_ptr():
                     t.untyped_storage().nbytes()
                     for t in shards.shards if t.device == dev}.values())
            return
        ax = tp_axis(cfg, path, node.shape, M)
        for dev, ranks in on_dev.items():
            expected[dev] += (nbytes if ax is None
                              else nbytes // M * len(ranks))
        if ax is None:
            return
        for (dev, m), tree in placed.ranks.items():
            t = _at(tree, path)
            if (t.shape == node.shape or t.untyped_storage().nbytes()
                    != t.numel() * t.element_size()):
                whole.append((str(dev), m, "/".join(path)))
    walk({k: params[k] for k in ("embed", "ln_f", "lm_head", "layers")
          if k in params}, ())
    return {"held": weight_storage(placed), "expected": expected,
            "whole": whole}


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


def kv_split(cfg: ModelConfig, M: int) -> bool:
    """Whether a merged cache over M model ranks splits the pools' KV
    heads: a GQA model whose heads split (`heads_split`).  An MLA
    model's latent and rope pools have no head axis: every model rank
    of a DP holds them whole and writes the same rows."""
    return cfg.attention != AttentionKind.MLA and heads_split(cfg, M)


def cache_tp_axis(cfg: ModelConfig, name: str, M: int) -> Optional[int]:
    """The axis of merged-cache entry `name` that M model ranks split, or
    None (whole on every rank): the pools' KV heads where `kv_split`
    says, a hybrid's SSM state by heads ("ssm" (L, slots, nh, hp, ds))
    and x conv tail by channels ("conv_x" (L, slots, d_conv-1, d_inner))
    where `ssm_split` says, an encoder-decoder's per-slot encoder K/V by
    heads ("enc_k"/"enc_v" (L, slots, Se, K, hd)) where cross-attention's
    heads split, so each rank holds only the heads it reads (the
    reference's `paged_cache_pspecs` leaves them whole); "conv_bc" (B
    and C, one group), cursors, tables and positions whole.  A dense
    cache split over a DP's ranks (`models.model.split_dense_cache`)
    splits the same entries."""
    if M <= 1:
        return None
    if name in ("k", "v"):
        return -2 if kv_split(cfg, M) else None
    if name in ENC_STACKS:
        return -2 if heads_split(cfg, M) else None
    if name in ("ssm", "conv_x") and ssm_split(cfg, M):
        return 2 if name == "ssm" else -1
    return None


def rank_share(t: torch.Tensor, axis: Optional[int], m: int, M: int
               ) -> torch.Tensor:
    """Model rank m's share of `t` along `axis` (`t` itself for None)."""
    if axis is None:
        return t
    n = t.shape[axis] // M
    return t.narrow(axis, m * n, n)


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
        for name, rows in (("k", b), ("v", b)) + tuple(
                (n_, s) for n_ in SLOT_STACKS if n_ in cache):
            ax = cache_tp_axis(cfg, name, M)
            shard[name] = rank_share(cache[name][:, rows], ax, m, M).to(
                dev, copy=True).contiguous()
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
    groups = dp_groups(merged)
    shards = [merged["shards"][g[0]] for g in groups]
    tabs = [torch.where(c["block_tab"] >= 0, c["block_tab"] + k * B, -1)
            for k, c in enumerate(shards)]
    out = {
        "cur": torch.cat([c["cur"].to(device) for c in shards]),
        "kv_pos": torch.cat([c["kv_pos"].to(device) for c in shards]),
        "block_tab": torch.cat([t.to(device) for t in tabs]).to(torch.int32),
    }
    for name in ("k", "v") + SLOT_STACKS:
        if name not in shards[0]:
            continue
        ax = cache_tp_axis(cfg, name, M)
        parts = [torch.cat([merged["shards"][i][name].to(device)
                            for i in g], ax) if ax is not None
                 else shards[k][name].to(device)
                 for k, g in enumerate(groups)]
        out[name] = torch.cat(parts, 1)
    return out


# ---------------------------------------------------------------------------
# The TPU-production rules (the dry-run's): specs over a logical mesh
# ---------------------------------------------------------------------------

class PSpec(tuple):
    """The port's `PartitionSpec`: one entry a dim, None (whole), an axis
    name or a tuple of axis names (a one-name tuple is kept as the bare
    name, as JAX keeps it).  Its `str` is the reference's."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return None if not a else (a[0] if len(a) == 1 else a)
            return a
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))

    __str__ = __repr__


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    n = _axis_size(mesh, axes)
    return n > 0 and dim % n == 0


class ShardingRules:
    """Resolves each leaf's spec for one (cfg, mesh, parallel): the
    reference's `ShardingRules`.  "model" is tensor parallelism (heads,
    FFN hidden, experts), "data" (with "pod" first where the mesh has
    it) the batch, FSDP for params and optimizer state when enabled, and
    the sequence of long-context decode; the experts go over
    `par.expert_axes`.  Every rule is divisibility-guarded: a dim is
    split only where it divides, else the next candidate or none."""

    def __init__(self, cfg: ModelConfig, mesh, par: ParallelConfig):
        self.cfg = cfg
        self.mesh = mesh
        self.par = par
        self.model = (par.model_axis if par.model_axis in mesh.axis_names
                      else None)
        self.data: Tuple[str, ...] = data_axes_of(mesh, par)
        self.fsdp: Optional[Tuple[str, ...]] = (
            tuple(a for a in par.fsdp_axes if a in mesh.axis_names)
            if par.fsdp_params else None)
        self.experts = (tuple(a for a in par.expert_axes
                              if a in mesh.axis_names) or (self.model,))

    def _fsdp_dim(self, shape, taken) -> Optional[int]:
        """The largest dim still free that the FSDP axes divide; none when
        another dim already uses an FSDP axis."""
        if not self.fsdp:
            return None
        used = set()
        for t in taken:
            if t is not None:
                used.update((t,) if isinstance(t, str) else tuple(t))
        if used & set(self.fsdp):
            return None
        best = None
        for i, d in enumerate(shape):
            if taken[i] is None and _fits(d, self.mesh, self.fsdp):
                if best is None or d > shape[best]:
                    best = i
        return best

    def matrix(self, shape, model_dim: Optional[int]) -> PSpec:
        """A weight: "model" on `model_dim` where it divides, FSDP on the
        largest other dim."""
        spec: list = [None] * len(shape)
        if model_dim is not None and self.model and \
                _fits(shape[model_dim], self.mesh, self.model):
            spec[model_dim] = self.model
        i = self._fsdp_dim(shape, spec)
        if i is not None:
            spec[i] = self.fsdp
        return PSpec(*spec)

    def expert_matrix(self, shape) -> PSpec:
        """(E, ...): E over the expert axes (or "model"), FSDP on the
        largest other dim."""
        spec: list = [None] * len(shape)
        ex = self.experts
        if ex and _fits(shape[0], self.mesh, ex):
            spec[0] = ex if len(ex) > 1 else ex[0]
        elif self.model and _fits(shape[0], self.mesh, self.model):
            spec[0] = self.model
        i = self._fsdp_dim(shape, spec)
        if i is not None:
            spec[i] = self.fsdp
        return PSpec(*spec)

    def replicated(self, shape) -> PSpec:
        return PSpec(*([None] * len(shape)))


def _leaf_spec(r: ShardingRules, path: Tuple[str, ...], shape) -> PSpec:
    """The reference's `_leaf_spec` on one weight of the port's tree.  The
    port keeps layers in lists (no stacked layer axis), so a leaf's spec
    is the reference's without its leading None."""
    name = path[-1]
    core = tuple(shape)
    if name == "embed":                          # (V, D)
        return r.matrix(core, 0 if _fits(core[0], r.mesh, r.model) else 1)
    if name == "lm_head":                        # (D, V)
        return r.matrix(core, 1 if _fits(core[1], r.mesh, r.model) else 0)
    if name in ("w_q", "w_k", "w_v"):            # (D, H|K, hd)
        return r.matrix(core, 1 if _fits(core[1], r.mesh, r.model) else 0)
    if name == "w_o":                            # (H, hd, D)
        return r.matrix(core, 0 if _fits(core[0], r.mesh, r.model) else 2)
    if name in ("w_uq", "w_uk", "w_uv"):         # (r|qin, H, dn)
        return r.matrix(core, 1 if _fits(core[1], r.mesh, r.model)
                        else None)
    if name in ("w_dq", "w_dkv", "w_kr", "proj", "router", "w_bc"):
        return r.matrix(core, None)
    if name in ("w_gate", "w_up"):               # dense (D, ff), MoE (E, D, f)
        return (r.expert_matrix(core) if len(core) == 3
                else r.matrix(core, 1))
    if name == "w_down":                         # (ff, D), MoE (E, f, D)
        return (r.expert_matrix(core) if len(core) == 3
                else r.matrix(core, 0))
    if name == "shared_gate" or name == "shared_up":     # (D, f·n)
        return r.matrix(core, 1)
    if name == "shared_down":                    # (f·n, D)
        return r.matrix(core, 0)
    if name in ("w_zx", "w_dt"):                 # (D, 2di) / (D, nh)
        return r.matrix(core, 1 if _fits(core[1], r.mesh, r.model)
                        else None)
    if name == "out_proj":                       # (di, D)
        return r.matrix(core, 0 if _fits(core[0], r.mesh, r.model)
                        else None)
    if name in ("conv_wx", "conv_bx"):           # (dconv, di), (di,)
        if not core:
            return r.replicated(core)
        return PSpec(*([None] * (len(core) - 1)),
                     r.model if _fits(core[-1], r.mesh, r.model) else None)
    # norms, biases, A_log, D_skip, dt_bias, router_bias, conv_wbc/bbc
    return r.replicated(core)


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dicts, lists and tuples, keeping
    its structure; a path is the keys from the root (list indices as
    "#i", as the reference's `_key_str` names them)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"#{i}",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspecs(cfg: ModelConfig, mesh, par: ParallelConfig, params):
    """Each weight's spec in the TPU-production layout: the reference's
    `param_pspecs` over the port's params tree (any tensors; only
    `.shape` is read).  The serving plane does not use it: it places by
    `tp_axis`, which differs where that function's note says."""
    rules = ShardingRules(cfg, mesh, par)
    return _map_with_path(lambda p, x: _leaf_spec(rules, p, x.shape),
                          params)


def cache_pspecs(cfg: ModelConfig, mesh, par: ParallelConfig, cache,
                 batch_size: int):
    """The reference's `cache_pspecs` over the port's dense decode cache:
    the batch on the data axes where it divides, else (long_500k, B = 1)
    the sequence on data; KV heads on "model" where they divide, else
    the sequence (an MLA latent's 4-dim entries: the sequence on model
    when it divides and is at least 256).  Stacks keep their leading
    layer axis whole."""
    rules = ShardingRules(cfg, mesh, par)
    data, model = rules.data, rules.model
    b_on_data = _fits(batch_size, mesh, data)

    def leaf(path, x):
        shape = x.shape
        if path[0] == "cur":
            return PSpec(data) if b_on_data else PSpec(None)
        if path[0] == "kv_pos":
            if b_on_data:
                return PSpec(data, None)
            return (PSpec(None, data) if _fits(shape[1], mesh, data)
                    else PSpec(None, None))
        spec: list = [None] * len(shape)
        if b_on_data and len(shape) >= 2:
            spec[1] = data
        if len(shape) == 5:                      # (L, B, S, K, hd)
            if model and _fits(shape[3], mesh, model):
                spec[3] = model
            elif model and _fits(shape[2], mesh, model):
                spec[2] = model
            if (not b_on_data and _fits(shape[2], mesh, data)
                    and spec[2] is None):
                spec[2] = data
        elif len(shape) == 4:                    # (L, B, S, r), conv tails
            if not b_on_data and _fits(shape[2], mesh, data):
                spec[2] = data
            elif model and _fits(shape[2], mesh, model) and shape[2] >= 256:
                spec[2] = model
        return PSpec(*spec)

    return _map_with_path(leaf, cache)


def paged_cache_pspecs(cfg: ModelConfig, mesh, par: ParallelConfig, cache):
    """The reference's `paged_cache_pspecs` over the port's paged cache:
    slots and physical blocks on the data axes where they divide, an
    attention pool's KV heads on "model" where they divide; per-slot
    entries (SSM state, encoder K/V) with their slots."""
    rules = ShardingRules(cfg, mesh, par)
    data, model = rules.data, rules.model
    slots = cache["cur"].shape[0]
    nblocks = cache["kv_pos"].shape[0]
    s_ax = data if _fits(slots, mesh, data) else None
    b_ax = data if _fits(nblocks, mesh, data) else None

    def leaf(path, x):
        shape = x.shape
        if path[0] == "cur":
            return PSpec(s_ax)
        if path[0] == "kv_pos":
            return PSpec(b_ax, None)
        if path[0] == "block_tab":
            return PSpec(s_ax, None)
        spec: list = [None] * len(shape)
        if len(shape) >= 2:
            if shape[1] == nblocks:
                spec[1] = b_ax
            elif shape[1] == slots:
                spec[1] = s_ax
        if (len(shape) == 5 and shape[1] == nblocks and model
                and _fits(shape[3], mesh, model)):
            spec[3] = model
        return PSpec(*spec)

    return _map_with_path(leaf, cache)


def batch_pspecs(mesh, par: ParallelConfig, batch_size: int, tree):
    """The batch on the data axes where it divides, else the sequence
    (dim 1, long context)."""
    data = data_axes_of(mesh, par)
    b_on_data = _fits(batch_size, mesh, data)

    def leaf(path, x):
        spec: list = [None] * len(x.shape)
        if b_on_data:
            spec[0] = data
        elif len(x.shape) >= 2 and _fits(x.shape[1], mesh, data):
            spec[1] = data
        return PSpec(*spec)

    return _map_with_path(leaf, tree)


def opt_pspecs(param_specs):
    """The optimizer's moments mirror the params' specs; its step is
    whole."""
    return {"mu": param_specs, "nu": param_specs, "step": PSpec()}
