"""Mixture-of-Experts FFN with sort-based dispatch.

Counterpart of `repro/models/moe.py`: `init_moe_params`, `route`,
`aux_loss`, `moe_block` and `moe_block_dense_reference`.  Dispatch sorts
the (token, expert) pairs by expert, gives each expert C capacity slots
and computes only the occupied slots, so the expert FLOPs are the active
ones; token movement is gathers (bytes, not FLOPs).  Scoring is softmax
or sigmoid (with the aux-loss-free selection bias and `routed_scaling`
of DeepSeek-V3); shared experts add a dense SwiGLU beside the routed
ones.

Capacity is part of the semantics, not an implementation detail: C =
ceil(T·k/E·capacity_factor) over the T tokens of ONE call, and an expert
keeps its first C pairs in token order and drops the rest.  A decode
step's call sees every slot of the batch, idle ones included, so
batched decode equals serial decode only while no expert overflows (as
in the reference).  Everything runs as torch ops on the tensors' device;
C comes from shapes, so dispatch needs no host sync.

Under a mesh context (`repro_torch.distributed.annotate.activate(...,
ep_shard_map=True)`, which the sharded engine spec sets around its
steps) `moe_block` takes the explicit all-to-all EP path
(`repro_torch.models.moe_ep.moe_block_ep`, per-source capacity) when
the context names expert axes, E divides over them and the tokens over
the mesh's devices, as the reference's dispatch rule does.  Otherwise it
keeps the single-program semantics above; where the expert weights are
split over a mesh (`ExpertShards`, a sharded spec's params), each
expert group computes on its home device and the rows come back.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.config.base import MoEConfig
from repro_torch.distributed import annotate
from repro_torch.distributed.sharding import ExpertShards, axis_size
from repro_torch.distributed.transfer import move
from repro_torch.models.layers import init_linear


def init_moe_params(gen: torch.Generator, d_model: int, mc: MoEConfig,
                    dtype) -> Dict:
    """Router (and the sigmoid router's selection bias) in fp32 whatever
    `dtype` is, as in the reference; expert weights stacked on a leading
    expert axis."""
    E, D, F = mc.num_experts, d_model, mc.d_expert

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w / math.sqrt(fan_in)).to(dtype)

    p = {
        "router": init_linear(gen, D, E, torch.float32),
        "w_gate": normal((E, D, F), D),
        "w_up": normal((E, D, F), D),
        "w_down": normal((E, F, D), F),
    }
    if mc.score_fn == "sigmoid":
        p["router_bias"] = torch.zeros(E, dtype=torch.float32,
                                       device=gen.device)
    if mc.num_shared:
        Fs = mc.num_shared * mc.d_shared
        p["shared_gate"] = init_linear(gen, D, Fs, dtype)
        p["shared_up"] = init_linear(gen, D, Fs, dtype)
        p["shared_down"] = init_linear(gen, Fs, D, dtype)
    return p


def route(x2d: torch.Tensor, params: Dict, mc: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing in fp32.  x2d (T, D) -> weights (T, k)
    fp32, expert ids (T, k) int64, probabilities (T, E)."""
    logits = x2d.float() @ params["router"]
    if mc.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"] if "router_bias" in params \
            else scores
        top_e = torch.topk(sel, mc.top_k, dim=-1).indices
        # weights from the raw scores at the selected experts, normalised
        top_w = torch.gather(scores, -1, top_e)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        top_w = top_w * mc.routed_scaling
        probs = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = torch.topk(probs, mc.top_k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, probs


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
             num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e f_e · P_e."""
    T = probs.shape[0]
    counts = torch.zeros(num_experts, dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(top_e.numel(), dtype=torch.float32,
                                 device=probs.device))
    f = counts / max(T * top_e.shape[-1], 1)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def capacity(T: int, mc: MoEConfig) -> int:
    """Slots per expert for a call of T tokens (the reference's formula,
    in the same float order)."""
    return max(int(math.ceil(T * mc.top_k / mc.num_experts
                             * mc.capacity_factor)), 1)


def _shared(x2d, params):
    gs = x2d @ params["shared_gate"]
    us = x2d @ params["shared_up"]
    hs = torch.nn.functional.silu(gs.float()).to(x2d.dtype) * us
    return hs @ params["shared_down"]


def _local_dispatch(x2d, top_w, top_e, E: int, C: int):
    """Sort-based dispatch of one call's (or, on the EP path, one source
    device's) T tokens: the (token, expert) pairs sorted by expert,
    token-major within each, each expert keeping its first C.  Returns
    (buckets (E, C, D), pos_tk (T, k): each pair's capacity slot, C where
    it was dropped).  The reference's `moe_ep._local_dispatch`, which
    its `moe_block` inlines."""
    T, D = x2d.shape
    k = top_e.shape[-1]
    dev = x2d.device
    flat_e = top_e.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - first[sorted_e]
    keep = pos_in_e < C
    c_idx = torch.where(keep, pos_in_e, C)                    # C = drop bin
    tok = order // k                                          # source token
    # (E, C+1) slot -> source token; T is the zero padding row
    tok_buf = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    tok_buf[sorted_e, c_idx] = torch.where(keep, tok, T)
    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
    pos_tk = torch.empty(T * k, dtype=torch.long, device=dev)
    pos_tk[order] = c_idx
    return x_pad[tok_buf[:, :C]], pos_tk.reshape(T, k)


def _ep_route(x, mc: MoEConfig):
    """(mesh, token axes, expert axes) when the active mesh context sends
    this call down the EP path, else None: the context asks for it and
    names expert axes, E divides over them, and the T tokens over the
    mesh's devices (at least one each)."""
    ctx = annotate.active()
    if ctx is None or not ctx.get("ep"):
        return None
    mesh = ctx["mesh"]
    ep = annotate.axes_of(ctx, "experts")
    if isinstance(x, (list, tuple)):
        T = sum(t.numel() // t.shape[-1] for t in x)
    else:
        T = x.numel() // x.shape[-1]
    G = axis_size(mesh, ep) if ep else 0
    if (ep and G and mc.num_experts % G == 0 and T % mesh.size == 0
            and T // mesh.size >= 1):
        return mesh, annotate.axes_of(ctx, "tokens"), ep
    return None


def _experts(h, params):
    """The expert SwiGLU over the capacity buckets h (E, C, D): on h's
    device, or, for weights split over a mesh (`ExpertShards`), each EP
    rank's experts on their home device, the rows moved there and
    back."""
    w = params["w_gate"]
    if not isinstance(w, ExpertShards):
        g = torch.bmm(h, params["w_gate"])
        u = torch.bmm(h, params["w_up"])
        act = torch.nn.functional.silu(g.float()).to(h.dtype) * u
        return torch.bmm(act, params["w_down"])
    homes = [params[n].home for n in ("w_gate", "w_up", "w_down")]
    hs = move([h[r * w.E_per:(r + 1) * w.E_per] for r in range(w.G)],
              [homes[0](r).device for r in range(w.G)])
    ys = [_experts(hr, {"w_gate": homes[0](r), "w_up": homes[1](r),
                        "w_down": homes[2](r)})
          for r, hr in enumerate(hs)]
    return torch.cat(move(ys, [h.device] * w.G))


def moe_block(x, params: Dict, mc: MoEConfig):
    """Apply the MoE FFN.  x (B, S, D) or (T, D); or, on the sharded
    plane's merged decode step, a list of per-shard tensors (one output
    per shard, in place).  Returns (out of x's shape, aux loss; the EP
    path's list form gives each device's aux loss, on it)."""
    ep = _ep_route(x, mc)
    if ep is not None:
        from repro_torch.models.moe_ep import moe_block_ep
        return moe_block_ep(x, params, mc, *ep)
    if isinstance(x, (list, tuple)):
        # single-program semantics over every shard's tokens at once
        lead = x[0].device
        out, laux = moe_block(torch.cat(move(x, [lead] * len(x))), params,
                              mc)
        sizes = [t.shape[0] for t in x]
        return move(list(out.split(sizes)), [t.device for t in x]), laux
    orig_shape = x.shape
    x2d = x.reshape(-1, x.shape[-1])
    T, D = x2d.shape
    E = mc.num_experts

    top_w, top_e, probs = route(x2d, params, mc)
    laux = aux_loss(probs, top_e, E)
    h, pos_tk = _local_dispatch(x2d, top_w, top_e, E, capacity(T, mc))

    # ---- expert SwiGLU on the occupied slots ----
    y = _experts(h, params)                                   # (E, C, D)

    # ---- combine: a per-token gather of its k expert outputs ----
    y_pad = torch.cat([y, y.new_zeros(E, 1, D)], dim=1)
    contrib = y_pad[top_e, pos_tk]                            # (T, k, D)
    out = (contrib * top_w[..., None].to(y.dtype)).sum(dim=1)

    if mc.num_shared:
        out = out + _shared(x2d, params)
    return out.reshape(orig_shape), laux


def moe_block_dense_reference(x: torch.Tensor, params: Dict, mc: MoEConfig
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, weighted by the routing (O(E) FLOPs):
    the plain version `moe_block` equals while no pair is dropped."""
    orig_shape = x.shape
    x2d = x.reshape(-1, x.shape[-1])
    top_w, top_e, probs = route(x2d, params, mc)
    laux = aux_loss(probs, top_e, mc.num_experts)
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, params["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x2d.dtype) * u
    y = torch.einsum("tef,efd->ted", h, params["w_down"])      # (T, E, D)
    w_full = torch.zeros(x2d.shape[0], mc.num_experts, dtype=y.dtype,
                         device=x2d.device)
    w_full.scatter_add_(1, top_e, top_w.to(y.dtype))
    out = torch.einsum("te,ted->td", w_full, y)
    if mc.num_shared:
        out = out + _shared(x2d, params)
    return out.reshape(orig_shape), laux
