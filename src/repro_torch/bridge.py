"""Numpy bridge between the JAX package's pytrees and the port's layouts.

The two frameworks draw different random numbers from the same seed, so
parity tests make the weights once on the JAX side and hand them over:
`params_from_numpy(cfg, jax.tree.map(np.asarray, params))`.  The bridge
itself only sees numpy arrays and nested dicts/tuples — it never imports
JAX or the `repro` package.

JAX stacks the layers of each group of `layer_layout` (the dense prefix,
then one stack per pattern slot); the port keeps one list (params) in
model order, and one leading layer axis per cache stack (the attention
layers' "k"/"v", the SSM layers' "ssm"/"conv_x"/"conv_bc", each in model
order; see `repro_torch.models.model`).  A JAX SSM cache entry is
`(ssm_state, (conv_x, conv_bc))`; an attention entry is `(k, v)`, for
MLA `(latent, rope key)`, which the port keeps in "k" and "v"; a
decoder layer of an encoder-decoder model has `(entry, (enc_k,
enc_v))`, whose encoder K/V the port keeps in "enc_k"/"enc_v" over
every layer.  The encoder's stacked layers ("encoder") become a list.
DeepSeek-V3's multi-token-prediction head ("mtp") is one block, not a
stack, in both packages.  `params_to_numpy` is `params_from_numpy`'s
inverse (the port's params, an optimizer's moments of the same tree,
back into the reference's stacks), so a checkpoint crosses packages in
both directions.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.blocks import ATTN_KINDS
from repro_torch.models.model import (
    layer_layout, require_supported, stack_index,
)

# leaves the JAX init keeps in fp32 whatever the model's dtype: the SSM
# decay and skip terms, the MoE router and its selection bias
_FP32_LEAVES = ("A_log", "D_skip", "dt_bias", "router", "router_bias")


def _layer_slots(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(JAX group key, index within its stack) of every layer, in model
    order."""
    P, pattern, reps = layer_layout(cfg)
    slots = [("prefix", i) for i in range(P)]
    slots += [(f"p{j}", r) for r in range(reps) for j in range(len(pattern))]
    return slots


def _group(tree: Dict, key: str):
    return tree[key] if key == "prefix" else tree["blocks"][key]


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: widen exactly first
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def params_from_numpy(cfg: ModelConfig, tree: Dict, dtype=torch.float32,
                      device="cuda") -> Dict:
    """The JAX `init_params` pytree (numpy leaves) as the port's params,
    an encoder-decoder's cross-attention ("ln_x", "xattn" in every
    decoder layer) and encoder ("encoder", "enc_ln_f") included, and
    DeepSeek-V3's multi-token-prediction head ("mtp", read by the
    training loss).  The same tree of an optimizer's moments (fp32)
    bridges alike with `dtype=torch.float32`."""
    require_supported(cfg)

    def take(node, i, name=""):
        if isinstance(node, dict):
            return {k: take(v, i, k) for k, v in node.items()}
        dt = torch.float32 if name in _FP32_LEAVES else dtype
        a = np.asarray(node)
        return _tensor(a if i is None else a[i], dt, device)

    params = {"embed": _tensor(tree["embed"], dtype, device),
              "ln_f": _tensor(tree["ln_f"], dtype, device)}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], dtype, device)
    params["layers"] = [take(_group(tree, key), i)
                        for key, i in _layer_slots(cfg)]
    if "encoder" in tree:
        params["encoder"] = [take(tree["encoder"], i)
                             for i in range(cfg.num_encoder_layers)]
        params["enc_ln_f"] = _tensor(tree["enc_ln_f"], dtype, device)
    if "mtp" in tree:
        params["mtp"] = take(tree["mtp"], None)
    return params


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array: fp32 and int kept, bf16 and fp16
    widened to fp32 (numpy has no bf16)."""
    t = t.detach()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    return t.cpu().numpy()


def params_to_numpy(cfg: ModelConfig, params: Dict) -> Dict:
    """The port's params (or a tree of the same shape: an optimizer's
    moments) as the reference's `init_params` pytree with numpy leaves:
    the layers stacked by group of `layer_layout` ("prefix", then
    "blocks"/"p{j}" over the pattern's repetitions), the encoder's
    layers stacked, "mtp" as one block.  The inverse of
    `params_from_numpy` (bf16 leaves come back widened to fp32)."""
    require_supported(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return to_numpy(node)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([l[k] for l in layers]) for k in layers[0]}
        return np.stack([to_numpy(t) for t in layers])

    out = {k: conv(params[k]) for k in ("embed", "ln_f", "lm_head",
                                        "enc_ln_f", "mtp") if k in params}
    groups: Dict = {}
    for (key, _i), layer in zip(_layer_slots(cfg), params["layers"]):
        groups.setdefault(key, []).append(layer)
    if "prefix" in groups:
        out["prefix"] = stack(groups.pop("prefix"))
    out["blocks"] = {key: stack(layers) for key, layers in groups.items()}
    if "encoder" in params:
        out["encoder"] = stack(params["encoder"])
    return out


def _stacks(cfg: ModelConfig):
    """The JAX (group key, index) of the layers of each port cache stack:
    (attention layers, SSM layers), each in model order."""
    attn, ssm = [], []
    for slot, (kind, _) in zip(_layer_slots(cfg), stack_index(cfg)):
        (attn if kind in ATTN_KINDS else ssm).append(slot)
    return attn, ssm


def cache_from_numpy(cfg: ModelConfig, tree: Dict, dtype=torch.float32,
                     device="cuda") -> Dict:
    """A JAX cache — paged, or dense with B rows of S_buf entries (a
    window ring for SWA models) — as the port's cache."""
    require_supported(cfg)
    out = {key: _tensor(tree[key], torch.int32, device)
           for key in ("cur", "kv_pos", "block_tab") if key in tree}
    attn, ssm = _stacks(cfg)
    enc = cfg.is_encoder_decoder

    def stack(slots, leaf, dt):
        def core(e):          # a decoder layer's own entry
            return leaf(e[0] if enc else e)
        return torch.stack([_tensor(np.asarray(core(_group(tree, key)))[i],
                                    dt, device) for key, i in slots])
    if enc:
        for j, name in enumerate(("enc_k", "enc_v")):
            out[name] = torch.stack([
                _tensor(np.asarray(_group(tree, key)[1][j])[i], dtype,
                        device) for key, i in _layer_slots(cfg)])
    if attn:
        out["k"] = stack(attn, lambda e: e[0], dtype)
        out["v"] = stack(attn, lambda e: e[1], dtype)
    if ssm:
        out["ssm"] = stack(ssm, lambda e: e[0], torch.float32)
        out["conv_x"] = stack(ssm, lambda e: e[1][0], dtype)
        out["conv_bc"] = stack(ssm, lambda e: e[1][1], dtype)
    return out


def cache_to_numpy(cfg: ModelConfig, cache: Dict) -> Dict:
    """The port's cache (paged or dense) in the JAX cache layout (numpy
    leaves)."""
    slots = _layer_slots(cfg)
    index = stack_index(cfg)
    out: Dict = {key: cache[key].cpu().numpy()
                 for key in ("cur", "kv_pos", "block_tab") if key in cache}
    out["blocks"] = {}
    for key in dict.fromkeys(k for k, _ in slots):
        layers = [index[l] for l, (k, _) in enumerate(slots) if k == key]
        rows = [i for _kind, i in layers]

        def leaf(name):
            return cache[name][rows].float().cpu().numpy()
        if layers[0][0] in ATTN_KINDS:
            entry = (leaf("k"), leaf("v"))
        else:
            entry = (leaf("ssm"), (leaf("conv_x"), leaf("conv_bc")))
        if "enc_k" in cache:
            ls = [l for l, (k, _) in enumerate(slots) if k == key]
            entry = (entry, tuple(cache[n][ls].float().cpu().numpy()
                                  for n in ("enc_k", "enc_v")))
        if key == "prefix":
            out["prefix"] = entry
        else:
            out["blocks"][key] = entry
    return out
