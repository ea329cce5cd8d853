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
`(ssm_state, (conv_x, conv_bc))`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config.base import LayerKind, ModelConfig
from repro_torch.models.model import (
    layer_layout, require_supported, stack_index,
)

# SSM leaves the JAX init keeps in fp32 whatever the model's dtype
_FP32_LEAVES = ("A_log", "D_skip", "dt_bias")


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
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(cfg: ModelConfig, tree: Dict, dtype=torch.float32,
                      device="cuda") -> Dict:
    """The JAX `init_params` pytree (numpy leaves) as the port's params."""
    require_supported(cfg)

    def take(node, i, name=""):
        if isinstance(node, dict):
            return {k: take(v, i, k) for k, v in node.items()}
        dt = torch.float32 if name in _FP32_LEAVES else dtype
        return _tensor(np.asarray(node)[i], dt, device)

    params = {"embed": _tensor(tree["embed"], dtype, device),
              "ln_f": _tensor(tree["ln_f"], dtype, device)}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], dtype, device)
    params["layers"] = [take(_group(tree, key), i)
                        for key, i in _layer_slots(cfg)]
    return params


def _stacks(cfg: ModelConfig):
    """The JAX (group key, index) of the layers of each port cache stack:
    (attention layers, SSM layers), each in model order."""
    attn, ssm = [], []
    for slot, (kind, _) in zip(_layer_slots(cfg), stack_index(cfg)):
        (attn if kind == LayerKind.DENSE else ssm).append(slot)
    return attn, ssm


def cache_from_numpy(cfg: ModelConfig, tree: Dict, dtype=torch.float32,
                     device="cuda") -> Dict:
    """A JAX cache — paged, or dense with B rows of S_buf entries (a
    window ring for SWA models) — as the port's cache."""
    require_supported(cfg)
    out = {key: _tensor(tree[key], torch.int32, device)
           for key in ("cur", "kv_pos", "block_tab") if key in tree}
    attn, ssm = _stacks(cfg)

    def stack(slots, leaf, dt):
        return torch.stack([_tensor(np.asarray(leaf(_group(tree, key)))[i],
                                    dt, device) for key, i in slots])
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
        if layers[0][0] == LayerKind.DENSE:
            entry = (leaf("k"), leaf("v"))
        else:
            entry = (leaf("ssm"), (leaf("conv_x"), leaf("conv_bc")))
        if key == "prefix":
            out["prefix"] = entry
        else:
            out["blocks"][key] = entry
    return out
