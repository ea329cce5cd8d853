"""Numpy bridge between the JAX package's pytrees and the port's layouts.

The two frameworks draw different random numbers from the same seed, so
parity tests make the weights once on the JAX side and hand them over:
`params_from_numpy(cfg, jax.tree.map(np.asarray, params))`.  The bridge
itself only sees numpy arrays and nested dicts/tuples — it never imports
JAX or the `repro` package.

JAX stacks the layers of each group of `layer_layout` (the dense prefix,
then one stack per pattern slot); the port keeps one list (params) or
one leading layer axis (caches) in model order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.model import layer_layout, require_supported


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

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return _tensor(np.asarray(node)[i], dtype, device)

    params = {"embed": _tensor(tree["embed"], dtype, device),
              "ln_f": _tensor(tree["ln_f"], dtype, device)}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], dtype, device)
    params["layers"] = [take(_group(tree, key), i)
                        for key, i in _layer_slots(cfg)]
    return params


def cache_from_numpy(cfg: ModelConfig, tree: Dict, dtype=torch.float32,
                     device="cuda") -> Dict:
    """A JAX paged cache (or dense batch-1 cache) as the port's cache."""
    require_supported(cfg)
    out = {key: _tensor(tree[key], torch.int32, device)
           for key in ("cur", "kv_pos", "block_tab") if key in tree}
    for n, name in enumerate(("k", "v")):
        out[name] = torch.stack([
            _tensor(np.asarray(_group(tree, key)[n])[i], dtype, device)
            for key, i in _layer_slots(cfg)])
    return out


def cache_to_numpy(cfg: ModelConfig, cache: Dict) -> Dict:
    """The port's cache in the JAX cache layout (numpy leaves)."""
    slots = _layer_slots(cfg)
    out: Dict = {key: cache[key].cpu().numpy()
                 for key in ("cur", "kv_pos", "block_tab") if key in cache}
    out["blocks"] = {}
    for key in dict.fromkeys(k for k, _ in slots):
        layers = [l for l, (k, _) in enumerate(slots) if k == key]
        entry = tuple(cache[name][layers].float().cpu().numpy()
                      for name in ("k", "v"))
        if key == "prefix":
            out["prefix"] = entry
        else:
            out["blocks"][key] = entry
    return out
