"""Checkpoints in the reference's `.npz` format (path-keyed,
structure-preserving), so a checkpoint crosses packages in both
directions.

Counterpart of `repro/checkpoint/checkpoint.py`.  A tree is a dict (or
list) nested to arrays or tensors; each leaf is stored under its path
("params/blocks/p0/attn/w_q", "opt/mu/...", "#i" for a list index), as
the reference's `tree_flatten_with_path` keys it; the metadata
(`{"step", "extra"}`) is JSON under "__meta__".  The port's params are a
list of layers, the reference's a stack a group: the trainer converts
them with `repro_torch.bridge.params_to_numpy` before saving and
`params_from_numpy` after loading.  Tensors are copied to the host
before saving; the write is atomic (a temporary file, then a rename).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_numpy


def _host(leaf) -> np.ndarray:
    return to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _rebuild(v, leaves, f"{prefix}/#{i}" if prefix else f"#{i}")
            for i, v in enumerate(template))
    return leaves[prefix]


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Write `tree` as `ckpt_{step:08d}.npz` in `directory`; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    meta = {"step": step, "extra": extra or {}}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _dtype(leaf):
    """The numpy dtype a template leaf loads as (fp32 for bf16)."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.asarray(leaf).dtype


def load_checkpoint(directory: str, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of `template` (a tree of arrays or
    tensors): every leaf must be in the file (KeyError) with the
    template's shape (ValueError); it comes back as a numpy array of the
    template leaf's dtype (fp32 for a bf16 tensor).  Returns (tree,
    step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    leaves = {}
    for key, leaf in _flatten(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        leaves[key] = arr.astype(_dtype(leaf))
    return _rebuild(template, leaves), meta["step"], meta.get("extra", {})
