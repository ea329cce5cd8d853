"""Per-device cost of one step for the dry-run's roofline.

The port's counterpart of `repro/launch/hlo_analysis.py`.  The
reference compiles each step for the production mesh and reads the
partitioned HLO: dot FLOPs with loop trip counts, the bytes of
materialised ops, and the collectives GSPMD inserted.  Torch has no
such program, so this module runs the step once on `meta` tensors
(`launch.specs`) and takes the same three per-device quantities from
what the step does and what the sharding specs imply:

  flops            — the step's matmul, convolution and attention FLOPs
                     (`torch.utils.flop_counter.FlopCounterMode`; the
                     backward and every remat recomputation included),
                     divided by the chips: GSPMD spreads every product
                     over the mesh.
  hbm_bytes        — each device's share of the step's inputs and
                     outputs under their specs (a leaf's bytes over the
                     product of the mesh axes its spec names), plus the
                     outputs of the step's ops (every non-view aten op
                     the step dispatches, over the chips).
  collective_bytes — what the specs imply for one step, per device, in
                     output bytes of each collective as the reference's
                     parser counts them (`collectives` by kind):
      all-gather      FSDP: each weight whose spec names the FSDP axes
                      is gathered (to its bytes over its "model" split)
                      once per forward and once more per remat
                      recomputation: n_fwd = 1 + (remat != "none");
      reduce-scatter  FSDP: each such weight's gradient, scattered to its
                      shard (bytes over its whole split); the gradient
                      of a weight whose spec names neither the FSDP
                      nor all the data axes is all-reduced over data
                      instead (bytes over its "model" split);
      all-reduce      TP: one after each row-parallel product, i.e. each
                      weight whose contraction dim is split on "model"
                      (w_o, a dense w_down, out_proj, shared_down, and
                      the vocabulary-split embedding lookup), of the
                      product's output: tokens a device × d_model ×
                      bytes; n_fwd times a step, and in training once
                      more for each column-parallel product's input
                      gradient (its weight's output dim on "model");
      all-to-all      EP: dispatch and combine in each MoE layer whose
                      experts are split, tokens a device × top_k ×
                      capacity_factor × d_model × bytes each, n_fwd
                      times a step and twice more in training (the
                      backward's).
                     Tokens a device: batch × sequence (decode: 1) over
                     the data axes the batch (or, long context, the
                     sequence) is split on.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config.base import ModelConfig, ParallelConfig

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def spec_share(mesh, spec) -> int:
    """How many pieces a leaf of `spec` is cut into on `mesh`."""
    n = 1
    for a in spec:
        for ax in ((a,) if isinstance(a, str) else (a or ())):
            n *= mesh.shape[ax]
    return n


def _pairs(tree, specs):
    """(leaf, spec) of a tree and its spec tree (same structure)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def sharded_bytes(mesh, tree, specs) -> float:
    """A device's share of `tree`'s bytes under `specs`."""
    return sum(_nbytes(t) / spec_share(mesh, s) for t, s in _pairs(tree,
                                                                  specs))


class _OpBytes(TorchDispatchMode):
    """Sums the output bytes of every non-view op dispatched under it,
    and follows the bytes alive (each output until it is freed): `peak`
    is the most the step's temporaries held at once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    n = _nbytes(t)
                    self.bytes += n
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def run_counted(fn, *args):
    """Run `fn(*args)` on meta tensors; returns (its outputs, FLOPs, op
    output bytes, peak bytes of the step's temporaries)."""
    with FlopCounterMode(display=False) as fc, _OpBytes() as ob:
        out = fn(*args)
    return out, fc.get_total_flops(), ob.bytes, ob.peak


def tokens_per_device(mesh, batch: int, seq: int,
                      data_axes: Sequence[str]) -> float:
    """Tokens one device holds: the batch over the data axes where it
    divides, else the sequence (long context), else all."""
    n = math.prod(mesh.shape[a] for a in data_axes)
    if batch % n == 0 or seq % n == 0:
        return batch * seq / n
    return float(batch * seq)


def _model_dims(spec, model: str):
    return [i for i, a in enumerate(spec)
            if a == model or (isinstance(a, tuple) and model in a)]


def collective_estimate(cfg: ModelConfig, mesh, par: ParallelConfig,
                        params, p_specs, kind: str, tokens: float,
                        remat: str, data: Sequence[str],
                        dtype_bytes: int = 2) -> Dict:
    """The module note's formula for one step of `kind` ("train",
    "prefill", "decode") over `tokens` a device, with the batch on the
    `data` axes: {"bytes_by_op", "counts"} per device, by collective
    kind."""
    bytes_by = {c: 0.0 for c in COLLECTIVES}
    counts = {c: 0.0 for c in COLLECTIVES}
    model = par.model_axis if par.model_axis in mesh.axis_names else None
    fsdp = (tuple(a for a in par.fsdp_axes if a in mesh.axis_names)
            if par.fsdp_params else ())
    train = kind == "train"
    n_fwd = 1 + (train and remat not in (None, False, "none"))
    act = tokens * cfg.d_model * dtype_bytes

    def add(op, n, nbytes):
        counts[op] += n
        bytes_by[op] += n * nbytes

    def walk(tree, specs, path):
        if isinstance(tree, torch.Tensor):
            leaf(path, tree, specs)
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, specs[k], path + (k,))
        else:
            for i, (v, s) in enumerate(zip(tree, specs)):
                walk(v, s, path + (str(i),))

    def leaf(path, t, spec):
        name = path[-1]
        axes = {ax for a in spec
                for ax in ((a,) if isinstance(a, str) else (a or ()))}
        m_split = mesh.shape[model] if model and model in axes else 1
        full = _nbytes(t) / m_split
        if train:
            if fsdp and set(fsdp) <= axes:
                add("all-gather", n_fwd, full)
                add("reduce-scatter", 1, _nbytes(t) / spec_share(mesh,
                                                                 spec))
            elif not set(data) <= axes:         # replicated over data
                add("all-reduce", 1, full)
        md = _model_dims(spec, model) if model else []
        if not md or t.dim() < 2:
            return
        d = md[0]
        if name == "embed" and d == 0:
            add("all-reduce", n_fwd, act)        # vocabulary-split lookup
        elif name in ("w_o", "out_proj", "shared_down") or (
                name == "w_down" and t.dim() == 2):
            if d == 0:                           # contraction dim split
                add("all-reduce", n_fwd, act)
            elif train:
                add("all-reduce", 1, act)
        elif train and name in ("w_q", "w_k", "w_v", "w_uq", "w_uk",
                                "w_uv", "w_gate", "w_up", "w_zx", "w_dt",
                                "shared_gate", "shared_up", "lm_head") \
                and t.dim() == 2 and d == t.dim() - 1:
            add("all-reduce", 1, act)            # input gradient
        if name == "w_gate" and t.dim() == 3 and "moe" in path:
            ex = [a for a in spec[0:1] if a is not None]
            if ex:
                mc = cfg.moe
                a2a = (tokens * mc.top_k * mc.capacity_factor * cfg.d_model
                       * dtype_bytes)
                add("all-to-all", 2 * n_fwd + (2 if train else 0), a2a)

    walk(params, p_specs, ())
    return {"bytes_by_op": bytes_by, "counts": counts}
