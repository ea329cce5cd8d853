"""Shape dry-run: every (architecture × input shape) on the production
meshes, with per-device memory, cost and collective analysis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \
        --shape prefill_32k --mesh single --out experiments/dryrun_torch

Counterpart of `repro/launch/dryrun.py` (`default_parallel`,
`lower_one`, `_lower_inner`, the same CLI and the same record keys and
statuses: "ok", "skipped", "FAILED"; "lowered" with `--no-compile`).
The reference lowers and compiles each step for a 16 × 16 or 2 × 16 ×
16 mesh of forced host devices; the port lays the same logical mesh
over `meta` devices (`make_production_mesh`), places every input with
the port's copy of the production sharding rules
(`distributed.sharding.param_pspecs` and the rest) and runs the step
once on `meta` tensors (`launch.specs`), which allocates nothing; its
per-device costs come from `launch.step_analysis` (the counterpart of
`hlo_analysis.py`).  It needs no card and runs on the CPU.  Each record
adds `fits`: whether a device's bytes (its share of the inputs and the
step's temporaries at their most) stay under the card's memory.

No figure a record holds is measured: they are counts over shapes and
a roofline against published peaks.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.config.base import (
    INPUT_SHAPES, InputShape, ModelConfig, ParallelConfig, get_arch,
)
from repro_torch.distributed.sharding import (
    batch_pspecs, cache_pspecs, data_axes_of, opt_pspecs, param_pspecs,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    abstract_opt_state, applicable, batch_inputs, make_step_fn,
)
from repro_torch.launch.step_analysis import (
    collective_estimate, run_counted, sharded_bytes, tokens_per_device,
)
from repro_torch.models.model import abstract_params

# NVIDIA H100 80GB HBM3, 700 W (SXM), per card: the published dense bf16
# peak, the HBM3 rate and NVLink's rate each way; the reference's are
# TPU v5e's
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
HBM_BYTES = 80e9


def default_parallel(cfg: ModelConfig, shape: InputShape,
                     mesh) -> ParallelConfig:
    """FSDP and block remat for training; experts over ("data", "model")
    where they divide the whole mesh, else over "model"."""
    ex = ("model",)
    if cfg.moe.num_experts:
        for cand in (("data", "model"), ("model",)):
            if all(a in mesh.axis_names for a in cand):
                n = 1
                for a in cand:
                    n *= mesh.shape[a]
                if cfg.moe.num_experts % n == 0:
                    ex = cand
                    break
    return ParallelConfig(
        fsdp_params=(shape.kind == "train"),
        expert_axes=ex,
        remat=("block" if shape.kind == "train" else "none"),
        zero1=True,
    )


def lower_one(arch: str, shape_name: str, multi_pod: bool,
              compile_: bool = True, dtype=torch.bfloat16,
              parallel: Optional[ParallelConfig] = None) -> Dict:
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    par = parallel or default_parallel(cfg, shape, mesh)
    return _lower_inner(cfg, shape, mesh, par, rec, compile_, dtype,
                        time.time())


def _lower_inner(cfg, shape, mesh, par, rec, compile_, dtype, t0):
    params = abstract_params(cfg, dtype)
    p_specs = param_pspecs(cfg, mesh, par, params)
    remat = os.environ.get("REPRO_REMAT", par.remat)
    fn, _donate = make_step_fn(cfg, shape, remat=remat)
    B = shape.global_batch
    ins = batch_inputs(cfg, shape, dtype)
    in_bytes = sharded_bytes(mesh, params, p_specs)
    if shape.kind == "train":
        opt = abstract_opt_state(params)
        o_specs = opt_pspecs(p_specs)
        b_specs = batch_pspecs(mesh, par, B, ins["batch"])
        args = (params, opt, ins["batch"])
        in_bytes += (sharded_bytes(mesh, opt, o_specs)
                     + sharded_bytes(mesh, ins["batch"], b_specs))

        def out_bytes(out):
            return (sharded_bytes(mesh, out[0], p_specs)
                    + sharded_bytes(mesh, out[1], o_specs))
    elif shape.kind == "prefill":
        args = (params,) + tuple(ins.values())
        in_bytes += sharded_bytes(mesh, ins, batch_pspecs(mesh, par, B, ins))

        def out_bytes(out):
            logits, cache = out
            return (sharded_bytes(mesh, logits, batch_pspecs(mesh, par, B,
                                                             logits))
                    + sharded_bytes(mesh, cache, cache_pspecs(
                        cfg, mesh, par, cache, B)))
    else:
        c_specs = cache_pspecs(cfg, mesh, par, ins["cache"], B)
        args = (params, ins["token"], ins["cache"])
        in_bytes += (sharded_bytes(mesh, ins["cache"], c_specs)
                     + sharded_bytes(mesh, ins["token"], batch_pspecs(
                         mesh, par, B, ins["token"])))

        def out_bytes(out):
            logits, cache = out
            return (sharded_bytes(mesh, logits, batch_pspecs(mesh, par, B,
                                                             logits))
                    + sharded_bytes(mesh, cache, c_specs))
    rec["lower_s"] = round(time.time() - t0, 2)
    if not compile_:
        rec["status"] = "lowered"
        return rec
    t1 = time.time()
    out, flops, op_bytes, peak = run_counted(fn, *args)
    rec["compile_s"] = round(time.time() - t1, 2)
    chips = mesh.size
    data = data_axes_of(mesh, par)
    tokens = tokens_per_device(
        mesh, B, shape.seq_len if shape.kind != "decode" else 1, data)
    coll = collective_estimate(cfg, mesh, par, params, p_specs, shape.kind,
                               tokens, remat, data,
                               dtype_bytes=torch.finfo(dtype).bits // 8)
    o_bytes = out_bytes(out)
    rec["memory"] = {"argument_size_in_bytes": int(in_bytes),
                     "output_size_in_bytes": int(o_bytes),
                     "temp_size_in_bytes": int(peak / chips)}
    an = {"flops_per_device": flops / chips,
          "hbm_bytes_per_device": in_bytes + o_bytes + op_bytes / chips,
          "collective_bytes_per_device": sum(coll["bytes_by_op"].values()),
          "collectives": coll}
    rec["analysis"] = an
    rec["fits"] = (in_bytes + peak / chips) < HBM_BYTES
    pc = cfg.param_counts()
    n_tok = B * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * pc["active"] \
        * n_tok
    flops_global = an["flops_per_device"] * chips
    rec["roofline"] = {
        "chips": chips,
        "card": "NVIDIA H100 80GB HBM3, 700 W",
        "compute_s": an["flops_per_device"] / PEAK_FLOPS,
        "memory_s": an["hbm_bytes_per_device"] / HBM_BW,
        "collective_s": an["collective_bytes_per_device"] / NVLINK_BW,
        "model_flops": model_flops,
        "step_flops_global": flops_global,
        "useful_ratio": (model_flops / flops_global
                         if flops_global else 0.0),
    }
    terms = {k: rec["roofline"][k]
             for k in ("compute_s", "memory_s", "collective_s")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)
    rec["status"] = "ok"
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import ASSIGNED
    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    rec = lower_one(arch, shape, mp,
                                    compile_=not args.no_compile)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAILED", "error": repr(e)}
                    n_fail += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" compute={r['compute_s']*1e3:.2f}ms "
                             f"mem={r['memory_s']*1e3:.2f}ms "
                             f"coll={r['collective_s']*1e3:.2f}ms "
                             f"bound={r['bottleneck'].split('_')[0]} "
                             f"useful={r['useful_ratio']:.2f} "
                             f"fits={rec['fits']}")
                elif status == "FAILED":
                    extra = " " + rec.get("error", "")[:120]
                elif status == "skipped":
                    extra = " " + rec.get("reason", "")[:80]
                print(f"[{status:>7s}] {tag}{extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} combinations failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
