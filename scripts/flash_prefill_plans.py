#!/usr/bin/env python3
"""Kernel #2's bodies at every plan they can take, on the port's shapes.

    python3 scripts/flash_prefill_plans.py [--iters N] [--out PATH]
        [--only all|bf16|fp32] [--root TREE]

For each shape the port's paths call kernel #2 at (in bf16: whisper-
large-v3's encoder and its cross-attention, the serves' paged and
contiguous chunks, the MoE serve's paged chunk, granite-moe-1b-a400m's
TP dense chunk at one rank's heads, internvl2-1b's G = 7 prefill, long
causal prefills; in fp32: minicpm-2b's training forward, a paged chunk
at head dim 128, a contiguous chunk at head dim 120 and whisper's
encoder not causal), calls the kernel through the binding at each
candidate plan (rows a CTA, splits over the keys), holds every output
against the plain version (per head vector 1e-2 in bf16, 1e-4 in fp32,
as `chip_smoke.py`), and times it: device ms as `chip_smoke.time_ms`
measures it, K and V rotated over four copies.  A plan the binding
refuses is listed as refused.  Then it calls the wrapper once and
prints the plan the planner (`flash_splits`) passed beside the fastest
one.  A causal chunk is timed early in its cache (few live keys) and
late (most keys live), since the live keys are what a split divides.

With fp32 shapes it first prints the device kernels SDPA runs at the
training shape (one call under the profiler).

`--root` imports the package and `chip_smoke.py` from another checkout
(an older tree unpacked with `git archive`), so two versions of the
kernel are timed by the same script on the same card.

Needs a CUDA card; exits 1 if an output disagrees.  Prints the card's
name and power limit, one line a (shape, plan), and one JSON line
`{"flash_prefill_plans": {...}}`, also written to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F = 1500                    # whisper-large-v3's encoder positions


def cases(dev, only):
    """(name, entry, inputs, causal, candidate plans) for every shape of
    the dtypes `only` names."""
    import torch
    import chip_smoke as cs
    out = []
    bf = torch.bfloat16

    def full(name, B, Sq, Skv, H, K, hd, causal, plans, dt=bf, seed=1):
        ins = cs.full_case(B, Sq, Skv, H, K, hd, dev, seed, dt,
                           encoder=causal)
        out.append((name, "flash", ins, causal, plans))

    def extend(name, p0, H, K, hd, plans, Sc=256, dt=bf):
        ins = cs.extend_case(dev, 17, dt, S=cs.MAX_LEN, p0=p0, Sc=Sc, H=H,
                             K=K, hd=hd)
        out.append((name, "flash", ins, True, plans))

    def paged(name, p0, Sc, H, K, hd, plans, dt=bf):
        ins = cs.paged_prefill_case(H, K, hd, dev, 7, [(p0, Sc)], dt)
        out.append((name, "paged", ins, True, plans))

    if only in ("all", "fp32"):
        f32 = torch.float32
        full("training forward 2x512^2 H=K=36 hd64 fp32, causal", 2, 512,
             512, 36, 36, 64, True, [(128, 1), (64, 1), (64, 2)], f32, 5)
        paged("serve paged chunk Sc=240 at 789 H=K=32 hd128 fp32", 789, 240,
              32, 32, 128, [(64, 1), (64, 2), (64, 4)], f32)
        extend("h2o-danube-3-4b chunk Sq=256 at 512 H=32 K=8 hd120 fp32",
               512, 32, 8, 120, [(64, 1), (64, 2)], dt=f32)
        full("whisper encoder 4x1500^2 H=K=20 hd64 fp32, not causal", 4,
             F, F, 20, 20, 64, False, [(128, 1), (64, 1), (64, 2)], f32)
    if only == "fp32":
        return out

    wide = [(192, 1), (128, 1), (64, 1)]
    full("whisper encoder 4x1500^2 H=K=20 hd64, not causal", 4, F, F, 20,
         20, 64, False, wide)
    for Sq in (1, 16):
        full(f"whisper cross-attention Sq={Sq} over 1500, not causal", 4, Sq,
             F, 20, 20, 64, False, [(64, n) for n in (1, 2, 3, 4, 6)])
    full("cross-attention Sq=77 over 1500, not causal", 4, 77, F, 20, 20,
         64, False, [(128, 1), (64, 1), (64, 2)])
    full("internvl2-1b prefill 3x456 H=14 K=2 (G=7) hd64, causal", 3, 456,
         456, 14, 2, 64, True, wide)
    full("causal prefill 4x1500^2 H=K=20 hd64", 4, F, F, 20, 20, 64, True,
         wide)
    full("causal prefill 1x2048^2 H=K=32 hd128", 1, 2048, 2048, 32, 32, 128,
         True, [(128, 1), (64, 1)])
    for p0 in (5, 789):
        paged(f"serve paged chunk Sc=240 at {p0} H=K=32 hd128", p0, 240, 32,
              32, 128, [(128, 1), (64, 1), (64, 2), (64, 4)])
        paged(f"MoE serve paged chunk Sc=240 at {p0} H=16 K=8 hd64", p0, 240,
              16, 8, 64, [(128, 1), (64, 1), (64, 2), (64, 4)])
    extend("contiguous chunk Sq=256 at 512 H=K=32 hd128", 512, 32, 32, 128,
           [(128, 1), (64, 1), (64, 2)])
    extend("h2o-danube-3-4b chunk Sq=256 at 512 H=32 K=8 hd120", 512, 32, 8,
           120, [(128, 1), (64, 1), (64, 2)])
    for p0 in (0, 768):
        extend(f"granite TP dense chunk Sq=256 at {p0} rank's H=8 K=4 hd64",
               p0, 8, 4, 64, [(128, 1), (64, 1), (64, 2), (64, 5)])
    return out


def sdpa_kernels(cs, dev):
    """The device kernels of SDPA (fp32, is_causal) at minicpm-2b's
    training shape, 2 x 512, H = 36, hd 64: the library call the fp32
    body is held against.  Run as the process's first profiler session:
    on the card a short session after another one recorded no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    q, k, v = (torch.randn(2, 36, 512, 64, device=dev) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa(q, k, v, is_causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sdpa(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    return sorted({e.name()[:120] for e in cs._device_events(prof)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default="")
    ap.add_argument("--only", choices=("all", "bf16", "fp32"), default="all")
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package and chip_smoke.py run")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.build import load_kernels
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain, paged_prefill_attention,
        paged_prefill_attention_plain)
    from repro_torch.kernels.flash_prefill.ops import flash_config
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    ext = load_kernels()
    configs = {}
    for dt in (torch.bfloat16, torch.float32):
        for hd, p in ((64, False), (64, True), (128, False), (128, True),
                      (120, False)):
            try:
                cfg = flash_config(dev, hd, p, dt)
            except TypeError:       # a tree whose planner is bf16 only
                continue
            configs[f"{str(dt)[6:]} hd{hd} "
                    f"{'paged' if p else 'contiguous'}"] = cfg._asdict()
    print(f"[plans] card figures {configs}", flush=True)
    sdpa_names = None
    if args.only in ("all", "fp32"):
        sdpa_names = sdpa_kernels(cs, dev)
        print(f"[plans] SDPA's device kernels at the fp32 training shape: "
              f"{sdpa_names}", flush=True)
    rows_out, bad = [], 0
    n = 4
    for name, entry, ins, causal, plans in cases(dev, args.only):
        q = ins[0]
        tol = cs.REL_TOL[str(q.dtype)[6:]]
        scale = q.shape[-1] ** -0.5
        if entry == "flash":
            _q, k, v, qp, kp, qs, ks = ins
            kk, vv = cs.copies(k, n), cs.copies(v, n)
            ref = flash_prefill_plain(q.float(), k.float(), v.float(), qp,
                                      kp, qs, ks, causal=causal)

            def call(i, rows, ns):
                return ext.flash_prefill(q, kk[i], vv[i], qp, kp, qs, ks,
                                         causal, 0, scale, rows, ns)
            flash_prefill(*ins, causal=causal)
            picked = flash_prefill.last_plan
        else:
            _q, kpool, vpool, kvp, tab, posn = ins
            kk, vv = cs.copies(kpool, n), cs.copies(vpool, n)
            ref = paged_prefill_attention_plain(q.float(), kpool.float(),
                                                vpool.float(), kvp, tab,
                                                posn)

            def call(i, rows, ns):
                return ext.paged_prefill_attention(q, kk[i], vv[i], kvp, tab,
                                                   posn, 0, scale, rows, ns)
            paged_prefill_attention(*ins)
            picked = paged_prefill_attention.last_plan
        timed = []
        for rows, ns in plans:
            try:
                got = call(0, rows, ns)
                torch.cuda.synchronize()
            except RuntimeError as e:      # a plan this body does not take
                print(f"[plans] {name}: rows={rows} splits={ns} refused "
                      f"({str(e).splitlines()[0]})", flush=True)
                timed.append({"rows": rows, "splits": ns, "refused": True})
                continue
            err = cs.rel_err(got, ref)
            ok = err <= tol
            bad += not ok
            ms, wall = cs.time_ms(lambda i: call(i, rows, ns), n,
                                  iters=args.iters)
            timed.append({"rows": rows, "splits": ns, "ms": ms,
                          "wall_ms": wall, "max_rel_err": err})
            print(f"[plans] {name}: rows={rows} splits={ns} ms={ms!r} "
                  f"wall_ms={wall!r} max_rel_err={err:.3e}"
                  f"{'' if ok else ' DISAGREES'}", flush=True)
        timed_ok = [t for t in timed if "ms" in t]
        best = min(timed_ok, key=lambda t: t["ms"])
        pick = next((t for t in timed_ok
                     if (t["rows"], t["splits"]) == tuple(picked)), None)
        print(f"[plans] {name}: planner picks rows={picked[0]} "
              f"splits={picked[1]}"
              f"{' (ms=' + repr(pick['ms']) + ')' if pick else ''}; fastest "
              f"rows={best['rows']} splits={best['splits']} "
              f"ms={best['ms']!r}", flush=True)
        rows_out.append({"shape": name, "planner": list(picked),
                         "plans": timed})
    rec = {"flash_prefill_plans": {"card": card, "card_figures": configs,
                                   "shapes": rows_out, "disagree": bad,
                                   "sdpa_kernels_fp32_training":
                                       sdpa_names}}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
