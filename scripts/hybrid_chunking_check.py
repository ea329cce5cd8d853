#!/usr/bin/env python3
"""How far chip_smoke.py's hybrid logit check moves with the prefill
chunk boundaries a serve happens to choose.

    python3 scripts/hybrid_chunking_check.py          # from the repo root; needs a card
    python3 scripts/hybrid_chunking_check.py --reduced --device cpu   # rehearsal

chip_smoke.py's phase 6h serves full-width jamba-v0.1-52b at 8 of its
32 layers (random weights from seed 0) and holds each request's
first-token logits against a plain forward over the chunk boundaries the
serve used and the expert sets it chose (`replay_routes`,
`forced_routes`, `dense_forward_logits`).  Where the chunks fall depends
on arrival timing (SBS splits a prompt's tail), so the check meets
different boundaries in different runs.  For each of the serve's 8
prompts (`make_requests`, seed 1) this runs the port's eager
`prefill_chunk` over the 256-token chunking and `--splits` random
chunkings (chunks of 1-256 tokens, seed `--seed`), the plain forward
over the same boundaries and expert sets, and prints max|d| / max|ref|
of the last-position logits, each chunking's and the worst, in each
dtype of `--dtypes` (the same weights cast).  With `--out` it writes the
figures as JSON.  It prints measurements only and checks nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def chunkings(n, k, rng):
    """The 256-token chunking of an n-token prompt, then k random ones."""
    out = [[256] * (n // 256) + ([n % 256] if n % 256 else [])]
    for _ in range(k):
        ch, left = [], n
        while left:
            c = min(256, left)
            if rng.random() < 0.5:
                c = rng.randint(1, c)
            ch.append(c)
            left -= c
        out.append(ch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced jamba (a rehearsal, on the CPU)")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--splits", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.config.base import get_arch
    from repro_torch.models.model import init_params
    if args.device != "cpu" and not torch.cuda.is_available():
        print("hybrid_chunking_check: no card", file=sys.stderr)
        return 2
    cfg = get_arch("jamba-v0.1-52b", reduced=args.reduced)
    if not args.reduced:
        cfg = dataclasses.replace(cfg, num_layers=cs.HYBRID_LAYERS)
    lens = (8, 64) if args.reduced else (128, 1024)
    max_len = 128 if args.reduced else cs.MAX_LEN
    reqs = cs.make_requests(cfg, cs.N_REQUESTS, seed=1, lens=lens)
    report = {"arch": cfg.name, "layers": cfg.num_layers, "dtypes": {}}
    for dt_name in args.dtypes.split(","):
        dt = getattr(torch, dt_name)
        t0 = time.monotonic()
        params = init_params(cfg, seed=0, dtype=dt, device=args.device)
        n_moe = sum("moe" in p for p in params["layers"])
        rng = random.Random(args.seed)
        rows = []
        for r in reqs:
            prompt = r.tokens[:r.input_len]
            for ch in chunkings(len(prompt), args.splits, rng):
                routes, eager = cs.replay_routes(cfg, params, prompt, ch,
                                                 max_len, args.device)
                with cs.forced_routes(routes, len(ch), n_moe):
                    ref = cs.dense_forward_logits(cfg, params, prompt,
                                                  args.device, ch)
                rel = float((eager.float() - ref.float()).abs().max()
                            / ref.float().abs().max())
                rows.append({"rid": r.rid, "len": len(prompt), "chunks": ch,
                             "rel": rel, "argmax_agrees":
                             int(eager.argmax()) == int(ref.argmax())})
                print(f"[{dt_name}] request {r.rid} ({len(prompt)} tokens) "
                      f"chunks {ch}: max|d|/max|ref|={rel!r}", flush=True)
        worst = max(rows, key=lambda x: x["rel"])
        canon = [x for i, x in enumerate(rows) if i % (args.splits + 1) == 0]
        print(f"[{dt_name}] worst {worst['rel']!r} (request {worst['rid']}, "
              f"chunks {worst['chunks']}); 256-token chunkings' worst "
              f"{max(x['rel'] for x in canon)!r}; over 5e-2: "
              f"{sum(x['rel'] > 5e-2 for x in rows)} of {len(rows)}; "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        report["dtypes"][dt_name] = rows
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f)
        del params
        if args.device != "cpu":
            cs.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
