#!/usr/bin/env python3
"""How far bf16 rounding moves full-width mamba2-370m's first-token logits.

    python3 scripts/ssm_chunking_sensitivity.py     # from the repo root; needs a card

The SSD scan of a prefill chunk is chunked from the chunk's start, so a
serve's logits depend, through rounding, on where its prefill chunks
start.  For the first prompts of chip_smoke.py's SSM serve (random bf16
weights from seed 0), this prints max|d| / max|ref| of the last-position
logits between:

  * the served path (prefill_chunk over 256-token chunks: kernel #4) and
    the plain forward over the same boundaries (`ssd_chunked`, no kernel);
  * the served path on 100-token chunks and on 256-token chunks;
  * the plain bf16 forward and the same forward with the weights cast to
    fp32 (the bf16 forward's own distance from fp32);
  * the served path in fp32 and the plain fp32 forward;

and the growth of the residual stream through the 48 layers.  It prints
measurements only and checks nothing.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.config.base import get_arch
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.mamba import mamba_forward, ssd_chunked
    from repro_torch.models.model import init_cache, init_params, prefill_chunk
    dev = "cuda"
    cfg = get_arch("mamba2-370m")
    p16 = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)

    def to32(t):
        if isinstance(t, dict):
            return {k: to32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to32(v) for v in t]
        return t.float()
    p32 = to32(p16)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def served(params, toks, dtype, n):
        c = init_cache(cfg, 1, len(toks), dtype=dtype, device=dev)
        for i in range(0, len(toks), n):
            lg, c = prefill_chunk(cfg, params, torch.tensor(
                [toks[i:i + n]], device=dev), c)
        return lg[0]

    print(torch.cuda.get_device_name(0), flush=True)
    for r in C.make_requests(cfg, 5, seed=1):
        toks = list(r.tokens[:r.input_len])
        n256 = [min(256, len(toks) - i) for i in range(0, len(toks), 256)]
        plain16 = C.ssm_forward_logits(cfg, p16, toks, dev, n256)
        plain32 = C.ssm_forward_logits(cfg, p32, toks, dev, n256)
        s16 = served(p16, toks, torch.bfloat16, 256)
        print(f"prompt {len(toks)}: served vs plain (same 256-token chunks) "
              f"bf16 {rel(s16, plain16):.3e}, fp32 "
              f"{rel(served(p32, toks, torch.float32, 256), plain32):.3e}; "
              f"served bf16 100- vs 256-token chunks "
              f"{rel(served(p16, toks, torch.bfloat16, 100), s16):.3e}; "
              f"plain bf16 vs fp32 {rel(plain16, plain32):.3e}", flush=True)
    toks = list(C.make_requests(cfg, 2, seed=1)[1].tokens)
    ids = torch.tensor([toks], device=dev)
    x16, x32 = p16["embed"][ids], p32["embed"][ids]
    for i, (a, b) in enumerate(zip(p16["layers"], p32["layers"])):
        for p, x in ((a, x16), (b, x32)):
            y, _ = mamba_forward(rms_norm(x, p["ln1"]), p["mamba"], cfg.ssm,
                                 scan=ssd_chunked)
            if p is a:
                x16 = x + y
            else:
                x32 = x + y
        if i % 8 == 7:
            print(f"after layer {i + 1}: max|x| {float(x32.abs().max()):.2f} "
                  f"rms {float(x32.pow(2).mean().sqrt()):.3f}, bf16 vs fp32 "
                  f"{rel(x16, x32):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
