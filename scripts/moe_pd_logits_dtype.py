#!/usr/bin/env python3
"""How far bf16 rounding moves an MoE model's first-token logits on the
dense P/D prefill path, and how far fp32 does.

    python3 scripts/moe_pd_logits_dtype.py     # from the repo root; needs a card

For the 10 prompts of the serving benchmark twin's paged-vs-padded sweep
(`examples/serve_e2e_torch.py` at `scripts/ci.sh --real-smoke`'s flags:
20-89 tokens, seed 0), at published width with random weights from seed
0, this prints for granite-moe-1b-a400m (MoE, 32 experts top-8, capacity
factor 1.25) and deepseek-7b (dense), in bf16 and in fp32, at prefill
chunks of 32 (the twin's) and 256 tokens:

  * the worst max|d| / max|ref| of the last-position logits between the
    served path (`prefill_chunk` per chunk into a batch-1 dense cache:
    kernel #2's contiguous entry, the MoE dispatch with capacity from
    the chunk's tokens) and `chip_smoke.dense_forward_logits` (plain
    attention, the MoE FFN once per chunk);
  * the (token, layer) pairs whose expert sets differ between the two
    (routing flips);
  * in bf16, the served path against the plain forward run in fp32 on
    the same (bf16-valued) weights, and the plain forward in bf16
    against the same in fp32 (how far the plain reference itself moves
    in bf16);
  * in bf16, the served path against the plain forward that replays the
    served path's expert sets (`chip_smoke.forced_routes`, what
    chip_smoke.py's twin phase holds to its logits tolerance).

It prints measurements only and checks nothing.
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
        print("moe_pd_logits_dtype: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.config import get_arch
    from repro_torch.kernels.build import load_kernels
    from repro_torch.models import moe
    from repro_torch.models.model import init_cache, init_params, prefill_chunk
    dev = "cuda"
    load_kernels()
    twin = cs.load_twin()

    def served(cfg, params, toks, chunk):
        cache = init_cache(cfg, 1, twin.MAX_LEN, dtype=params["embed"].dtype,
                           device=dev)
        for at in range(0, len(toks), chunk):
            ids = torch.tensor([toks[at:at + chunk]], dtype=torch.int32,
                               device=dev)
            lg, cache = prefill_chunk(cfg, params, ids, cache)
        return lg[0]

    def err(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def to_fp32(tree):
        return torch.utils._pytree.tree_map(
            lambda t: t.float() if torch.is_tensor(t)
            and t.is_floating_point() else t, tree)

    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for arch in ("granite-moe-1b-a400m", "deepseek-7b"):
        cfg = get_arch(arch)
        reqs = twin.make_requests(10, cfg, 12, 0, 0.0)()
        for dt in (torch.bfloat16, torch.float32):
            params = init_params(cfg, seed=0, dtype=dt, device=dev)
            for chunk in (32, 256):
                worst = vs32 = plain32 = replayed = 0.0
                flips = pairs = 0
                for r in reqs:
                    toks = list(r.tokens)
                    ch = [min(chunk, len(toks) - i)
                          for i in range(0, len(toks), chunk)]
                    calls = []
                    inner = moe.route

                    def route(x, p, mc):
                        out = inner(x, p, mc)
                        calls.append(out[1])
                        return out
                    moe.route = route
                    try:
                        s = served(cfg, params, toks, chunk)
                        sc = calls[:]
                        calls.clear()
                        ref = cs.dense_forward_logits(cfg, params, toks, dev,
                                                      ch)
                        pc = calls[:]
                    finally:
                        moe.route = inner
                    worst = max(worst, err(s, ref))
                    n_moe = len(sc) // len(ch)
                    for c in range(len(ch)):     # served chunk-major,
                        for layer in range(n_moe):   # plain layer-major
                            a = sc[c * n_moe + layer].sort(dim=-1).values
                            b = pc[layer * len(ch) + c].sort(dim=-1).values
                            flips += int((a != b).any(dim=-1).sum())
                            pairs += a.shape[0]
                    if dt == torch.bfloat16:
                        ref32 = cs.dense_forward_logits(
                            cfg, to_fp32(params), toks, dev, ch)
                        vs32 = max(vs32, err(s, ref32))
                        plain32 = max(plain32, err(ref, ref32))
                        with cs.forced_routes(sc, len(ch), n_moe):
                            replayed = max(replayed, err(
                                s, cs.dense_forward_logits(cfg, params, toks,
                                                           dev, ch)))
                extra = (f"; served bf16 vs the plain forward in fp32 on the "
                         f"same weights: {vs32:.4e}; plain bf16 vs plain "
                         f"fp32: {plain32:.4e}; served vs plain with the "
                         f"served expert sets: {replayed:.4e}"
                         if dt == torch.bfloat16 else "")
                print(f"[moe logits] {arch} {str(dt)[6:]} chunk={chunk}: "
                      f"served vs plain worst max|d|/max|ref|={worst:.4e}, "
                      f"routing flips {flips} of {pairs} (token, layer) "
                      f"pairs{extra}", flush=True)
            del params
            cs.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
