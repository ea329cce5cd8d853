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

and the growth of the residual stream through the 48 layers.

    python3 scripts/ssm_chunking_sensitivity.py --perturb

measures instead how much error in the SSD intra-chunk term chip_smoke's
SSM logit check (5e-2 of the largest logit) can take.  For chip_smoke's
8 prompts, over 256-token prefill chunks, it runs the plain forward with
the intra-chunk term from `ssd_chunk_plain`, then the same forward with
y_diag and the chunk states multiplied by (1 + eps * N(0, 1)) for eps in
1e-7 .. 1e-4, and with the two sums of kernel #4's tensor-core design
(C·Bᵀ and P·x; (w∘x)ᵀ·B) taken in float64 and rounded once to fp32, the
decays untouched.  It prints each variant's worst max|d| / max|ref| of
the first-token logits against the unperturbed forward, and argmax
agreement.  Both modes print measurements only and check nothing.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


EPSILONS = (1e-7, 1e-6, 1e-5, 1e-4)


def exact_sum_chunk(x, dt, A, Bm, Cm):
    """`ssd_chunk_plain` with its decays, L and w as they are, and its
    contractions summed in float64 and rounded once to fp32: the
    arithmetic of kernel #4's tensor-core design (exact bf16 products,
    P and w∘x rounded to fp32 as the plain version rounds them), with
    sums that are exact instead of accumulated in fp32."""
    import torch
    Q = x.shape[2]
    dA_cum = torch.cumsum(dt * A, dim=2)
    rel = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              torch.tensor(-1e30, device=x.device)))
    x64, B64, C64 = x.double(), Bm.double(), Cm.double()
    CB = torch.einsum("bcqn,bckn->bcqk", C64, B64).float()
    att = CB[..., None] * L * dt[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", att.double(), x64).float()
    w = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dt
    wx = (w[..., None] * x.float()).double()
    st = torch.einsum("bckhp,bckn->bchpn", wx, B64).float()
    return y, st


def perturb(C, cfg, p16, dev) -> int:
    """The --perturb mode (see the module docstring)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk_plain
    from repro_torch.models import mamba as M

    def scan_with(intra):
        def scan(x, dt, A, Bm, Cm, chunk, initial_state=None):
            kept = M.ssd_chunk
            M.ssd_chunk = intra
            try:
                return M.ssd_chunked_kernel(x, dt, A, Bm, Cm, chunk,
                                            initial_state)
            finally:
                M.ssd_chunk = kept
        return scan

    def noisy(eps, gen):
        def intra(x, dt, A, Bm, Cm):
            y, st = ssd_chunk_plain(x, dt, A, Bm, Cm)
            return (y * (1 + eps * torch.randn(y.shape, generator=gen,
                                               device=y.device)),
                    st * (1 + eps * torch.randn(st.shape, generator=gen,
                                                device=st.device)))
        return intra

    variants = [(f"eps={e:g}", e) for e in EPSILONS] + [
        ("exact sums (fp64, rounded once)", None)]
    worst = {name: 0.0 for name, _e in variants}
    agree = {name: 0 for name, _e in variants}
    base_vs_smoke = 0.0
    reqs = C.make_requests(cfg, C.N_REQUESTS, seed=1)
    for r in reqs:
        toks = list(r.tokens[:r.input_len])
        n256 = [min(256, len(toks) - i) for i in range(0, len(toks), 256)]
        ref = C.ssm_forward_logits(cfg, p16, toks, dev, n256,
                                   scan=scan_with(ssd_chunk_plain)).float()
        smoke_ref = C.ssm_forward_logits(cfg, p16, toks, dev, n256).float()
        base_vs_smoke = max(base_vs_smoke, float(
            (ref - smoke_ref).abs().max() / smoke_ref.abs().max()))
        for name, eps in variants:
            gen = torch.Generator(device=dev).manual_seed(r.rid)
            intra = exact_sum_chunk if eps is None else noisy(eps, gen)
            got = C.ssm_forward_logits(cfg, p16, toks, dev, n256,
                                       scan=scan_with(intra)).float()
            worst[name] = max(worst[name], float(
                (got - ref).abs().max() / ref.abs().max()))
            agree[name] += int(int(got.argmax()) == int(ref.argmax()))
        print(f"prompt {len(toks)} done", flush=True)
    print(f"unperturbed (ssd_chunk_plain) vs chip_smoke's reference "
          f"(ssd_chunked): {base_vs_smoke:.3e}", flush=True)
    print(f"{'variant':34s} worst max|d|/max|ref|  argmax agrees "
          f"(of {len(reqs)}); the check's limit is {C.LOGITS_REL_TOL}",
          flush=True)
    for name, _e in variants:
        print(f"{name:34s} {worst[name]:.3e}            {agree[name]}",
              flush=True)
    return 0


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
    if "--perturb" in sys.argv[1:]:
        return perturb(C, cfg, p16, dev)
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
