"""Quickstart of the PyTorch port: the three layers of the framework in
one script, the twin of `examples/quickstart.py`.

1. SBS scheduler core (Algorithms 1-3) on synthetic state.
2. Reduced models: prefill -> chunked prefill -> decode, all consistent:
   deepseek-v3-671b (MLA, MoE), whisper-large-v3 (the encoder over stub
   frame embeddings, cross-attention in the decoder) and internvl2-1b
   (stub patch embeddings prepended), random fp32 weights from a seed.
3. A 10-second cluster simulation: SBS vs immediate dispatch.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Section 2 runs on the card unless `--device cpu` is given (the first
call on the card builds the CUDA kernels); it imports neither JAX nor
the JAX package.
"""
import argparse
import sys

import torch

from repro_torch.config import ServingConfig
from repro_torch.config.base import get_arch
from repro_torch.core import (
    AdaptiveIntervalController, DecodeDPState, DPState, Request,
    pbaa, schedule_decode_batch,
)
from repro_torch.models.model import (
    decode_step, init_params, prefill, prefill_chunk,
)
from repro_torch.serving.cluster import PrefillClusterSim
from repro_torch.serving.workload import SHORT, generate


def scheduler_core():
    print("== 1. SBS core ==")
    ic = AdaptiveIntervalController(window_size=8, l_net=0.002,
                                    t_default=0.25, n_active=3)
    for t in (0.21, 0.24, 0.19):
        ic.on_end_forward(t)
    print(f"adaptive interval I_opt = {ic.interval*1000:.1f} ms "
          f"(T̄={ic.t_fwd:.3f}s / N=3)")
    dps = [DPState(dp_id=i, instance_id=0, c_chunk=3072) for i in range(4)]
    reqs = [Request(rid=i, arrival_time=0.0, input_len=l)
            for i, l in enumerate([2800, 1900, 1200, 700, 400])]
    assign, pending, _ = pbaa([], reqs, dps)
    print("PBAA water-filling:",
          {d: sum(t for _, t in lst) for d, lst in assign.items()},
          f"carry-over={len(pending)}")
    units = [DecodeDPState(dp_id=i, instance_id=0, batch=b, kv_tokens=k)
             for i, (b, k) in enumerate([(30, 80_000), (32, 60_000),
                                         (31, 70_000), (35, 400_000)])]
    out = schedule_decode_batch(
        [Request(rid=9, arrival_time=0, input_len=5000)], units)
    print(f"IQR-lex decode placed the request on DP {list(out)[0]} "
          "(the 400k-KV straggler was masked)")


def reduced_model(arch: str, device: str):
    """prefill (8 tokens, with the stub frame or patch embeddings the
    model takes) -> one 16-token chunk -> 4 greedy decode steps."""
    cfg = get_arch(arch, reduced=True)
    print(f"\n== 2. {cfg.name}: prefill → chunk → decode on {device} ==")
    params = init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 24), generator=gen)
    n = (cfg.encoder_seq_len if cfg.is_encoder_decoder
         else cfg.num_patch_tokens)
    embeds = (torch.randn(1, n, cfg.d_model, generator=gen) * 0.1
              ).to(device) if n else None
    tokens = tokens.to(device)
    logits, cache = prefill(cfg, params, tokens[:, :8], embeds=embeds,
                            max_len=64)
    logits, cache = prefill_chunk(cfg, params, tokens[:, 8:24], cache)
    nxt = logits.argmax(-1)[:, None]
    for _ in range(4):
        logits, cache = decode_step(cfg, params, nxt, cache)
        nxt = logits.argmax(-1)[:, None]
        print("generated token:", int(nxt[0, 0]))
    print(f"cache cursor {int(cache['cur'][0])}"
          + (f" (a prefix of {n} patch tokens)" if cfg.num_patch_tokens
             else ""))


def cluster_sim():
    print("\n== 3. cluster sim: SBS vs immediate (10s, 50 qps) ==")
    scfg = ServingConfig(num_prefill_instances=3, prefill_dp_per_instance=8,
                         chunk_size=3072, t_default=0.1)
    full_cfg = get_arch("deepseek-v3-671b")
    for sched in ("immediate-rr", "sbs"):
        rs = generate(SHORT, qps=50, duration=10, seed=0)
        rep = PrefillClusterSim(full_cfg, scfg, scheduler=sched).run(rs, 10)
        print(f"{sched:13s} {rep.row()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of section 2 (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    scheduler_core()
    for arch in ("deepseek-v3-671b", "whisper-large-v3", "internvl2-1b"):
        reduced_model(arch, args.device)
    cluster_sim()
    print(f"\njax imported: {'jax' in sys.modules}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
