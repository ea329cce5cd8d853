"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --steps 200 --batch 8 --seq 128 --schedule wsd \
        --ckpt <dir> [--device cpu]

Counterpart of `repro/launch/train.py`, with `--device` (default
`cuda`: the forward runs the port's kernels on the card; `cpu` runs
their plain versions).  Full (non-reduced) configs need the card's
memory: AdamW keeps two fp32 moments beside the fp32 parameters and
their gradients (minicpm-2b: 43.5 GB).
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.config.base import TrainConfig, get_arch
from repro_torch.data import synthetic_batches
from repro_torch.train import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "constant"])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--branching", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu on request)")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")

    cfg = get_arch(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                       schedule=args.schedule, warmup_steps=args.warmup,
                       total_steps=args.steps)
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt, device=args.device)
    batches = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                                branching=args.branching)
    res = trainer.fit(batches, args.steps, log_every=args.log_every,
                      save_every=args.save_every)
    if args.ckpt:
        trainer.save()
    print(f"final ce={res['final_ce']:.4f} "
          f"(optimal = ln({args.branching}) = "
          f"{math.log(args.branching):.4f})")


if __name__ == "__main__":
    main()
