"""Train a (reduced) MiniCPM with the WSD schedule on structured synthetic
data for a few hundred steps: the training-side end-to-end example of
the PyTorch port, the twin of `examples/train_wsd.py`.

    PYTHONPATH=src python examples/train_wsd_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_wsd_torch.py --device cpu

It trains on the card unless `--device cpu` is given (the first call on
the card builds the CUDA kernels); it imports neither JAX nor the JAX
package.
"""
import argparse
import math
import sys

import torch

from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import synthetic_batches
from repro_torch.train import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--branching", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu on request)")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to train on the CPU",
              file=sys.stderr)
        return 2

    cfg = get_arch(args.arch, reduced=True)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=3e-3,
                       schedule="wsd", warmup_steps=args.steps // 10,
                       total_steps=args.steps)
    print(f"training {cfg.name}: {args.steps} steps of "
          f"{args.batch}×{args.seq} tokens, WSD schedule, on {args.device}")
    tr = Trainer(cfg, tcfg, ckpt_dir=args.ckpt, device=args.device)
    batches = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                                branching=args.branching)
    res = tr.fit(batches, args.steps, log_every=max(args.steps // 15, 1))
    if args.ckpt:
        tr.save()
    print(f"final CE {res['final_ce']:.4f}; optimal "
          f"ln({args.branching}) = {math.log(args.branching):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
