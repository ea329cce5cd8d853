"""Training loop: an eager AdamW step over any registered architecture,
with WSD/cosine schedules, packing-aware batches and checkpoints.

Counterpart of `repro/train/trainer.py`.  The reference jits
`jax.value_and_grad` of `forward_train`; here the step is eager
autograd (no `torch.compile`, no CUDA graphs): the forward runs kernel
#2's contiguous entry in every GQA/SWA layer and kernel #4 in every SSM
layer on the card, each through its autograd `Function`.  Parameters
and optimizer state are nested dicts of tensors on `device` ("cuda"
unless the caller asks for the CPU); the update is in place, so one
copy of them lives on the device.  Checkpoints are the reference's
`.npz` (`repro_torch.checkpoint`), with the layers stacked as the
reference stacks them (`repro_torch.bridge`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.models.model import forward_train, init_params
from repro_torch.train.optimizer import (
    adamw_init, adamw_update, tree_leaves, tree_unflatten,
)
from repro_torch.train.schedule import make_schedule


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    remat=False) -> Callable:
    """step_fn(params, opt_state, batch) -> (params, opt_state, metrics):
    loss and gradients of `forward_train` by autograd, the schedule's lr
    at the optimizer's step, then `adamw_update` in place.  A parameter
    the loss does not reach (the sigmoid router's selection bias) gets a
    zero gradient, as `jax.grad` gives it.  metrics: forward_train's,
    grad_norm and lr, as tensors."""
    schedule = make_schedule(tcfg.schedule, tcfg.lr, tcfg.warmup_steps,
                             tcfg.total_steps, tcfg.stable_frac)

    def step_fn(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = forward_train(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del loss
        grad_tree = tree_unflatten(params, grads)
        lr = schedule(opt_state["step"])
        params, opt_state, om = adamw_update(
            params, grad_tree, opt_state, lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip, inplace=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return step_fn


class Trainer:
    """`fit` over a batch iterator, `save`/`restore` of the reference's
    checkpoints.  `params` starts from given weights (the tests bridge
    the JAX init's); otherwise `init_params` from `tcfg.seed`.
    `last_metrics` holds the metrics of the last step (tensors)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 ckpt_dir: Optional[str] = None, remat=False,
                 dtype=torch.float32, device="cuda",
                 params: Optional[Dict] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.ckpt_dir = ckpt_dir
        self.dtype = dtype
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(
            cfg, tcfg.seed, dtype, self.device)
        self.opt_state = adamw_init(self.params)
        self.step = 0
        self.last_metrics: Dict = {}
        self._fn = make_train_step(cfg, tcfg, remat)
        if ckpt_dir and latest_step(ckpt_dir) is not None:
            self.restore()

    def _tree(self) -> Dict:
        """params and optimizer state in the reference's layout (numpy)."""
        cfg = self.cfg
        return {"params": params_to_numpy(cfg, self.params),
                "opt": {"mu": params_to_numpy(cfg, self.opt_state["mu"]),
                        "nu": params_to_numpy(cfg, self.opt_state["nu"]),
                        "step": np.asarray(int(self.opt_state["step"]),
                                           np.int32)}}

    def restore(self) -> None:
        tree, step, _ = load_checkpoint(self.ckpt_dir, self._tree())
        cfg, dev = self.cfg, self.device
        self.params = params_from_numpy(cfg, tree["params"], self.dtype, dev)
        self.opt_state = {
            "mu": params_from_numpy(cfg, tree["opt"]["mu"], torch.float32,
                                    dev),
            "nu": params_from_numpy(cfg, tree["opt"]["nu"], torch.float32,
                                    dev),
            "step": torch.tensor(int(tree["opt"]["step"]), dtype=torch.int32,
                                 device=dev)}
        self.step = step

    def save(self) -> None:
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.step, self._tree())

    def fit(self, batches: Iterator[Dict], steps: int,
            log_every: int = 10, save_every: int = 0,
            log_fn: Callable[[str], None] = print) -> Dict:
        history = []
        t0 = time.monotonic()
        for _ in range(steps):
            batch = next(batches)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            self.params, self.opt_state, m = self._fn(
                self.params, self.opt_state, batch)
            self.last_metrics = m
            self.step += 1
            if log_every and self.step % log_every == 0:
                ce = float(m["ce"])
                history.append((self.step, ce))
                dt = time.monotonic() - t0
                log_fn(f"step {self.step:5d} ce={ce:.4f} "
                       f"loss={float(m['loss']):.4f} "
                       f"lr={float(m['lr']):.2e} "
                       f"gnorm={float(m['grad_norm']):.2f} "
                       f"({dt:.1f}s)")
            if save_every and self.step % save_every == 0:
                self.save()
        return {"history": history, "final_ce": history[-1][1] if history
                else None}
