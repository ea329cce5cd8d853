"""Abstract inputs and step functions for the shape dry-run.

Counterpart of `repro/launch/specs.py`.  The reference lowers each step
on `jax.ShapeDtypeStruct` stand-ins; here the stand-ins are tensors on
the `meta` device (shape and dtype, no storage), and the step runs on
them: every op computes only its output's shape, and every kernel
wrapper takes its plain version there (`kernels.build.PLAIN_DEVICES`),
so no data-dependent shape may appear on the path (the MoE capacity is
static, as the reference's).  Nothing is allocated at any size.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import InputShape, ModelConfig, TrainConfig
from repro_torch.models.model import (
    abstract_cache, decode_step, forward_train, prefill,
)
from repro_torch.train.optimizer import (
    adamw_init, adamw_update, tree_leaves, tree_unflatten,
)
from repro_torch.train.schedule import make_schedule

META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    """A stand-in input of `shape` and `dtype` (the reference's `sds`)."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is this (arch × shape) combination runnable? (DESIGN.md §4 skips)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""


def _embeds(cfg: ModelConfig, B: int, dtype) -> Optional[torch.Tensor]:
    if cfg.is_encoder_decoder:
        return meta((B, cfg.encoder_seq_len, cfg.d_model), dtype)
    if cfg.num_patch_tokens:
        return meta((B, cfg.num_patch_tokens, cfg.d_model), dtype)
    return None


def batch_inputs(cfg: ModelConfig, shape: InputShape,
                 dtype=torch.bfloat16) -> Dict:
    """Stand-in inputs of the step this shape runs: {"batch": tokens,
    targets [, embeds]} (train), {tokens [, embeds]} (prefill), {token,
    cache} (decode: one new token against a seq_len-deep cache)."""
    B, S = shape.global_batch, shape.seq_len
    emb = _embeds(cfg, B, dtype)
    if shape.kind == "train":
        batch = {"tokens": meta((B, S), torch.int32),
                 "targets": meta((B, S), torch.int32)}
        if emb is not None:
            batch["embeds"] = emb
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": meta((B, S), torch.int32)}
        if emb is not None:
            out["embeds"] = emb
        return out
    return {"token": meta((B, 1), torch.int32),
            "cache": abstract_cache(cfg, B, S, dtype)}


def make_step_fn(cfg: ModelConfig, shape: InputShape,
                 tcfg: Optional[TrainConfig] = None, remat="block"):
    """Returns (fn, donate).  Signatures:
    train:   fn(params, opt_state, batch) -> (params, opt_state, loss)
    prefill: fn(params, tokens[, embeds]) -> (logits, cache)
    decode:  fn(params, token, cache) -> (logits, cache)

    `donate` is always (): donating an argument's buffers to the output
    is an XLA notion with no torch counterpart (the port's steps already
    write K/V in place and rebind the optimizer's moments).  `remat`
    ("none", "block" or "dots", `models.model._ckpt`) recomputes each
    block in the backward, as the reference's."""
    if shape.kind == "train":
        tcfg = tcfg or TrainConfig(global_batch=shape.global_batch,
                                   seq_len=shape.seq_len)
        schedule = make_schedule(tcfg.schedule, tcfg.lr, tcfg.warmup_steps,
                                 tcfg.total_steps, tcfg.stable_frac)

        def train_step(params, opt_state, batch):
            leaves = tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            loss, _m = forward_train(cfg, params, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = tree_unflatten(params, [
                torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, grads)])
            for t in leaves:
                t.requires_grad_(False)
            lr = schedule(opt_state["step"])
            params, opt_state, _ = adamw_update(
                params, grads, opt_state, lr, beta1=tcfg.beta1,
                beta2=tcfg.beta2, eps=tcfg.eps,
                weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
            return params, opt_state, loss.detach()
        return train_step, ()

    if shape.kind == "prefill":
        if cfg.is_encoder_decoder or cfg.num_patch_tokens:
            def prefill_step(params, tokens, embeds):
                with torch.no_grad():
                    return prefill(cfg, params, tokens, embeds=embeds,
                                   max_len=shape.seq_len)
        else:
            def prefill_step(params, tokens):
                with torch.no_grad():
                    return prefill(cfg, params, tokens,
                                   max_len=shape.seq_len)
        return prefill_step, ()

    def serve_step(params, token, cache):
        with torch.no_grad():
            return decode_step(cfg, params, token, cache)
    return serve_step, ()


def abstract_opt_state(params):
    """The optimizer state of `params` (meta tensors in, meta out)."""
    return adamw_init(params)
