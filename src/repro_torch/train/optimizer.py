"""AdamW with global-norm clipping, functional over nested dicts of
tensors.

Counterpart of `repro/train/optimizer.py`, with its formula: the
moments are fp32 whatever the parameters' dtype, clipping happens
inside the update (which returns the global norm), weight decay is
added to the Adam direction before the step (`p - lr · (m̂ / (√v̂ + ε)
+ wd · p)`).  `torch.optim.AdamW` keeps its moments in the parameters'
dtype, so it is not a substitute.

A tree is a dict (or list) nested to tensors; every function maps over
its leaves in a fixed order.  `adamw_update(..., inplace=True)` writes
the new parameters and moments into the tensors it was given (the
trainer's form: at full width a second copy of the parameters and
moments would not fit beside the first), and returns the same trees.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list, in order (dict keys sorted, as
    JAX orders a pytree's)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """The values of `leaves` (in `tree_leaves` order) nested as `tree`."""
    it = iter(leaves)

    def like(node):
        if isinstance(node, dict):
            return {k: like(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(like(v) for v in node)
        return next(it)
    return like(tree)


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the same leaves of `rest`),
    keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 moments of every parameter, and the step count (an int32
    scalar on the first parameter's device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """√(Σ g²) over every leaf, in fp32, summed leaf by leaf in order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most `max_norm`,
    the global norm before scaling)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr, beta1: float = 0.9,
                 beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 inplace: bool = False):
    """One AdamW step: clip the gradients to `grad_clip` by their global
    norm, update the fp32 moments, bias-correct them, and step every
    parameter (in fp32, stored back in its dtype).  `lr` is a float or a
    scalar tensor.  Returns (new params, new opt state, {"grad_norm"}).
    With `inplace` the given tensors are overwritten leaf by leaf and
    returned, and the clipped gradients are never materialised as a
    tree."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, grad_clip)
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t

    def upd(p, g, mu, nu):
        g32 = (g.float() * scale).to(g.dtype).float()
        mu_n = beta1 * mu + (1 - beta1) * g32
        nu_n = beta2 * nu + (1 - beta2) * torch.square(g32)
        delta = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps) \
            + weight_decay * p.float()
        p_n = (p.float() - lr * delta).to(p.dtype)
        if not inplace:
            return p_n, mu_n, nu_n
        p.copy_(p_n)
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        return p, mu, nu

    out = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    new_p, new_mu, new_nu = _unzip3(params, out)
    if inplace:
        opt_state["step"].copy_(step)
        step = opt_state["step"]
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, \
        {"grad_norm": gnorm}


def _unzip3(like, tree):
    """A tree of 3-tuples (shaped as `like`) as three trees."""
    if isinstance(like, dict):
        parts = {k: _unzip3(v, tree[k]) for k, v in like.items()}
        return tuple({k: parts[k][i] for k in like} for i in range(3))
    if isinstance(like, (list, tuple)):
        parts = [_unzip3(v, tree[i]) for i, v in enumerate(like)]
        return tuple(type(like)(p[i] for p in parts) for i in range(3))
    return tree
