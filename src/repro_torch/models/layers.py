"""Primitive layers: RMS norm, RoPE, SwiGLU and the init helpers.

Counterpart of `repro/models/layers.py`; the arithmetic (fp32 norm and
rotation, silu in fp32) follows it so the port is token-exact against
the JAX package on the same weights.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1/d_in) weights (or N(0, scale²)), drawn in fp32 on the
    generator's device and cast to `dtype`."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation in fp32.  x: (..., S, n, head_dim);
    positions: (..., S) int.  Position axis is -3, head axis -2."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    angles = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down
