"""Mamba2 (SSD, state-space duality) block: chunked scan and O(1) decode.

Counterpart of `repro/models/mamba.py` (arXiv:2405.21060 §6): the
sequence is cut into chunks of Q tokens; inside a chunk the output is a
masked attention-like quadratic term, across chunks a linear recurrence
carries the (heads, head_dim, d_state) state.  Decode is one state update
per token.

Two scans compute the same function:

  * `ssd_chunked_kernel`, the served path: the intra-chunk term (and each
    chunk's end state) by `repro_torch.kernels.ssd_scan.ssd_chunk`, the
    CUDA kernel on the card and its plain version on the CPU; only the
    small inter-chunk recurrence stays in torch.  `mamba_forward` uses it
    unless told otherwise;
  * `ssd_chunked`, plain torch throughout (the oracle).

Layouts and arithmetic follow the JAX functions (fp32 scan state, silu
and conv in fp32), so the port is token-exact against them on the same
weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.kernels.ssd_scan import ssd_chunk
from repro_torch.models.layers import init_linear, rms_norm


def ssm_dims(d_model: int, sc: SSMConfig):
    d_inner = d_model * sc.expand
    n_heads = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    return d_inner, n_heads, conv_dim


def init_mamba_params(gen: torch.Generator, d_model: int, sc: SSMConfig,
                      dtype) -> Dict:
    """Split projections ([z|x], [B|C], dt) as the JAX init; A_log, D_skip
    and dt_bias stay fp32 whatever `dtype` is."""
    di, nh, _ = ssm_dims(d_model, sc)
    gds2 = 2 * sc.n_groups * sc.d_state
    dev = gen.device

    def conv_w(width):
        w = torch.randn((sc.d_conv, width), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w / math.sqrt(sc.d_conv)).to(dtype)

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_zx": init_linear(gen, d_model, 2 * di, dtype),
        "w_bc": init_linear(gen, d_model, gds2, dtype),
        "w_dt": init_linear(gen, d_model, nh, dtype),
        "conv_wx": conv_w(di),
        "conv_bx": torch.zeros(di, dtype=dtype, device=dev),
        "conv_wbc": conv_w(gds2),
        "conv_bbc": torch.zeros(gds2, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D_skip": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "norm": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": init_linear(gen, di, d_model, dtype),
    }


def _project(x, params, di):
    zx = x @ params["w_zx"]
    return zx[..., :di], zx[..., di:], x @ params["w_bc"], x @ params["w_dt"]


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d over the token axis, then silu.  xBC
    (B, S, C); conv_state (B, d_conv-1, C), the previous tokens' tail
    (None = zeros).  Returns (out (B, S, C), new tail)."""
    dconv = conv_w.shape[0]
    B, S, C = xBC.shape
    if conv_state is None:
        conv_state = xBC.new_zeros((B, dconv - 1, C))
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xBC.device)
    for w in range(dconv):
        out = out + full[:, w:w + S].float() * conv_w[w].float()
    out = F.silu(out + conv_b.float()).to(xBC.dtype)
    return out, full[:, full.shape[1] - (dconv - 1):]


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _pad_tokens(S: int, chunk: int, *ts):
    """Zero-pad axis 1 of each tensor up to a multiple of `chunk`: padded
    tokens carry dt = 0, so they weigh nothing in y or the state."""
    pad = (-S) % chunk
    if not pad:
        return ts
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """SSD chunked scan in plain torch.  x (B, S, nh, hp); dt (B, S, nh)
    fp32 (softplus'd); A (nh,) negative; Bm, Cm (B, S, g, ds).  Returns
    y (B, S, nh, hp) fp32 and the final state (B, nh, hp, ds) fp32."""
    Bsz, S, nh, hp = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // g
    x, dt, Bm, Cm = _pad_tokens(S, chunk, x, dt, Bm, Cm)
    nc = x.shape[1] // chunk
    h = (initial_state if initial_state is not None
         else x.new_zeros((Bsz, nh, hp, ds), dtype=torch.float32))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    neg = torch.tensor(-1e30, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc = x[:, sl].float()
        dtc = dt[:, sl]
        Bc, Cc = Bm[:, sl].float(), Cm[:, sl].float()
        dA_cum = torch.cumsum(dtc * A, dim=1)                 # (B,Q,nh)
        hg = h.reshape(Bsz, g, hpg, hp, ds)
        y_off = torch.einsum("bqgn,bgipn->bqgip", Cc, hg)
        y_off = y_off * torch.exp(dA_cum).reshape(
            Bsz, chunk, g, hpg)[..., None]
        # mask BEFORE exp: a masked rel is positive and can overflow
        rel = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]  # (B,Q,Q,nh)
        L = torch.exp(torch.where(causal[None, :, :, None], rel, neg))
        CB = torch.einsum("bqgn,bkgn->bqkg", Cc, Bc)
        att = (CB[..., None] * L.reshape(Bsz, chunk, chunk, g, hpg)
               * dtc.reshape(Bsz, 1, chunk, g, hpg))
        xg = xc.reshape(Bsz, chunk, g, hpg, hp)
        y_diag = torch.einsum("bqkgi,bkgip->bqgip", att, xg)
        decay_out = torch.exp(dA_cum[:, -1:, :] - dA_cum)       # (B,Q,nh)
        w = (decay_out * dtc).reshape(Bsz, chunk, g, hpg)
        states = torch.einsum("bkgi,bkgn,bkgip->bgipn", w, Bc, xg)
        chunk_decay = torch.exp(dA_cum[:, -1, :]).reshape(Bsz, g, hpg)
        h = (hg * chunk_decay[..., None, None] + states).reshape(
            Bsz, nh, hp, ds)
        ys.append((y_diag + y_off).reshape(Bsz, chunk, nh, hp))
    return torch.cat(ys, dim=1)[:, :S], h


def ssd_chunked_kernel(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """`ssd_chunked` with the intra-chunk term and each chunk's end state
    from `ssd_chunk` (the CUDA kernel for CUDA tensors); the inter-chunk
    recurrence and its carry-in output term stay in torch.  n_groups = 1.
    Bm/Cm may be strided views (slices of the [B|C] projection): the
    kernel reads them in place."""
    Bsz, S, nh, hp = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    if g != 1:
        raise ValueError("the kernel path supports n_groups = 1")
    x, dt, Bm, Cm = _pad_tokens(S, chunk, x, dt, Bm, Cm)
    nc = x.shape[1] // chunk
    xc = x.reshape(Bsz, nc, chunk, nh, hp)
    dtc = dt.reshape(Bsz, nc, chunk, nh)
    Bc = Bm.reshape(Bsz, nc, chunk, ds)
    Cc = Cm.reshape(Bsz, nc, chunk, ds)
    y_diag, states = ssd_chunk(xc, dtc, A, Bc, Cc)
    dA_cum = torch.cumsum(dtc * A, dim=2)                     # (B,nc,Q,nh)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (B,nc,nh)
    h = (initial_state if initial_state is not None
         else x.new_zeros((Bsz, nh, hp, ds), dtype=torch.float32))
    y_off = []
    for c in range(nc):
        yo = torch.einsum("bqn,bhpn->bqhp", Cc[:, c].float(), h)
        y_off.append(yo * torch.exp(dA_cum[:, c])[..., None])
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    y = y_diag.reshape(Bsz, nc * chunk, nh, hp) + torch.cat(y_off, dim=1)
    return y[:, :S], h


def mamba_forward(x, params, sc: SSMConfig, initial_state=None,
                  conv_state=None, scan=ssd_chunked_kernel):
    """Sequence forward.  x (B, S, D); initial_state (B, nh, hp, ds) fp32;
    conv_state (conv_x, conv_bc) tails or None.  Returns (out (B, S, D),
    (ssm_state, (conv_x, conv_bc))) for chunked continuation.  `scan` is
    the SSD scan (`ssd_chunked` for the plain oracle)."""
    d_model = x.shape[-1]
    di, nh, _ = ssm_dims(d_model, sc)
    gds = sc.n_groups * sc.d_state
    z, xr, bc, dt = _project(x, params, di)
    cs_x, cs_bc = conv_state if conv_state is not None else (None, None)
    xr, ncs_x = _causal_conv(xr, params["conv_wx"], params["conv_bx"], cs_x)
    bc, ncs_bc = _causal_conv(bc, params["conv_wbc"], params["conv_bbc"],
                              cs_bc)
    B, S = x.shape[:2]
    xs = xr.reshape(B, S, nh, sc.head_dim)
    Bm = bc[..., :gds].reshape(B, S, sc.n_groups, sc.d_state)
    Cm = bc[..., gds:].reshape(B, S, sc.n_groups, sc.d_state)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = scan(xs, dt, A, Bm, Cm, sc.chunk_size, initial_state)
    y = y + xs.float() * params["D_skip"][:, None]
    y = y.reshape(B, S, di)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, params["norm"])
    return y @ params["out_proj"], (h, (ncs_x, ncs_bc))


def mamba_decode_step(x, params, sc: SSMConfig, ssm_state, conv_state):
    """Single-token decode.  x (B, 1, D); ssm_state (B, nh, hp, ds) fp32;
    conv_state (conv_x, conv_bc).  O(1) in context length.  Returns
    (out (B, 1, D), (new ssm_state, new conv_state)); the inputs are not
    modified."""
    d_model = x.shape[-1]
    di, nh, _ = ssm_dims(d_model, sc)
    gds = sc.n_groups * sc.d_state
    g, ds, hp = sc.n_groups, sc.d_state, sc.head_dim
    hpg = nh // g
    z, xr, bc, dt = _project(x, params, di)
    cs_x, cs_bc = conv_state
    xr, ncs_x = _causal_conv(xr, params["conv_wx"], params["conv_bx"], cs_x)
    bc, ncs_bc = _causal_conv(bc, params["conv_wbc"], params["conv_bbc"],
                              cs_bc)
    xt = xr[:, 0].reshape(-1, nh, hp).float()
    Bt = bc[:, 0, :gds].reshape(-1, g, ds).float()
    Ct = bc[:, 0, gds:].reshape(-1, g, ds).float()
    dt = _softplus(dt[:, 0].float() + params["dt_bias"])        # (B,nh)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)
    xg = xt.reshape(-1, g, hpg, hp)
    upd = torch.einsum("bgi,bgn,bgip->bgipn", dt.reshape(-1, g, hpg), Bt, xg)
    hg = ssm_state.reshape(-1, g, hpg, hp, ds)
    hg = hg * dA.reshape(-1, g, hpg)[..., None, None] + upd
    y = torch.einsum("bgn,bgipn->bgip", Ct, hg).reshape(-1, nh, hp)
    y = y + xt * params["D_skip"][:, None]
    y = y.reshape(-1, 1, di)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, params["norm"])
    return y @ params["out_proj"], (hg.reshape(-1, nh, hp, ds),
                                    (ncs_x, ncs_bc))


def ssd_reference(x, dt, A, Bm, Cm, initial_state=None):
    """Token-by-token recurrence (tests only): h_t = h_{t-1}·exp(dt_t A)
    + dt_t · B_t ⊗ x_t;  y_t = C_t · h_t."""
    Bsz, S, nh, hp = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // g
    h = (initial_state if initial_state is not None
         else x.new_zeros((Bsz, nh, hp, ds), dtype=torch.float32))
    h = h.reshape(Bsz, g, hpg, hp, ds)
    ys = []
    for t in range(S):
        xt = x[:, t].float().reshape(Bsz, g, hpg, hp)
        dtt = dt[:, t].reshape(Bsz, g, hpg)
        dA = torch.exp(dtt * A.reshape(g, hpg))
        upd = torch.einsum("bgi,bgn,bgip->bgipn", dtt, Bm[:, t].float(), xt)
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bgn,bgipn->bgip", Cm[:, t].float(),
                               h).reshape(Bsz, nh, hp))
    return torch.stack(ys, dim=1), h.reshape(Bsz, nh, hp, ds)
