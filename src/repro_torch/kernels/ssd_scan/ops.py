"""Mamba2 SSD intra-chunk term: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces `repro/kernels/ssd_scan/kernel.py` `ssd_chunk_pallas` (body
`_ssd_kernel`) by `ssd_chunk` (`repro_torch/csrc/ssd_chunk.cu`).  Per
(batch·chunk, head), with Ā = cumsum(dt·A) inside the chunk:

    y_diag[q, p]  = Σ_{k≤q} (C_q·B_k) · exp(Ā_q − Ā_k) · dt_k · x[k, p]
    state[p, n]   = Σ_k exp(Ā_last − Ā_k) · dt_k · B_k[n] · x[k, p]

with one B/C group (`n_groups = 1`, shared by every head) and fp32
outputs.  The chunk-end state comes back in the SSM cache's
(nh, hp, ds) order; the JAX kernel returns it as (nh, ds, hp).

The kernel sums every element in the plain version's order, so on the
card the two agree bit for bit (see the source note for why that is
required).  The wrapper launches it for CUDA tensors (one call launches
two kernels: C·Bᵀ and Ā, then y and the state) and takes the plain
version only for CPU (and `meta`) tensors; `ssd_chunk.launches` counts
the calls that launched.  `ssd_chunk_train` is `ssd_chunk` under autograd (the
training forward): the kernel forward, the plain version's gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import PLAIN_DEVICES, load_kernels

HEAD_DIMS = (32, 64)             # hp the kernel is instantiated for
STATE_DIMS = (16, 32, 64, 128)   # ds the kernel is instantiated for
MAX_CHUNK = 256                  # the longest chunk (Q) it takes
DTYPES = (torch.float32, torch.bfloat16)


def ssd_chunk_plain(x, dt, A, Bm, Cm):
    """x (B, nc, Q, nh, hp); dt (B, nc, Q, nh) fp32 (softplus'd); A (nh,)
    fp32 negative; Bm, Cm (B, nc, Q, ds)  ->  (y_diag (B, nc, Q, nh, hp),
    states (B, nc, nh, hp, ds)), both fp32.  The reference's arithmetic
    (`ssd_chunk_ref`): a masked (Q, Q) decay matrix, masked before exp."""
    Q = x.shape[2]
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    dA_cum = torch.cumsum(dt * A, dim=2)                     # (B,nc,Q,nh)
    rel = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              torch.tensor(-1e30, device=x.device)))
    CB = torch.einsum("bcqn,bckn->bcqk", C32, B32)
    att = CB[..., None] * L * dt[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", att, x32)
    w = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dt         # (B,nc,Q,nh)
    st = torch.einsum("bckh,bckn,bckhp->bchpn", w, B32, x32)
    return y, st


def _row_stride(t, name: str) -> int:
    """Stride between consecutive tokens of a (B, nc, Q, ds) tensor whose
    ds values are contiguous and whose tokens lie at one stride (a slice
    of the [B|C] projection is such a view)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the state axis must be contiguous")
    try:
        return t.view(-1, t.shape[-1]).stride(0)
    except RuntimeError:
        raise ValueError(f"{name}: tokens must lie at one stride") from None


def check_args(x, dt, A, Bm, Cm) -> None:
    """Raise ValueError for any input the kernel does not take."""
    if x.dim() != 5:
        raise ValueError("x must be (B, nc, Q, nh, hp)")
    Bsz, nc, Q, nh, hp = x.shape
    ds = Bm.shape[-1] if Bm.dim() == 4 else -1
    if tuple(dt.shape) != (Bsz, nc, Q, nh):
        raise ValueError(f"dt must be {(Bsz, nc, Q, nh)}")
    if tuple(A.shape) != (nh,):
        raise ValueError(f"A must be ({nh},)")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (Bsz, nc, Q, ds):
            raise ValueError(f"{name} must be (B, nc, Q, ds) = "
                             f"{(Bsz, nc, Q, ds)}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share one dtype of {DTYPES}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("dt and A must be float32")
    if hp not in HEAD_DIMS:
        raise ValueError(f"head dim {hp} not in {HEAD_DIMS}")
    if ds not in STATE_DIMS:
        raise ValueError(f"state dim {ds} not in {STATE_DIMS}")
    if not 0 < Q <= MAX_CHUNK:
        raise ValueError(f"chunk {Q} not in 1..{MAX_CHUNK}")
    for name, t in (("x", x), ("dt", dt), ("A", A)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if _row_stride(t, name) * t.element_size() % 16:
            raise ValueError(f"{name}: tokens must lie a multiple of 16 "
                             f"bytes apart")


def ssd_chunk(x, dt, A, Bm, Cm):
    """The SSD intra-chunk term (shapes as the plain version).  Bm and Cm
    may be strided views whose tokens lie at one stride.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type in PLAIN_DEVICES:
        return ssd_chunk_plain(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_args(x, dt, A, Bm, Cm)
    y, st = load_kernels().ssd_chunk(
        x, dt, A, Bm, Cm, _row_stride(Bm, "Bm"), _row_stride(Cm, "Cm"))
    ssd_chunk.launches += 1
    return y, st


class _SSDChunkFn(torch.autograd.Function):
    """`ssd_chunk` whose backward recomputes `ssd_chunk_plain` under
    autograd on detached inputs and returns its gradient: on the card
    the kernel equals its plain version bit for bit, so the two forwards
    are one function."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, st = ssd_chunk(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return y, st

    @staticmethod
    def backward(ctx, dy, dst):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, st = ssd_chunk_plain(*ins)
            return torch.autograd.grad((y, st), ins, (dy, dst),
                                       allow_unused=True)


def ssd_chunk_train(x, dt, A, Bm, Cm):
    """`ssd_chunk` under autograd: the kernel forward for CUDA tensors
    (counted in `ssd_chunk.launches`), the plain version for CPU
    tensors, and the plain version's gradient."""
    return _SSDChunkFn.apply(x, dt, A, Bm, Cm)


ssd_chunk.launches = 0
