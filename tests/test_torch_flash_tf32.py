"""Kernel #2's fp32 body on the CPU: the arithmetic of 3xTF32 and the plan.

The fp32 body runs both products, S = Q·Kᵀ and O += P·V, on the tensor
cores in TF32 (a 10-bit mantissa).  One TF32 product cannot hold the
fp32 path's 1e-4 agreement; three can: every operand is split as
x = big + small, big the nearest TF32 value (`cvt.rna.tf32.f32`, ties
away from zero) and small the fp32 remainder, which the tensor cores
read truncated to TF32, and big·big + big·small + small·big is summed
(small·small dropped).  `_attention` repeats that arithmetic in torch
ops, seeded with numpy, and is held against a float64 attention at
phase 6j's head dim and sequence length (minicpm-2b's training forward:
hd 64, 512 tokens): 3xTF32 within 1e-5 of the largest element of each
head vector, one TF32 product outside 1e-4.  The kernel itself runs
only on the card (`tests/test_torch_cuda.py`).

Also the fp32 body's plan: `flash_plan` passes `flash_splits` with the
fp32 body's own card figures (hand-made `FlashConfig`s here, as the
binding reads them on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ops import FlashConfig, flash_splits

_HD, _SEQ, _HEADS = 64, 512, 3     # phase 6j's head dim and sequence


def _rna_tf32(x):
    """Nearest TF32 value of fp32 x, ties away from zero (what
    `cvt.rna.tf32.f32` gives): add half of the 13 dropped bits to the
    magnitude, then drop them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x):
    """fp32 x as the tensor cores read a TF32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul_tf32(a, b, three: bool):
    """a @ b with fp32 sums of products of TF32 operands: three products
    (big·big + big·small + small·big) or one (big·big)."""
    ab, bb = _rna_tf32(a), _rna_tf32(b)
    out = ab @ bb
    if three:
        sa, sb = _trunc_tf32(a - ab), _trunc_tf32(b - bb)
        out = sa @ bb + ab @ sb + out
    return out


def _attention(q, k, v, causal: bool, three: bool):
    """One head's attention as the fp32 body computes it: S in TF32
    products, the softmax in fp32 with unnormalised P = exp(S - max),
    O = (P·V) / sum(P), P·V in TF32 products too.  q (S, hd), k/v (S,
    hd) fp32."""
    s = _matmul_tf32(q, k.T, three) * q.shape[-1] ** -0.5
    if causal:
        n = s.shape[0]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _matmul_tf32(p, v, three) / p.sum(-1, keepdim=True)


def _reference(q, k, v, causal: bool):
    s = (q @ k.T) * q.shape[-1] ** -0.5
    if causal:
        n = s.shape[0]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.softmax(s, -1) @ v


def _worst_rel(out, ref):
    """The largest max|out - ref| / max|ref| over the head vectors."""
    d = (out.double() - ref).abs().amax(-1)
    return float((d / ref.abs().amax(-1)).max())


def _errors(causal: bool, seed: int):
    """(3xTF32 error, 1xTF32 error) over `_HEADS` heads of phase 6j's
    shape, inputs drawn with numpy."""
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(_HEADS):
        q, k, v = (torch.from_numpy(rng.standard_normal((_SEQ, _HD))
                                    .astype(np.float32)) for _ in range(3))
        ref = _reference(q.double(), k.double(), v.double(), causal)
        errs.append((_worst_rel(_attention(q, k, v, causal, True), ref),
                     _worst_rel(_attention(q, k, v, causal, False), ref)))
    return max(e[0] for e in errs), max(e[1] for e in errs)


@pytest.mark.parametrize("causal", [True, False])
def test_three_tf32_products_hold_fp32_and_one_does_not(causal):
    """The reason for the body's three products: 3xTF32 is within 1e-5
    of a float64 attention per head vector (the kernel's fp32 tolerance
    is 1e-4), one TF32 product is outside 1e-4."""
    three, one = _errors(causal, seed=31)
    assert three <= 1e-5, three
    assert one > 1e-4, one


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """big + small == x exactly in fp32; big has 10 mantissa bits and is
    the nearest TF32 value, ties away from zero; small's magnitude is at
    most half a TF32 ulp of x."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) *
                         np.float32(3.0))
    big = _rna_tf32(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert bool((small.abs() <= ulp / 2).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _rna_tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def _fp32_config(hd, sm_count=132):
    """An fp32 body's figures as the binding reads them: 64 and 128-row
    CTAs at head dim 64 and 64 rows otherwise, one CTA an SM (its stages
    fill the shared memory)."""
    rows = {128: 1, 64: 1} if hd == 64 else {64: 1}
    return FlashConfig(64, rows, sm_count)


@pytest.mark.parametrize("shape,hd,causal,want", [
    # phase 6j's training forward: 64-row CTAs (5 waves of 64 rows beat 3
    # waves of 128), never split (causal)
    ((2, 512, 36, 36, 512), 64, True, (64, 1)),
    # whisper's encoder in fp32: a full grid, no split
    ((4, 1500, 20, 20, 1500), 64, False, (64, 1)),
    # a few queries over many keys, not causal: 80 CTAs, one an SM ->
    # one split per CTA slot is all the SMs hold
    ((4, 1, 20, 20, 1500), 64, False, (64, 1)),
    # 8 CTAs over 1500 keys: split to fill the SMs, 4 tiles a split
    ((1, 16, 8, 8, 1500), 64, False, (64, 6)),
    # head dims 120 and 128 have 64-row CTAs only
    ((1, 240, 32, 32, 1088), 128, True, (64, 1)),
    ((1, 16, 8, 8, 1500), 120, False, (64, 6)),
])
def test_flash_splits_plans_the_fp32_body(shape, hd, causal, want):
    B, Sq, H, K, n_keys = shape
    assert flash_splits(B, Sq, H, K, n_keys, causal,
                        _fp32_config(hd)) == want


def test_flash_plan_passes_the_fp32_figures():
    """An fp32 q is planned by `flash_splits` with the figures passed (on
    the card, the fp32 body's own), not a fixed plan: a not-causal call
    of few CTAs splits, and the same shape in bf16 plans alike with the
    same figures."""
    cfg = _fp32_config(64)
    q = torch.zeros(1, 16, 8, 64)
    assert fp_ops.flash_plan(q, 1500, 8, False, False, cfg) == (64, 6)
    assert fp_ops.flash_plan(q, 1500, 8, True, False, cfg) == (64, 1)
    assert fp_ops.flash_plan(q.to(torch.bfloat16), 1500, 8, False, False,
                             cfg) == (64, 6)
    two = FlashConfig(64, {128: 1, 64: 2}, 132)
    assert fp_ops.flash_plan(torch.zeros(4, 1, 20, 64), 1500, 20, False,
                             False, two) == (64, 3)
