"""PyTorch port on the card: the CUDA kernels against their plain
versions at small shapes, and the unified server on CUDA against the same
server on the CPU.  Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one; on the card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where JAX is not installed.
Tolerances, against the plain version computed in fp32 on the same
inputs: max|d| of 1e-4 (fp32 kernels: online softmax vs the plain
version's materialised softmax) or 2e-2 (bf16 kernels), and per head
vector max|d| / max|ref| of 1e-4 (fp32) or 1e-2 (bf16: the output's own
rounding is under 4e-3 of a vector's largest element).
"""
import random

import pytest
import torch

from repro_torch.config.base import ServingConfig, get_arch
from repro_torch.core.types import Request
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill, flash_prefill_plain, paged_prefill_attention,
    paged_prefill_attention_plain,
)
from repro_torch.models.model import init_params
from repro_torch.serving.server import RealSBSServer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_close(out, ref, dtype):
    """Absolute limit, and max|d| / max|ref| over each head vector; a
    vector whose reference is all zero must come out exactly zero."""
    d = (out.float() - ref).abs()
    assert float(d.max()) <= TOL[dtype]
    worst = d.amax(-1)
    scale = ref.abs().amax(-1)
    assert bool((worst <= REL_TOL[dtype] * scale).all())


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def _rand(g, shape, dtype, dev):
    return (torch.randn(shape, generator=g) * 0.5).to(dtype).to(dev)


def _paged_case(g, B, N, bs, nbt, K, hd, dtype, dev, lens):
    """Pools + tables where row b holds `lens[b]` tokens (0 = all -1)."""
    kp = _rand(g, (N, bs, K, hd), dtype, dev)
    vp = _rand(g, (N, bs, K, hd), dtype, dev)
    kvp = torch.randint(0, 64, (N, bs), generator=g, dtype=torch.int32)
    tab = torch.full((B, nbt), -1, dtype=torch.int32)
    free = (torch.randperm(N - 1, generator=g) + 1).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // bs)):
            phys = free.pop()
            tab[b, j] = phys
            r = torch.arange(bs, dtype=torch.int32) + j * bs
            kvp[phys] = torch.where(r < n, r, -1)
    return kp, vp, kvp.to(dev), tab.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (8, 2, 128), (32, 8, 128)])
def test_paged_decode_kernel_matches_plain(dev, dtype, H, K, hd):
    g = torch.Generator().manual_seed(H * K + hd)
    lens = [37, 16, 0, 1, 64]
    kp, vp, kvp, tab = _paged_case(g, 5, 30, 16, 4, K, hd, dtype, dev, lens)
    pos = torch.tensor([n - 1 if n else 5 for n in lens], dtype=torch.int32,
                       device=dev)
    q = _rand(g, (5, H, hd), dtype, dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, kvp, tab, pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       kvp, tab, pos)
    _assert_close(out, ref, dtype)
    assert float(out[2].abs().max()) == 0.0          # all -1 table -> 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (32, 8, 128)])
def test_paged_prefill_kernel_matches_plain(dev, dtype, H, K, hd):
    g = torch.Generator().manual_seed(H + K + hd)
    # two rows, chunks starting mid-page; context written up to the chunk
    rows = [(21, 40), (5, 19)]
    lens = [p0 + sc for p0, sc in rows]
    kp, vp, kvp, tab = _paged_case(g, 2, 40, 16, 6, K, hd, dtype, dev, lens)
    Sc = max(sc for _p, sc in rows)
    positions = torch.stack([
        (p0 + torch.arange(Sc)).clamp(max=p0 + sc - 1) for p0, sc in rows
    ]).to(torch.int32).to(dev)
    q = _rand(g, (2, Sc, H, hd), dtype, dev)
    out = paged_prefill_attention(q, kp, vp, kvp, tab, positions)
    ref = paged_prefill_attention_plain(q.float(), kp.float(), vp.float(),
                                        kvp, tab, positions)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_prefill_kernel_matches_plain(dev, dtype, causal, window):
    g = torch.Generator().manual_seed(3)
    B, S, H, K, hd = 2, 96, 8, 2, 64
    q = _rand(g, (B, S, H, hd), dtype, dev)
    k = _rand(g, (B, S, K, hd), dtype, dev)
    v = _rand(g, (B, S, K, hd), dtype, dev)
    pos = torch.cat([torch.arange(40), torch.arange(45), torch.zeros(11,
                     dtype=torch.int64)]).to(torch.int32).repeat(B, 1).to(dev)
    seg = torch.cat([torch.zeros(40), torch.ones(45), -torch.ones(11)]
                    ).to(torch.int32).repeat(B, 1).to(dev)
    out = flash_prefill(q, k, v, pos, pos, seg, seg, causal, window)
    ref = flash_prefill_plain(q.float(), k.float(), v.float(), pos, pos, seg,
                              seg, causal, window)
    _assert_close(out, ref, dtype)
    assert float(out[:, 85:].abs().max()) == 0.0     # padding rows


def test_wrapper_rejects_unsupported_head_dim_on_cuda(dev):
    q = torch.zeros(1, 4, 32, device=dev)
    pool = torch.zeros(3, 16, 4, 32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, torch.zeros(3, 16, **i32),
                               torch.zeros(1, 2, **i32),
                               torch.zeros(1, **i32))


def test_unified_server_on_cuda_matches_cpu(dev):
    """Reduced deepseek-7b in fp32: the served tokens on the card (through
    both kernels) equal the same server's on the CPU (plain versions)."""
    cfg = get_arch("deepseek-7b", reduced=True)
    scfg = ServingConfig(
        num_prefill_instances=1, prefill_dp_per_instance=1,
        num_decode_instances=1, decode_dp_per_instance=2,
        max_batch_per_dp=4, block_size=16, mixed_batch=True, mixed_chunk=32)

    def requests():
        rng = random.Random(5)
        return [Request(rid=i, arrival_time=0.02 * i, input_len=L,
                        output_len=6,
                        tokens=tuple(rng.randrange(cfg.vocab_size)
                                     for _ in range(L)))
                for i, L in enumerate((17, 40, 33, 64))]

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    cpu_params = init_params(cfg, seed=0, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        params = to(cpu_params, device)
        launches = (paged_decode_attention.launches,
                    paged_prefill_attention.launches)
        srv = RealSBSServer(cfg, params, scfg,
                            scheduler="sbs-la", max_len=96, max_new=6,
                            device=device)
        gens = srv.serve(requests(), timeout=120)
        out[device] = {g.rid: g.tokens for g in gens}
        if device == "cuda":
            assert paged_decode_attention.launches > launches[0]
            assert paged_prefill_attention.launches > launches[1]
    assert len(out["cpu"]) == 4
    assert out["cuda"] == out["cpu"]
