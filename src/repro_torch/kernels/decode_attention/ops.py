"""Decode attention, paged and dense: the CUDA kernels' wrappers and
their plain PyTorch versions.

Replaces `repro/kernels/decode_attention/kernel.py`:

  * `paged_decode_attention_pallas` by `paged_decode_attention`
    (`repro_torch/csrc/paged_decode_attention.cu`): one query token per
    row over its K/V pages through the block table;
  * `decode_attention_pallas` by `decode_attention`
    (`repro_torch/csrc/decode_attention.cu`): one query token per row
    over a dense (B, S, K, hd) cache, a ring for sliding-window models.

Both kernels are bound by the bytes of each row's live K/V and walk
only the row's live entries with an fp32 online softmax — see the
source notes.  Both split each row across CTAs, one per (kv head, row,
split): the paged kernel cuts the row's table into `decode_splits(B, K,
nbt, SMs)` ranges of table entries, the dense kernel its cache into
`dense_splits(B, K, S, SMs)` ranges of 16-index units; one merge kernel,
shared by both, combines the splits' partials, so one wrapper call
launches two kernels (one when there is a single split).  Each wrapper
launches its kernel for CUDA tensors and takes the plain version only
for CPU tensors; `<wrapper>.launches` counts the wrapper's calls that
launched.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import load_kernels
from repro_torch.models.attention import (
    decode_attention as _dense_reference, decode_attention_paged,
)

HEAD_DIMS = (64, 128)       # head dims the kernel is instantiated for
MAX_GROUP = 8               # query heads per kv head one CTA handles
DTYPES = (torch.float32, torch.bfloat16)
H100_SM_COUNT = 132         # streaming multiprocessors of an H100 SXM
SPLIT_CTAS_PER_SM = 8       # two waves of four resident CTAs per SM
MIN_SPLIT_BLOCKS = 4        # table entries a split takes at least


def decode_splits(B: int, K: int, nbt: int,
                  sm_count: int = H100_SM_COUNT) -> int:
    """Number of ranges the paged decode kernel cuts each row's block
    table into, from the shapes alone (never from `pos`: reading it
    would sync the host once per layer).  Enough (kv head, row, split)
    CTAs to give each of `sm_count` SMs `SPLIT_CTAS_PER_SM`, no split
    under `MIN_SPLIT_BLOCKS` table entries (one split when the table is
    shorter), and every split owns at least one entry: the splits are
    ranges of `per` entries and the last one starts before nbt."""
    if nbt <= 0:
        raise ValueError(f"nbt must be positive, got {nbt}")
    want = -(-SPLIT_CTAS_PER_SM * sm_count // max(B * K, 1))
    per = max(MIN_SPLIT_BLOCKS, -(-nbt // want))
    return -(-nbt // per)


DENSE_SPLIT_UNIT = 16        # cache indices per unit of a dense split


def dense_splits(B: int, K: int, S: int,
                 sm_count: int = H100_SM_COUNT) -> int:
    """Number of ranges the dense decode kernel cuts each row's cache
    walk into: `decode_splits` over ceil(S / 16) units of 16 cache
    indices, so from the shapes alone; every split owns at least one
    unit (9 splits of 128 indices at B=4, K=32, S=1088 on 132 SMs)."""
    if S <= 0:
        raise ValueError(f"S must be positive, got {S}")
    return decode_splits(B, K, -(-S // DENSE_SPLIT_UNIT), sm_count)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_decode_attention_plain(q, k_pool, v_pool, kv_pos_pool, block_tab,
                                 pos, window: int = 0):
    """Dense block-gather version.  q (B, H, hd); pools (N, bs, K, hd);
    kv_pos_pool (N, bs) int32; block_tab (B, nbt) int32 (-1 = unset);
    pos (B,) int32  ->  (B, H, hd)."""
    return decode_attention_paged(q[:, None], k_pool, v_pool, kv_pos_pool,
                                  block_tab, pos, window)[:, 0]


def _check_common(q, k, v, ints) -> None:
    """Checks both kernels share: q (B, H, hd) and K/V (.., K, hd) of one
    dtype, a head dim and a group size the kernels are instantiated for,
    int32 index inputs (`ints`, name -> tensor), and every input
    contiguous, 16-byte aligned where loaded by 16 bytes, on q's device."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be (B, H, hd) and K/V 4-d")
    H, hd = q.shape[1], q.shape[2]
    K = k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[3] != hd:
        raise ValueError(f"K/V shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, K and V must share one dtype of {DTYPES}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"H={H}, K={K}: need H % K == 0 and "
                         f"H // K <= {MAX_GROUP}")
    for name, t in (("q", q), ("k", k), ("v", v), *ints.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def check_args(q, k_pool, v_pool, kv_pos_pool, block_tab, pos) -> None:
    """Raise ValueError for any input the paged kernel does not take."""
    _check_common(q, k_pool, v_pool, {"kv_pos_pool": kv_pos_pool,
                                      "block_tab": block_tab, "pos": pos})
    B = q.shape[0]
    N, bs = k_pool.shape[:2]
    if tuple(kv_pos_pool.shape) != (N, bs):
        raise ValueError(f"kv_pos_pool must be {(N, bs)}")
    if block_tab.dim() != 2 or block_tab.shape[0] != B \
            or block_tab.shape[1] == 0:
        raise ValueError(f"block_tab must be ({B}, nbt) with nbt > 0")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},)")


def paged_decode_attention(q, k_pool, v_pool, kv_pos_pool, block_tab, pos,
                           window: int = 0):
    """One query token per row over its K/V pages (shapes as the plain
    version).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, kv_pos_pool,
                                            block_tab, pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_args(q, k_pool, v_pool, kv_pos_pool, block_tab, pos)
    n_split = decode_splits(q.shape[0], k_pool.shape[2], block_tab.shape[1],
                            _sm_count(q.device))
    out = load_kernels().paged_decode_attention(
        q, k_pool, v_pool, kv_pos_pool, block_tab, pos, int(window),
        q.shape[-1] ** -0.5, n_split)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# dense (padded / ring) cache
# ---------------------------------------------------------------------------

def decode_attention_plain(q, k_cache, v_cache, kv_pos, pos, window: int = 0):
    """Einsum scores + masked softmax.  q (B, H, hd); caches (B, S, K, hd);
    kv_pos (B, S) int32 (-1 = empty); pos (B,) int32  ->  (B, H, hd).
    Key i is valid iff 0 <= kv_pos[i] <= pos and, with window > 0,
    pos - kv_pos[i] < window; a row with no valid key gives 0."""
    return _dense_reference(q[:, None], k_cache, v_cache, kv_pos, pos,
                            window)[:, 0]


def check_dense_args(q, k_cache, v_cache, kv_pos, pos) -> None:
    """Raise ValueError for any input the dense kernel does not take."""
    _check_common(q, k_cache, v_cache, {"kv_pos": kv_pos, "pos": pos})
    B = q.shape[0]
    S = k_cache.shape[1]
    if k_cache.shape[0] != B:
        raise ValueError(f"caches must have {B} rows, as q")
    if tuple(kv_pos.shape) != (B, S):
        raise ValueError(f"kv_pos must be {(B, S)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},)")


def decode_attention(q, k_cache, v_cache, kv_pos, pos, window: int = 0):
    """One query token per row over its dense cache (shapes as the plain
    version).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.  The kernel walks cache indices
    0 .. min(S, pos + 1) - 1, which equals the plain version whenever
    index i holds -1 or a position p with p % S == i (every engine path;
    see `repro_torch/csrc/decode_attention.cu`)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_pos, pos,
                                      window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_dense_args(q, k_cache, v_cache, kv_pos, pos)
    n_split = dense_splits(q.shape[0], k_cache.shape[2], k_cache.shape[1],
                           _sm_count(q.device))
    out = load_kernels().decode_attention(
        q, k_cache, v_cache, kv_pos, pos, int(window), q.shape[-1] ** -0.5,
        n_split)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
