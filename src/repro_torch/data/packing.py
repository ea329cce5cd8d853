"""Sequence packing: fill fixed-length rows with variable-length documents,
emitting segment ids + per-segment positions (consumed by the models'
segment-aware attention masks — the same mechanism the serving engine uses
for packed varlen chunked prefill)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing. Returns tokens/targets/seg/positions arrays
    of shape (n_rows, seq_len). targets are next-token within each segment;
    the final token of each segment gets target -100 (ignored), as do pads.
    """
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    for d in docs:
        d = d[: seq_len]
        placed = False
        for i, s in enumerate(space):
            if len(d) <= s:
                rows[i].append(d)
                space[i] -= len(d)
                placed = True
                break
        if not placed:
            rows.append([d])
            space.append(seq_len - len(d))
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    targets = np.full((n, seq_len), -100, np.int32)
    seg = np.full((n, seq_len), -1, np.int32)
    pos = np.zeros((n, seq_len), np.int32)
    for i, row in enumerate(rows):
        off = 0
        for j, d in enumerate(row):
            L = len(d)
            tokens[i, off:off + L] = d
            targets[i, off:off + L - 1] = d[1:]
            seg[i, off:off + L] = j
            pos[i, off:off + L] = np.arange(L)
            off += L
    return {"tokens": tokens, "targets": targets, "seg": seg,
            "positions": pos}
