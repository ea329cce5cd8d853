"""Paged KV block allocator — the host-side control plane of the paged
decode cache (the device-side pool layout lives in `models.model`'s
`init_paged_cache` family).

A `BlockPool` owns a fixed set of physical KV blocks of `block_size`
tokens each.  Requests hold *block tables* (lists of physical block ids)
instead of a padded `max_len` slot, so a DP unit's admission limit is its
free-block count, not its slot count — the same mechanism vLLM-style
PagedAttention and Sarathi-Serve use to keep decode concurrency high at a
fixed KV memory budget.

Blocks are REFCOUNTED so several block tables can point at the same
read-only physical block (prefix sharing): `alloc` hands a block out with
one reference, `incref` adds holders, and `free` drops one reference per
id — a block returns to the free heap only when its last holder lets go.
Writers must never scatter into a block whose refcount exceeds one; the
engine copies it first (copy-on-write, see `models.model.paged_copy_block`).
The pool also keeps a content key → block map (`bind`/`lookup`) so a
radix prefix index can resolve "these `block_size` tokens at this
position" to an existing physical page in O(1); bindings die with the
block's last reference.

Physical block 0 is RESERVED as the null block: inactive batch rows and
padding entries of a block table scatter their garbage writes there, so
the pool never hands it out.  The allocator is deliberately strict —
double-free and foreign-id frees raise instead of corrupting the free
heap — because the property suite (tests/test_kv_pool.py,
tests/test_page_sharing.py) drives it with random join/take/share/free
sequences and any silent self-healing would mask a real leak in the
engine.
"""
from __future__ import annotations

import heapq
from typing import Dict, Hashable, Iterable, List, Optional, Sequence

from repro_torch.core.types import blocks_for_tokens

NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """Allocation request exceeds the pool's free-block count."""


class BlockPool:
    """Fixed-capacity physical KV block allocator (one per decode DP).

    ids run base+1..base+num_blocks-1 (0 is the reserved null block, and
    id `base` of a non-zero-based pool is never issued — it aliases
    another pool's range boundary in the merged sharded cache); `alloc`
    returns the lowest free ids first so reuse is deterministic and the
    property tests can assert freed pages come back.  The free store is
    a binary heap: alloc/free are O(log n) per block where the old
    sorted-list store re-sorted the whole list on every free.

    `base` exists for the SHARDED real plane: every decode DP keeps its
    own allocator (admission control stays per-DP), but all DPs' blocks
    live in ONE mesh-sharded device pool — DP d gets
    `BlockPool(num_blocks, bs, base=d*num_blocks)` so its physical ids
    index its own shard of the merged pool dimension and can never
    collide with another DP's table rows.
    """

    def __init__(self, num_blocks: int, block_size: int, base: int = 0):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if base < 0:
            raise ValueError("base must be >= 0")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.base = base
        # min-heap => deterministic lowest-id-first reuse (a sorted range
        # is already a valid heap, so no heapify needed here)
        self._free: List[int] = list(range(base + 1, base + num_blocks))
        self._ref: Dict[int, int] = {}          # block id -> holders (>=1)
        # content-addressed page map: key -> block and its inverse, so
        # prefix-cache admission resolves cached token blocks to physical
        # pages without walking engine state
        self._block_of: Dict[Hashable, int] = {}
        self._key_of: Dict[int, Hashable] = {}

    # -- capacity probes -------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._ref)

    @property
    def capacity_tokens(self) -> int:
        """Usable KV tokens (the null block is dead memory)."""
        return (self.num_blocks - 1) * self.block_size

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold `tokens` KV entries (the shared ceiling
        rule — scheduler reservations use the same function)."""
        return blocks_for_tokens(tokens, self.block_size)

    def can_alloc(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self.free_count

    # -- alloc / refcount / free -----------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take `n` blocks off the free heap (lowest ids first), each
        with a single reference held by the caller."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool of {self.num_blocks})")
        taken = [heapq.heappop(self._free) for _ in range(n)]
        for b in taken:
            self._ref[b] = 1
        return taken

    def alloc_for(self, tokens: int) -> List[int]:
        return self.alloc(self.blocks_for(tokens))

    def incref(self, ids: Iterable[int]) -> None:
        """Add one holder per id (block-table sharing).  Only live blocks
        can gain references."""
        for b in ids:
            if b not in self._ref:
                raise ValueError(f"incref of unallocated block {b}")
            self._ref[b] += 1

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_shared(self, block: int) -> bool:
        """True when a write into `block` needs copy-on-write."""
        return self._ref.get(block, 0) > 1

    def free(self, ids: Iterable[int]) -> None:
        """Drop one reference per id; a block returns to the pool only
        when its last reference is dropped (its content binding dies with
        it).  Raises on over-free, the null block, or ids the pool never
        issued."""
        for b in ids:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the reserved null block")
            r = self._ref.get(b)
            if r is None:
                raise ValueError(f"free of unallocated block {b}")
            if r > 1:
                self._ref[b] = r - 1
                continue
            del self._ref[b]
            key = self._key_of.pop(b, None)
            if key is not None:
                self._block_of.pop(key, None)
            heapq.heappush(self._free, b)

    # -- content-addressed page map --------------------------------------
    def bind(self, key: Hashable, block: int) -> None:
        """Publish `block` as the physical page holding the content named
        by `key`.  First binding wins: rebinding an already-published key
        to a different live block is a no-op (the existing page stays the
        canonical copy), so concurrent prefills of the same prefix
        converge on one page."""
        if block not in self._ref:
            raise ValueError(f"bind of unallocated block {block}")
        if key in self._block_of:
            return
        self._block_of[key] = block
        self._key_of[block] = key

    def lookup(self, key: Hashable) -> Optional[int]:
        """Physical block holding `key`'s content, or None."""
        return self._block_of.get(key)

    # -- invariants (asserted by the property suite) ---------------------
    def check(self) -> None:
        """Conservation: every non-null block is free XOR referenced,
        once; refcounts are positive; content bindings point at live
        blocks and are mutually consistent."""
        free = self._free
        used = set(self._ref)
        assert len(set(free)) == len(free), "duplicate ids on the free heap"
        assert not (set(free) & used), "block both free and referenced"
        assert NULL_BLOCK not in set(free) | used, "null block leaked"
        assert len(free) + len(used) == self.num_blocks - 1, (
            f"leak: {len(free)} free + {len(used)} used != "
            f"{self.num_blocks - 1}")
        assert all(r >= 1 for r in self._ref.values()), "dead refcount entry"
        for key, b in self._block_of.items():
            assert b in self._ref, f"binding {key!r} -> freed block {b}"
            assert self._key_of.get(b) == key, "content map out of sync"
        assert len(self._key_of) == len(self._block_of), (
            "content map out of sync")


def pad_block_table(ids: Sequence[int], width: int) -> List[int]:
    """Fixed-width block-table row: real ids then -1 padding (the jit'd
    cache surgery takes a constant-shape row; -1 marks unset slots and
    routes scatter traffic to the null block)."""
    if len(ids) > width:
        raise ValueError(f"{len(ids)} blocks exceed table width {width}")
    return list(ids) + [-1] * (width - len(ids))
