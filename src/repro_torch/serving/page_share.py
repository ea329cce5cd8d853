"""Block-granular prefix-cache reuse: RadixTree nodes bound to BlockPool
pages (vLLM block-manager design, SGLang-style radix resolution).

`PagePrefixBinder` is the glue object the real engines own, one per
physical `BlockPool` (per prefill engine on the prefill plane, per
decode DP on the decode plane):

  * `claim(tokens)`  resolves the longest cached prefix of a prompt to
    live physical block ids and takes one pool reference per block for
    the caller — the caller's block table then POINTS AT the cached
    pages instead of recomputing them.  An exact full-prompt hit also
    returns the stored first output token, so prefill can be skipped
    entirely (zero chunks).
  * `insert(tokens, block_ids, first_token)` publishes a finished
    prompt's pages into the tree.  The tree holds one reference per
    bound node, so LRU eviction is a DECREF — a page shared with a live
    block table survives eviction and is reclaimed only when its last
    holder lets go ("LRU eviction only frees refcount-0 blocks").
  * `ensure_free(n)` is pool-pressure eviction: peel LRU entries until
    `n` blocks are free, bounded by the cache emptying.

Sharing is strictly BLOCK-granular and position-exact: a partial tail
block is bound only together with a `first_token` payload (it is usable
only by an exact-length repeat of the same prompt, which never writes
into it during prefill; a decode-side adopter write triggers
copy-on-write).  Content keys published to `BlockPool.bind` are the
exact token prefix through the block, so the content-addressed map can
never alias two different prefixes.

`EngineBackedPrefixIndex` adapts a set of binders to the
`PrefixCacheIndex` shape `prefill_alloc.greedy_dispatch` consumes, so
cache-aware PBAA credits exactly the chunks the real engine will skip.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.prefix_cache import RadixTree
from repro_torch.serving.kv_pool import BlockPool


class PagePrefixBinder:
    """Radix prefix index over one `BlockPool`'s physical pages."""

    def __init__(self, pool: BlockPool, budget_tokens: Optional[int] = None,
                 block_size: Optional[int] = None):
        self.pool = pool
        self.block = block_size or pool.block_size
        budget = (budget_tokens if budget_tokens is not None
                  else pool.capacity_tokens)
        self.tree = RadixTree(budget, self.block, on_evict=self._on_evict)
        # reuse accounting the benchmark harness reads (engine truth, vs
        # the scheduler-side PrefixCacheIndex estimate)
        self.hit_tokens = 0
        self.seen_tokens = 0

    def _on_evict(self, node) -> None:
        # decref, not force-free: pages shared with live block tables
        # survive their cache entry
        if node.blocks:
            self.pool.free(node.blocks)

    # -- resolution ------------------------------------------------------
    def _usable(self, tokens: Sequence[int]) -> Tuple[int, List]:
        """Walk the tree, stopping at the first node without a page
        binding; returns (usable tokens, bound node path)."""
        matched, path = self.tree.match_path(tokens)
        nodes, usable = [], 0
        for n in path:
            if not n.blocks:
                break
            nodes.append(n)
            usable += n.tokens
        return min(usable, matched), nodes

    def peek(self, tokens: Sequence[int]) -> Tuple[int, bool]:
        """(claimable prefix tokens, exact-full-hit?) without taking any
        references — the scheduler-side view of `claim`."""
        if not tokens:
            return 0, False
        usable, nodes = self._usable(tokens)
        if (usable >= len(tokens) and nodes
                and nodes[-1].value is not None):
            return len(tokens), True
        claim = min(usable, max(len(tokens) - 1, 0))
        return (claim // self.block) * self.block, False

    def claim(self, tokens: Sequence[int]
              ) -> Tuple[int, List[int], Optional[int]]:
        """Resolve the longest cached prefix to physical pages, taking
        one pool reference per returned block for the caller.

        Returns (claimed tokens, block ids, first_token-or-None).  A
        full hit claims the whole prompt including the partial tail
        block and carries the stored first output token; otherwise the
        claim is capped at len-1 (the last position's logits must be
        computed) and floored to block granularity.
        """
        if not tokens:
            return 0, [], None
        usable, nodes = self._usable(tokens)
        if (usable >= len(tokens) and nodes
                and nodes[-1].value is not None):
            blocks = [b for n in nodes for b in n.blocks]
            self.pool.incref(blocks)
            return len(tokens), blocks, nodes[-1].value
        claim = min(usable, max(len(tokens) - 1, 0))
        claim = (claim // self.block) * self.block
        nb = claim // self.block
        # non-terminal edges are exactly `block` tokens / one page each
        blocks = [b for n in nodes[:nb] for b in n.blocks]
        self.pool.incref(blocks)
        return claim, blocks, None

    # -- publication -----------------------------------------------------
    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               first_token: Optional[int] = None) -> None:
        """Publish a finished prompt's pages.  `block_ids` holds one id
        per block-sized slice of `tokens` (the request's block table
        prefix).  The tree takes one reference per NEWLY bound node
        (first copy wins — later identical prompts share the first
        pages); the partial tail block is bound only when a
        `first_token` payload makes it usable (exact-sequence hit)."""
        toks = tuple(tokens)
        n_full = len(toks) // self.block
        if first_token is None:
            toks = toks[: n_full * self.block]
            block_ids = list(block_ids)[:n_full]
        if not toks:
            return
        edges = [toks[i:i + self.block]
                 for i in range(0, len(toks), self.block)]
        if len(block_ids) < len(edges):
            raise ValueError(
                f"{len(block_ids)} blocks cannot bind {len(edges)} edges")
        # which edges will this insert NEWLY bind?  (the tree keeps the
        # first binding, so only those gain a tree-held reference)
        newly: List[int] = []
        node = self.tree.root
        for i, blk in enumerate(edges):
            nxt = node.edges.get(blk)
            if nxt is None:
                newly.extend(block_ids[i:len(edges)])
                break
            if not nxt.blocks:
                newly.append(block_ids[i])
            node = nxt
        if newly:
            self.pool.incref(newly)
        self.tree.insert(toks, blocks=[(b,) for b in block_ids[:len(edges)]],
                         value=first_token)
        # content-addressed page map: key = the exact prefix through the
        # block, so lookups can never alias distinct prefixes
        for i in range(len(edges)):
            self.pool.bind(toks[: (i + 1) * self.block], block_ids[i])

    # -- pool pressure ---------------------------------------------------
    def ensure_free(self, need_blocks: int) -> bool:
        """Evict LRU cache entries until `need_blocks` pool blocks are
        free (or the cache is empty).  Eviction decrefs, so shared pages
        are unpinned from the CACHE without yanking them from live block
        tables."""
        while self.pool.free_count < need_blocks:
            if self.tree.evict_tokens(1) == 0:
                break
        return self.pool.free_count >= need_blocks

    def record(self, hit: int, prompt: int) -> None:
        self.hit_tokens += hit
        self.seen_tokens += prompt

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.seen_tokens if self.seen_tokens else 0.0


class EngineBackedPrefixIndex:
    """`PrefixCacheIndex`-shaped view over the prefill engines' REAL page
    binders, for cache-aware PBAA on the real plane.

    `match` asks the dp's binder what a claim would return, so the
    scheduler credits exactly the chunks the engine skips (poll →
    enqueue is synchronous on the runtime thread — no engine state can
    change between the credit and the claim).  `insert` is a no-op:
    pages are published by the ENGINE at prefill completion, not
    speculatively by the scheduler.  `first_dispatch_only` tells
    `greedy_dispatch` not to re-credit later chunks of an already
    claimed (pinned) request."""

    first_dispatch_only = True

    def __init__(self, binder_of: Dict[int, PagePrefixBinder]):
        self._binder_of = dict(binder_of)       # dp_id -> engine binder
        self.hit_tokens = 0
        self.seen_tokens = 0

    def match(self, dp_id: int, tokens: Optional[Sequence[int]],
              limit: Optional[int] = None) -> int:
        binder = self._binder_of.get(dp_id)
        if binder is None or tokens is None:
            return 0
        claim, _full = binder.peek(tokens)
        return min(claim, limit) if limit is not None else claim

    def insert(self, dp_id: int, tokens: Optional[Sequence[int]]) -> int:
        return 0

    def record(self, hit: int, prompt: int) -> None:
        self.hit_tokens += hit
        self.seen_tokens += prompt

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.seen_tokens if self.seen_tokens else 0.0
