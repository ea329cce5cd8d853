"""Radix-tree prefix-cache index for cache-aware PBAA (§4.2.2).

The scheduler keeps one radix tree PER DP UNIT (KV caches are DP-local in
DP+EP systems). `match` returns the longest cached prefix length; `insert`
records a processed prefix; LRU eviction under a token budget.

Nodes can optionally be BOUND to physical KV block ids (the real plane's
`BlockPool` pages, see `serving/page_share.py`): a bound node means "this
edge's tokens live in these pages", so admission resolves a request's
longest cached prefix to real memory instead of recomputing it.  Eviction
then hands the evicted nodes' blocks to an `on_evict` callback, which
drops the tree's reference — the pool only reclaims a page once every
holder (tree AND in-flight block tables) has let go, so LRU pressure can
never free a block that is still referenced.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("edges", "last_used", "tokens", "blocks", "value")

    def __init__(self):
        self.edges: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0.0
        self.tokens = 0   # tokens on the edge INTO this node
        # physical KV block ids holding this edge's tokens (page binding);
        # empty for scheduler-side (simulated) trees
        self.blocks: Tuple[int, ...] = ()
        # terminal payload for an exact full-sequence hit (the real plane
        # stores the argmax first token so a full-prefix hit can skip
        # prefill compute entirely)
        self.value = None


class RadixTree:
    """Compressed trie over token sequences with LRU eviction."""

    def __init__(self, budget_tokens: int = 1_000_000, block: int = 16,
                 on_evict: Optional[Callable[["_Node"], None]] = None):
        self.root = _Node()
        self.budget = budget_tokens
        self.block = block           # match granularity (KV block size)
        self.size = 0
        self._clock = 0.0
        self._on_evict = on_evict

    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    def _blocks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        t = tuple(tokens)
        return [t[i:i + self.block] for i in range(0, len(t), self.block)]

    def _walk(self, tokens: Sequence[int]) -> Tuple[int, List["_Node"]]:
        """Descend as far as the cached edges allow; returns the matched
        token count and the matched path (root excluded)."""
        node, matched, path = self.root, 0, []
        for blk in self._blocks(tokens):
            nxt = node.edges.get(blk)
            if nxt is None:
                break
            node, matched = nxt, matched + len(blk)
            path.append(nxt)
        return matched, path

    def _bump(self, path: Sequence["_Node"]) -> None:
        """Refresh `last_used` on a node AND every ancestor on its path:
        a hot child must keep its parent edges warm, otherwise LRU
        pressure could peel the parent chain out from under a prefix
        that is still being matched."""
        now = self._tick()
        for n in path:
            n.last_used = now

    def match(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix (in tokens, block-quantized)."""
        if not tokens:
            return 0
        matched, path = self._walk(tokens)
        self._bump(path)
        return matched

    def match_path(self, tokens: Sequence[int]
                   ) -> Tuple[int, List["_Node"]]:
        """Like `match` but also returns the matched nodes, so a page
        binder can read their bound block ids / terminal payload."""
        if not tokens:
            return 0, []
        matched, path = self._walk(tokens)
        self._bump(path)
        return matched, path

    def insert(self, tokens: Sequence[int],
               blocks: Optional[Sequence[Sequence[int]]] = None,
               value=None) -> int:
        """Insert prefix; returns newly added token count.

        `blocks`, when given, is one id-tuple per `block`-sized edge of
        `tokens` (parallel to the descent) and binds each node to the
        physical pages holding its edge — nodes that already carry a
        binding keep it (first copy wins).  `value` is attached to the
        terminal node (exact-sequence payload).
        """
        now = self._tick()
        node, added = self.root, 0
        for i, blk in enumerate(self._blocks(tokens)):
            nxt = node.edges.get(blk)
            if nxt is None:
                nxt = _Node()
                nxt.tokens = len(blk)
                node.edges[blk] = nxt
                added += len(blk)
            if blocks is not None and i < len(blocks) and not nxt.blocks:
                nxt.blocks = tuple(blocks[i])
            nxt.last_used = now
            node = nxt
        if value is not None:
            node.value = value
        self.size += added
        if self.size > self.budget:
            self._evict(self.size - self.budget)
        return added

    def evict_tokens(self, need: int) -> int:
        """Externally-driven LRU eviction (pool pressure): free at least
        `need` cached tokens, returning the count actually evicted."""
        before = self.size
        self._evict(need)
        return before - self.size

    def _evict(self, need: int) -> None:
        """Evict least-recently-used leaves until `need` tokens are freed.
        Bound blocks are released through `on_evict` — a decref, not a
        force-free, so pages shared with live block tables survive."""
        freed = 0
        while freed < need:
            leaf = self._lru_leaf(self.root, None, None)
            if leaf is None:
                break
            parent, key, node = leaf
            parent.edges.pop(key)
            freed += node.tokens
            if self._on_evict is not None:
                self._on_evict(node)
        self.size -= freed

    def _lru_leaf(self, node: "_Node", parent, key):
        best = None
        for k, child in node.edges.items():
            if not child.edges:   # leaf
                cand = (node, k, child)
                if best is None or cand[2].last_used < best[2].last_used:
                    best = cand
            else:
                cand = self._lru_leaf(child, node, k)
                if cand is not None and (
                        best is None or cand[2].last_used < best[2].last_used):
                    best = cand
        return best


class PrefixCacheIndex:
    """Per-DP radix trees, the scheduler-side model of engine KV reuse.

    Also keeps the hit accounting the benchmark harness reads:
    `hit_tokens` / `seen_tokens` accumulate per first-dispatch request
    (see `prefill_alloc.greedy_dispatch`), so `hit_rate` is the fraction
    of prompt tokens served from cache."""

    def __init__(self, dp_ids: Sequence[int], budget_tokens: int = 1_000_000,
                 block: int = 16):
        self.trees: Dict[int, RadixTree] = {
            d: RadixTree(budget_tokens, block) for d in dp_ids}
        self.hit_tokens = 0
        self.seen_tokens = 0

    def match(self, dp_id: int, tokens: Optional[Sequence[int]],
              limit: Optional[int] = None) -> int:
        if tokens is None or dp_id not in self.trees:
            return 0
        m = self.trees[dp_id].match(tokens)
        return min(m, limit) if limit is not None else m

    def insert(self, dp_id: int, tokens: Optional[Sequence[int]]) -> int:
        if tokens is None or dp_id not in self.trees:
            return 0
        return self.trees[dp_id].insert(tokens)

    def record(self, hit: int, prompt: int) -> None:
        """Account one request's first dispatch: `hit` of `prompt` prompt
        tokens were served from cache."""
        self.hit_tokens += hit
        self.seen_tokens += prompt

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.seen_tokens if self.seen_tokens else 0.0
