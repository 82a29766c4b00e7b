"""Radix prefix cache: token-trie of resident KV pages.

A copy of ``distributed_tensorflow_models_tpu/serving/prefix_cache.py``
(host bookkeeping only).  RadixAttention-style (SGLang) sharing on top of
the paged arena (``kv_slots``): after a request's prompt is prefilled,
its FULL pages are inserted into a token trie keyed by page-sized token
tuples, with
the cache taking its own :class:`~.kv_slots.BlockPool` reference on
each adopted block.  A later admission walks the trie with its own
prompt pages and reuses the longest resident prefix — those blocks go
straight into the new request's block table (refcounted, never copied,
never re-prefilled) and only the uncached suffix is prefilled.  N
requests sharing a system prompt prefill it once.

Sharing is FULL pages only: a divergent tail inside a page would need a
device-side partial-page copy program (a third program, which
the ``compile_counts() == (1, 1)`` pin forbids).  Instead the
copy-on-write boundary is the page edge — sharers gather the common
full pages through their tables and prefill their divergent tail into
fresh private blocks.  Shared blocks are never written by a sharer:
prefill starts at the cached length, and decode's write head starts at
the prompt end, both past every shared page.

Eviction is LRU over trie *leaves* (an interior node's block is the
prefix of its children — evicting it would orphan them), stamped by a
monotonic integer clock, never wall time (the determinism-hazard rule:
two replicas replaying the same admission order must evict the same
blocks).  Evicting a node drops only the cache's reference; a block
still gathered by an in-flight request stays allocated until that
request retires, it just stops being matchable.
"""

from __future__ import annotations

from typing import Optional

from .kv_slots import BlockPool


class _Node:
    __slots__ = ("block", "stamp", "children")

    def __init__(self, block: int, stamp: int):
        self.block = block
        self.stamp = stamp
        self.children: dict = {}  # page token-tuple -> _Node


def prompt_pages(prompt, page_tokens: int) -> list:
    """The FULL page-sized token tuples of ``prompt`` (the partial tail
    page, if any, is never shared and never enters the trie)."""
    out = []
    for lo in range(0, len(prompt) - page_tokens + 1, page_tokens):
        out.append(tuple(int(t) for t in prompt[lo:lo + page_tokens]))
    return out


class RadixPrefixCache:
    """Token trie of resident prefixes over a shared :class:`BlockPool`.

    ``max_blocks`` optionally bounds residency (cache-held blocks);
    inserts past the bound evict LRU leaves first.  Hit/miss/eviction
    counts are block-granular and cumulative — the engine mirrors them
    into the metrics registry.
    """

    def __init__(self, pool: BlockPool, page_tokens: int,
                 max_blocks: Optional[int] = None):
        if max_blocks is not None and max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        self.pool = pool
        self.page_tokens = int(page_tokens)
        self.max_blocks = max_blocks
        self._root = _Node(0, 0)  # sentinel; block never matched
        self._clock = 0  # monotonic LRU clock — never wall time
        self._resident = 0
        self.hits = 0        # blocks reused without re-prefill
        self.misses = 0      # matchable blocks that had to prefill
        self.evictions = 0   # blocks whose cache reference was dropped

    @property
    def resident_count(self) -> int:
        """Blocks currently referenced by the trie."""
        return self._resident

    def resident_blocks(self) -> list:
        """Every block id the trie currently holds a pool reference on
        (one per node) — the cache's side of the refcount-conservation
        ledger :func:`~.kv_slots.check_arena` audits."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node.block)
            stack.extend(node.children.values())
        return out

    def match(self, pages: list) -> list:
        """Longest resident prefix of ``pages``; returns its block ids
        (possibly empty) and freshens the matched path's LRU stamps.
        Counts hits/misses over the matchable pages.  The caller must
        ``pool.retain`` the returned blocks before using them — the
        cache's own reference does not cover the new request."""
        self._clock += 1
        node = self._root
        blocks = []
        for page in pages:
            child = node.children.get(page)
            if child is None:
                break
            child.stamp = self._clock
            blocks.append(child.block)
            node = child
        self.hits += len(blocks)
        self.misses += len(pages) - len(blocks)
        return blocks

    def peek(self, pages: list) -> int:
        """Length (in blocks) of the longest resident prefix, without
        touching stamps or counters — admission cost estimation."""
        node = self._root
        depth = 0
        for page in pages:
            child = node.children.get(page)
            if child is None:
                break
            depth += 1
            node = child
        return depth

    def insert(self, pages: list, blocks: list) -> int:
        """Make ``pages`` (filled, resident in ``blocks``) matchable.

        Walks the trie; existing nodes keep their block (an identical
        prompt prefilled concurrently dedupes — the newcomer's private
        copy is simply never adopted and dies with its request), new
        nodes adopt the request's block with a cache-owned pool
        reference.  Returns the number of blocks adopted.
        """
        if len(blocks) < len(pages):
            raise ValueError(
                f"need one block per page: {len(pages)} pages, "
                f"{len(blocks)} blocks"
            )
        self._clock += 1
        node = self._root
        adopted = 0
        for page, block in zip(pages, blocks):
            child = node.children.get(page)
            if child is None:
                self.pool.retain([block])
                child = _Node(block, self._clock)
                node.children[page] = child
                self._resident += 1
                adopted += 1
            else:
                child.stamp = self._clock
            node = child
        if self.max_blocks is not None and self._resident > self.max_blocks:
            self.evict(want_freed=0,
                       down_to=self.max_blocks)
        return adopted

    def evict(self, want_freed: int, down_to: Optional[int] = None) -> int:
        """Drop LRU leaves until ``want_freed`` blocks actually returned
        to the pool's free list (and, if ``down_to`` is given, residency
        is at most that), or the trie is empty.  Returns the number of
        blocks actually freed — a dropped block still held by an
        in-flight request counts as an eviction but frees nothing yet.
        """
        freed = 0
        while self._root.children:
            if freed >= want_freed and (
                down_to is None or self._resident <= down_to
            ):
                break
            parent, key, leaf = self._lru_leaf()
            del parent.children[key]
            self._resident -= 1
            self.evictions += 1
            freed += len(self.pool.release([leaf.block]))
        return freed

    def _lru_leaf(self):
        """(parent, key, node) of the least-recently-stamped leaf."""
        best = None
        stack = [(self._root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            if parent is not None and not node.children:
                if best is None or node.stamp < best[2].stamp:
                    best = (parent, key, node)
            for k in sorted(node.children):  # deterministic tie-break
                stack.append((node.children[k], node, k))
        return best
