"""Paged KV arena: block pool + block tables, static device shapes.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/serving/
kv_slots.py``.  The transformer decode cache of ONE sequence is a
:class:`~..models.transformer_lm.KVCache`: per block ``[1, max_len,
kv_heads, head_dim]`` keys and values, and the position counter
``index``.  This module keeps PagedAttention-style block granularity:

- **Pool** (:func:`make_pool`): every block's keys and values become
  ``[num_blocks, page_tokens, kv_heads, head_dim]``, one preallocated
  pool of fixed-size pages, allocated ONCE.  The pool holds no counter:
  lengths are host truth, and a dispatch's per-lane index tensor is set
  from them (:func:`set_counters`), which is what lets many sequences
  share one pool.
- **Block tables**: each sequence owns a padded ``[max_len //
  page_tokens]`` row of physical block ids (block 0 is a never-allocated
  sentinel; padding entries point at it).  Tables are data, never
  shapes: admission, sharing, retirement and recycling change table
  *values* only, so the two programs survive any traffic (the
  ``compile_counts() == (1, 1)`` pin).
- **Gather / scatter** (:func:`gather_cache`, :func:`cache_pages`,
  :func:`scatter_pages`): attention reads KV through the table by
  gathering the sequence's pages into a contiguous ``[1, max_len, ...]``
  view (an ``index_select`` through the table), running the model's
  decode forward, and, in prefill, scattering every page back
  (``index_copy_`` over the flattened tables).  The view is
  byte-for-byte what a dedicated ``max_len`` slot would hold, so the
  serving bit-identity contract is page-size independent.  Scatter
  indices may repeat across lanes: a shared prefix block carries the same
  bytes from every sharer (prefill starts past every shared page, so no
  sharer writes one: each hands back the bytes it gathered), and
  sentinel block 0 collects padding garbage that no live table row of a
  live position ever reads — so whichever duplicate write lands last,
  no served token can see a difference.
- **Decode working set** (:func:`make_views`, :func:`adopt_lanes`): decode
  keeps one resident view per slot, advanced in place across dispatches,
  and gathers a lane from the pool only when admission/prefill made the
  pool newer.  Decode never writes the pool — generated-suffix pages
  exist there as reserved capacity only (nothing ever reads them: the
  prefix cache shares PROMPT pages, written by prefill) — so shared
  blocks are decode-untouchable by construction, and per-token KV
  traffic in steady state is zero.

Alloc/free/refcount/residency are pure host bookkeeping
(:class:`BlockPool`); the device never sees them.  :class:`SlotManager`
(decode-lane bookkeeping): lanes are a program-shape resource, blocks a
memory resource, and the two are decoupled.  The host logic is the JAX
package's, copied.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

# The JAX decode cache's position counters (``cache_index`` of every
# block, the model's ``pos_index``): the port's cache holds them as one
# ``KVCache.index`` (``interop.cache_from_flax``), and the arena as the
# per-lane index of a dispatch, set from host lengths (:func:`set_counters`).
COUNTER_LEAVES = ("cache_index", "pos_index")


@dataclasses.dataclass
class PagedKV:
    """Per block of the model, its keys and values as pages: ``[n, page,
    kv_heads, head_dim]`` each (the pool), or ``[S, max_len, kv_heads,
    head_dim]`` (a batch of contiguous views)."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]

    def tensors(self) -> list[torch.Tensor]:
        return [*self.keys, *self.values]


def _kv_shape(model) -> tuple[int, int]:
    return model.num_kv_heads, model.head_dim


def make_pool(model, num_blocks: int, page_tokens: int,
              device=None) -> PagedKV:
    """Allocate the paged KV pool for ``model`` (a ``TransformerLM``):
    each block's keys and values as ``[num_blocks, page_tokens, Hkv,
    Dh]`` zeros in the model's dtype.  Zero-init is safe exactly as it
    was for the slotted arena: stale K/V in a recycled block is either
    causally masked (position > query) or overwritten just-in-time
    before any read."""
    hkv, dh = _kv_shape(model)

    def zeros():
        return torch.zeros(num_blocks, page_tokens, hkv, dh,
                           dtype=model.dtype, device=device)

    return PagedKV([zeros() for _ in range(model.num_layers)],
                   [zeros() for _ in range(model.num_layers)])


def gather_cache(pool: PagedKV, tables: torch.Tensor) -> PagedKV:
    """The contiguous ``[n, max_len, ...]`` views of the sequences whose
    block tables are ``tables`` (``[n, bps]`` or one ``[bps]`` row,
    int64 on the pool's device): an ``index_select`` of their pages.
    Each view is byte-for-byte the cache a dedicated ``max_len`` slot
    would have held, so the decode forward over it reduces identically:
    paging cannot move a bit."""
    rows = tables.reshape(-1, tables.shape[-1])
    flat = rows.reshape(-1)
    n = rows.shape[0]

    def view(p):
        return p.index_select(0, flat).reshape(n, -1, *p.shape[2:])

    return PagedKV([view(p) for p in pool.keys],
                   [view(p) for p in pool.values])


def cache_pages(view: PagedKV, page_tokens: int) -> PagedKV:
    """Views ``[n, max_len, ...]`` re-paged to ``[n * bps, page, ...]``,
    ready to scatter back through the same tables that gathered them."""

    def pages(t):
        return t.reshape(-1, page_tokens, *t.shape[2:])

    return PagedKV([pages(t) for t in view.keys],
                   [pages(t) for t in view.values])


def make_views(model, max_slots: int, max_len: int, device=None) -> PagedKV:
    """Allocate the decode working set: one RESIDENT contiguous
    ``[max_len, ...]`` view per slot (``[max_slots, max_len, Hkv, Dh]``
    per block), advanced in place by every decode dispatch.  A lane's
    view is (re)built from the pool — a gather through its block table
    (:func:`adopt_lanes`) — only when the pool holds newer bytes than the
    view (admission/prefill); between refreshes decode advances the views
    in place and never touches the pool, so steady-state decode pays ZERO
    gather/scatter traffic."""
    hkv, dh = _kv_shape(model)

    def zeros():
        return torch.zeros(max_slots, max_len, hkv, dh, dtype=model.dtype,
                           device=device)

    return PagedKV([zeros() for _ in range(model.num_layers)],
                   [zeros() for _ in range(model.num_layers)])


def adopt_lanes(views: PagedKV, pool: PagedKV, tables: np.ndarray,
                lanes) -> None:
    """Replace, in place, the views of the slots ``lanes`` by a fresh
    gather through their rows of ``tables`` (host ``[S, bps]``); the
    other lanes keep their resident bytes.  Called only for lanes whose
    pool bytes are newer than their view, so steady-state dispatches copy
    nothing.  An adopted view is byte-for-byte :func:`gather_cache`'s —
    the cache a dedicated slot would have held — so adoption cannot move
    a bit; it moves the copy from every dispatch to once per
    admission."""
    lanes = sorted(int(s) for s in lanes)
    if not lanes:
        return
    device = views.keys[0].device
    rows = torch.tensor(np.asarray(tables)[lanes], dtype=torch.int64,
                        device=device)
    at = torch.tensor(lanes, dtype=torch.int64, device=device)
    fresh = gather_cache(pool, rows)
    for view, new in zip(views.tensors(), fresh.tensors()):
        view.index_copy_(0, at, new)


def set_counters(index: torch.Tensor, lengths) -> torch.Tensor:
    """Write host ``lengths`` (``[S]``) into the per-lane ``index`` tensor
    a dispatch's cache reads (the counterpart of the JAX package's
    ``set_counters``: counters are host truth, rebuilt every dispatch;
    what a dispatch advances them to is never read back)."""
    index.copy_(torch.from_numpy(np.asarray(lengths, np.int64)))
    return index


def rollback_length(length: int, written: int, kept: int) -> int:
    """New true length for a slot after a speculative verify dispatch:
    the dispatch physically wrote ``written`` view positions starting at
    ``length`` (the carried last token plus the drafted window), but
    only the first ``kept`` of them hold real tokens (the carry plus
    the accepted draft prefix) — the rejected tail is rolled back by
    simply not counting it.

    This is the whole rollback, by construction of the arena: decode
    writes K/V only into the slot's PRIVATE resident view, never the
    pool, so rejected-position bytes can never reach a shared or
    copy-on-write prefix-trie page; the device counters are rebuilt from
    host lengths on every dispatch (:func:`set_counters`), so what the
    verify advanced them to is dropped;
    and the next dispatch's window starts AT the rolled-back length, so
    every rejected position is overwritten by real K/V before any
    query row can attend to it (the same just-in-time-overwrite
    argument that makes right-padded prefill sound).  Block tables are
    untouched: the request's whole-page reservation was taken at
    admission for ``prompt + max_new``, which bounds the true length
    from above no matter how speculation interleaves, so a rollback
    never vacates a page the request won't re-fill — there is nothing
    to release or re-point (:func:`check_arena` asserts the
    reservation-covers-length invariant either way)."""
    if not 1 <= kept <= written:
        raise ValueError(
            f"kept {kept} must be in [1, written={written}]"
        )
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    return int(length) + int(kept)


def check_arena(pool, tables, lengths, slot_blocks, page_tokens: int,
                resident_blocks=()) -> list:
    """Fsck-style invariant sweep over the paged arena's host
    bookkeeping; returns a list of violation strings (empty = clean).

    Checked invariants (the ones speculation's length rollback could
    corrupt if it ever touched block state):

    - the sentinel (block 0) is never allocated and never owned;
    - every block a slot owns is allocated, and its table row is
      exactly its owned blocks followed by sentinel padding;
    - each slot's whole-page reservation covers its live length
      (``ceil(length / page_tokens)`` pages) — a rolled-back length may
      strictly undershoot its reservation, never overshoot it;
    - refcount conservation: every allocated block's count equals the
      number of slot owners listing it plus its prefix-cache residency
      (``resident_blocks``), and allocated + free = pool capacity.
    """
    problems: list = []
    page = int(page_tokens)
    if pool.refcount(0) != 0:
        problems.append(f"sentinel block 0 has refcount {pool.refcount(0)}")
    holders: dict = {}
    for slot, blocks in slot_blocks.items():
        if 0 in blocks:
            problems.append(f"slot {slot} owns the sentinel block")
        for b in blocks:
            holders[b] = holders.get(b, 0) + 1
            if b != 0 and pool.refcount(b) < 1:
                problems.append(
                    f"slot {slot} owns unallocated block {b}"
                )
        row = [int(x) for x in tables[slot]]
        if row[: len(blocks)] != [int(b) for b in blocks]:
            problems.append(
                f"slot {slot} table row {row[:len(blocks)]} != owned "
                f"blocks {blocks}"
            )
        if any(x != 0 for x in row[len(blocks):]):
            problems.append(
                f"slot {slot} table padding is not all-sentinel: "
                f"{row[len(blocks):]}"
            )
        need = -(-int(lengths[slot]) // page)
        if need > len(blocks):
            problems.append(
                f"slot {slot} length {int(lengths[slot])} needs {need} "
                f"pages but owns only {len(blocks)}"
            )
    for b in resident_blocks:
        holders[b] = holders.get(b, 0) + 1
    for b, n in sorted(holders.items()):
        if b != 0 and pool.refcount(b) != n:
            problems.append(
                f"block {b} refcount {pool.refcount(b)} != {n} holders"
            )
    for b in range(1, pool.num_blocks):
        if pool.refcount(b) > 0 and b not in holders:
            problems.append(
                f"block {b} allocated (refcount {pool.refcount(b)}) "
                f"but no slot or cache holds it — leaked"
            )
    if pool.free_count + pool.used_count != pool.num_blocks - 1:
        problems.append(
            f"free {pool.free_count} + used {pool.used_count} != "
            f"capacity {pool.num_blocks - 1}"
        )
    return problems


def scatter_pages(pool: PagedKV, pages: PagedKV,
                  indices: torch.Tensor) -> None:
    """Write ``pages`` (``[n, page, ...]`` per block) into the pool at
    physical blocks ``indices`` (``[n]`` int64), in place.  Duplicate
    indices carry identical bytes for any block a live table row can read
    (module docstring), so the order of the writes cannot matter."""
    for dst, src in zip(pool.tensors(), pages.tensors()):
        dst.index_copy_(0, indices, src)


class BlockPool:
    """Host-side block allocator: free list + refcounts over
    ``num_blocks`` pool blocks, block 0 reserved as the sentinel
    (padding rows of every block table point at it; it is never
    allocated, so the garbage it collects is unreachable from live
    positions).

    Lowest-id-first allocation — deterministic, so a replayed request
    sequence lands in the same blocks.  Refcounts let the radix prefix
    cache and in-flight requests share blocks: a block returns to the
    free list only when its last holder releases it.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (sentinel + 1), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: list[int] = list(range(1, self.num_blocks))
        heapq.heapify(self._free)
        self._refs: dict[int, int] = {}  # block -> holders

    def alloc(self, n: int) -> Optional[list]:
        """Claim ``n`` blocks at refcount 1 (None = not enough free —
        all-or-nothing, so a failed admission leaks nothing)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n > len(self._free):
            return None
        blocks = [heapq.heappop(self._free) for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def retain(self, blocks) -> None:
        """Add one holder to each of ``blocks`` (sharing a resident
        prefix, or the prefix cache adopting a block)."""
        for b in blocks:
            if b not in self._refs:
                raise KeyError(f"block {b} is not allocated")
            self._refs[b] += 1

    def release(self, blocks) -> list:
        """Drop one holder from each of ``blocks``; returns the blocks
        whose count hit zero (now back on the free list)."""
        freed = []
        for b in blocks:
            if b not in self._refs:
                raise KeyError(f"block {b} is not allocated")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                heapq.heappush(self._free, b)
                freed.append(b)
        return freed

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - 1 - len(self._free)


class SlotManager:
    """Host-side alloc/free bookkeeping over ``max_slots`` decode lanes.

    Lowest-free-index-first allocation — deterministic, so a replayed
    request sequence lands in the same slots (useful when diffing two
    runs' flight records).  Freeing returns the slot's request id so
    the caller can assert it retired what it meant to.
    """

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._owner: dict[int, int] = {}  # slot -> request_id

    def alloc(self, request_id: int) -> Optional[int]:
        """Claim the lowest free slot for ``request_id`` (None = full)."""
        for slot in range(self.max_slots):
            if slot not in self._owner:
                self._owner[slot] = request_id
                return slot
        return None

    def free(self, slot: int) -> int:
        """Release ``slot``; returns the request id that held it."""
        if slot not in self._owner:
            raise KeyError(f"slot {slot} is not allocated")
        return self._owner.pop(slot)

    def owner(self, slot: int) -> Optional[int]:
        return self._owner.get(slot)

    def active_slots(self) -> list:
        return sorted(self._owner)

    @property
    def active_count(self) -> int:
        return len(self._owner)

    @property
    def free_count(self) -> int:
        return self.max_slots - len(self._owner)

    @property
    def occupancy(self) -> float:
        """Fraction of slots in use, 0.0-1.0 (the utilization gauge the
        scheduler records per iteration)."""
        return len(self._owner) / self.max_slots
