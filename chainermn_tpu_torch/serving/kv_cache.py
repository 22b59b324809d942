"""Paged KV cache for the serving tier (port of
``chainermn_tpu/serving/kv_cache.py``).

The per-request KV cache is a set of fixed-size **pages** drawn from one
shared pool and addressed through a per-slot **block table**, so
requests of very different lengths share one decode step and memory is
bounded by the pool, not by ``capacity * max_len``.

* ``k_pages`` / ``v_pages`` are torch tensors ``(n_layers, num_pages,
  page_size, n_heads, d_head)`` on ``device``.  Unlike the JAX package,
  whose compiled step returns fresh arrays, the port's decode step
  writes them in place.
* Page 0 is the null page: never allocated; inactive slots' tables
  point at it, so the padded-slot step always reads and writes in
  bounds.
* The allocator is host numpy and deterministic: the free list stays
  sorted, admission reserves ``ceil(total_tokens / page_size)`` pages up
  front, so a running request never runs out of pages mid-stream.  For
  the same op stream it produces the same tables, lengths, refcounts
  and free list as the JAX package's allocator.
* Copy-on-write prefix sharing: pages carry refcounts; a prompt whose
  page-aligned prefix was registered aliases those pages, and a write
  into a still-shared page first copies it to a page reserved at
  admission (:meth:`PagedKVCache.cow_for_write`).
* Deterministic eviction: :meth:`PagedKVCache.choose_victim` names the
  most recently admitted slot whose pages are all unshared.

Not ported yet: KV export/import, ``state_dict`` round trips, delta
snapshots and ``reshard_kv_state``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device

NULL_PAGE = 0


class PrefixMatch(NamedTuple):
    """A prefix-index hit: the page run to alias at admission.

    ``pages``: the existing pages, in table order.  ``shared_len``:
    cache positions the aliasing slot starts with (capped one below the
    new prompt's length so the tail prefill always has a token).
    ``cow``: the cap landed mid-page, so the final aliased page will be
    written and a copy-on-write page is reserved at admission."""

    pages: Tuple[int, ...]
    shared_len: int
    cow: bool


def _chain_hash(prev: str, chunk: Sequence[int]) -> str:
    """Deterministic cumulative hash of page-aligned token chunks (sha1,
    not ``hash()``, so PYTHONHASHSEED cannot change a schedule)."""
    data = prev + ":" + ",".join(str(int(t)) for t in chunk)
    return hashlib.sha1(data.encode()).hexdigest()


class CacheAdmissionError(RuntimeError):
    """A request was admitted past ``can_admit``: pool or slots
    exhausted."""


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages a request occupying ``total_tokens`` cache positions needs."""
    return max(1, math.ceil(total_tokens / page_size))


class PagedKVCache:
    """The page pool, block tables, and allocator for one replica.

    ``capacity`` decode slots share ``num_pages`` pages of ``page_size``
    tokens each (page 0 reserved as the null page).  ``pages_per_slot``
    bounds one request's table row.
    """

    def __init__(self, *, n_layers: int, n_heads: int, d_head: int,
                 capacity: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 pages_per_slot: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.d_head = int(d_head)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        if pages_per_slot is None:
            pages_per_slot = 8
        self.pages_per_slot = int(pages_per_slot)
        if num_pages is None:
            # enough for every slot to hold a full-length request, + null
            num_pages = capacity * self.pages_per_slot + 1
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is null)")
        self.num_pages = int(num_pages)
        self.dtype = dtype
        shape = (self.n_layers, self.num_pages, self.page_size,
                 self.n_heads, self.d_head)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        # host-side allocator state (numpy: tables ship as step inputs)
        self.block_tables = np.full(
            (self.capacity, self.pages_per_slot), NULL_PAGE, np.int32
        )
        self.lengths = np.zeros((self.capacity,), np.int32)
        self.active = np.zeros((self.capacity,), bool)
        self._free_pages: List[int] = list(range(1, self.num_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        # admission order (slot ids, oldest first): the eviction victim
        # is found from the tail
        self._admit_order: List[int] = []
        # per-page refcounts: 0 free, 1 private, >1 prefix-shared
        self._refcounts = np.zeros((self.num_pages,), np.int32)
        # chain hash of page-aligned prompt chunks -> (page run, tokens)
        self._prefix_index: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        # per-slot page reserved at a capped alias-admission for the
        # copy-on-write into the final shared page
        self._cow_reserve: Dict[int, int] = {}

    # -- pool accounting ------------------------------------------------
    @property
    def used_pages(self) -> int:
        """DISTINCT pages currently allocated (a prefix-shared page
        counts once)."""
        return self.num_pages - 1 - len(self._free_pages)

    @property
    def free_slots(self) -> List[int]:
        return [s for s in range(self.capacity) if not self.active[s]]

    def check_invariants(self) -> None:
        """Allocator invariants: refcounts match table ownership, the
        null page is never owned, distinct owned + CoW reserves + free
        == pool, the free list is sorted, tables agree with ownership,
        the prefix index names only live pages, and the eviction victim
        holds no shared page."""
        owner_count: Dict[int, int] = {}
        for slot, pages in self._slot_pages.items():
            assert self.active[slot], f"slot {slot} owns pages inactive"
            assert NULL_PAGE not in pages, "null page allocated"
            assert len(set(pages)) == len(pages), "page twice in a slot"
            assert list(self.block_tables[slot][: len(pages)]) == pages
            for p in pages:
                owner_count[p] = owner_count.get(p, 0) + 1
        reserved = set(self._cow_reserve.values())
        assert len(reserved) == len(self._cow_reserve)
        for slot, p in self._cow_reserve.items():
            assert slot in self._slot_pages, "CoW reserve w/o slot"
            assert p != NULL_PAGE and p not in owner_count
            assert int(self._refcounts[p]) == 1
        for p, n in owner_count.items():
            assert int(self._refcounts[p]) == n, f"refcount drift: {p}"
        free = set(self._free_pages)
        assert not free & set(owner_count), "free page owned"
        assert not free & reserved, "free page reserved"
        assert all(int(self._refcounts[p]) == 0 for p in free)
        assert (len(owner_count) + len(reserved) + len(free)
                == self.num_pages - 1)
        assert self._free_pages == sorted(self._free_pages)
        assert sorted(self._admit_order) == sorted(self._slot_pages)
        victim = self.choose_victim()
        if victim is not None:
            assert all(int(self._refcounts[p]) == 1
                       for p in self._slot_pages[victim]), \
                "eviction victim holds a shared page"
        for pages, ntok in self._prefix_index.values():
            assert ntok % self.page_size == 0
            assert len(pages) == ntok // self.page_size
            assert all(int(self._refcounts[p]) >= 1 for p in pages), \
                "prefix index names a freed page"

    # -- prefix index ---------------------------------------------------
    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Index ``slot``'s page-aligned prompt prefixes for later
        sharing (call after the prompt is prefilled).  First
        registration of a chain wins; returns the number of new
        entries."""
        if slot not in self._slot_pages:
            raise KeyError(f"slot {slot} owns no pages")
        tokens = [int(t) for t in tokens]
        pages = self._slot_pages[slot]
        added, h = 0, ""
        for m in range(1, len(tokens) // self.page_size + 1):
            h = _chain_hash(
                h, tokens[(m - 1) * self.page_size: m * self.page_size]
            )
            if h not in self._prefix_index:
                self._prefix_index[h] = (
                    tuple(pages[:m]), m * self.page_size
                )
                added += 1
        return added

    def lookup_prefix(self, tokens: Sequence[int]) -> Optional[PrefixMatch]:
        """Longest indexed page-aligned prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so the tail prefill always has a token."""
        tokens = [int(t) for t in tokens]
        if len(tokens) < 2 or not self._prefix_index:
            return None
        best, h = None, ""
        for m in range(1, len(tokens) // self.page_size + 1):
            h = _chain_hash(
                h, tokens[(m - 1) * self.page_size: m * self.page_size]
            )
            hit = self._prefix_index.get(h)
            if hit is None:
                break
            best = hit
        if best is None:
            return None
        pages, ntok = best
        shared_len = min(ntok, len(tokens) - 1)
        return PrefixMatch(tuple(pages), shared_len,
                           shared_len % self.page_size != 0)

    def _drop_index_entries(self, freed: Sequence[int]) -> None:
        gone = set(freed)
        if not gone:
            return
        self._prefix_index = {
            h: e for h, e in self._prefix_index.items()
            if not gone & set(e[0])
        }

    # -- admission ------------------------------------------------------
    def can_admit(self, total_tokens: int,
                  prefix: Optional[PrefixMatch] = None) -> bool:
        need = pages_needed(total_tokens, self.page_size)
        if need > self.pages_per_slot:
            return False
        if prefix is not None:
            need = need - len(prefix.pages) + (1 if prefix.cow else 0)
        return bool(self.free_slots) and need <= len(self._free_pages)

    def admit(self, total_tokens: int,
              prefix: Optional[PrefixMatch] = None,
              slot: Optional[int] = None) -> int:
        """Reserve a slot and its pages; returns the slot id.  The
        lowest free slot (or the given free ``slot``) and the lowest
        free pages are taken.  With ``prefix``, the table aliases the
        matched pages, only the tail is freshly allocated, ``lengths``
        starts at the shared length, and a capped match earmarks one
        copy-on-write page."""
        need = pages_needed(total_tokens, self.page_size)
        if need > self.pages_per_slot:
            raise CacheAdmissionError(
                f"request needs {need} pages > pages_per_slot="
                f"{self.pages_per_slot} (total_tokens={total_tokens})"
            )
        free = self.free_slots
        if not free:
            raise CacheAdmissionError("no free decode slot")
        if slot is not None:
            if slot not in free:
                raise CacheAdmissionError(f"slot {slot} is not free")
            free = [int(slot)]
        shared: List[int] = []
        shared_len = 0
        reserve: Optional[int] = None
        if prefix is not None:
            shared = list(prefix.pages)
            shared_len = int(prefix.shared_len)
            if shared_len >= total_tokens or len(shared) > need:
                raise CacheAdmissionError(
                    f"prefix ({len(shared)} pages / {shared_len} "
                    f"tokens) does not fit total_tokens={total_tokens}"
                )
            if any(int(self._refcounts[p]) < 1 for p in shared):
                raise CacheAdmissionError(
                    "stale prefix: an aliased page was freed"
                )
        n_fresh = need - len(shared)
        n_take = n_fresh + (1 if prefix is not None and prefix.cow else 0)
        if n_take > len(self._free_pages):
            raise CacheAdmissionError(
                f"need {n_take} pages, {len(self._free_pages)} free"
            )
        slot = free[0]
        fresh = self._free_pages[:n_fresh]
        if prefix is not None and prefix.cow:
            reserve = self._free_pages[n_fresh]
        self._free_pages = self._free_pages[n_take:]
        pages = shared + fresh
        for p in shared:
            self._refcounts[p] += 1
        for p in fresh:
            self._refcounts[p] = 1
        if reserve is not None:
            self._cow_reserve[slot] = reserve
            self._refcounts[reserve] = 1
        self._slot_pages[slot] = pages
        self.block_tables[slot, :] = NULL_PAGE
        self.block_tables[slot, : len(pages)] = pages
        self.lengths[slot] = shared_len
        self.active[slot] = True
        self._admit_order.append(slot)
        return slot

    def release(self, slot: int) -> None:
        """Decrement the slot's pages; return refcount-0 pages (and the
        slot's unspent CoW reserve) to the pool, dropping prefix-index
        entries that name a freed page."""
        if not self.active[slot]:
            raise KeyError(f"slot {slot} is not active")
        pages = self._slot_pages.pop(slot)
        freed: List[int] = []
        for p in pages:
            self._refcounts[p] -= 1
            if int(self._refcounts[p]) == 0:
                freed.append(p)
        reserve = self._cow_reserve.pop(slot, None)
        if reserve is not None:
            self._refcounts[reserve] = 0
            freed.append(reserve)
        self._free_pages = sorted(self._free_pages + freed)
        self._drop_index_entries(freed)
        self.block_tables[slot, :] = NULL_PAGE
        self.lengths[slot] = 0
        self.active[slot] = False
        self._admit_order.remove(slot)

    def choose_victim(self) -> Optional[int]:
        """The most recently admitted active slot whose pages are all
        unshared; ``None`` when every active slot holds a shared page."""
        for slot in reversed(self._admit_order):
            if all(int(self._refcounts[p]) == 1
                   for p in self._slot_pages[slot]):
                return slot
        return None

    def evict(self, slot: int) -> None:
        """Same pool effect as :meth:`release`; named separately so the
        batcher distinguishes retire from preempt."""
        self.release(slot)

    def cow_for_write(self, slot: int, n: int = 1) -> bool:
        """Call BEFORE a step writes ``n`` cache positions at
        ``lengths[slot]``: a written position in a refcount>1 page gets
        that page copied into the slot's reserve, the table entry
        swapped to the copy, and the original's refcount dropped.
        Returns True if a copy happened."""
        if not self.active[slot]:
            raise KeyError(f"slot {slot} is not active")
        pages = self._slot_pages[slot]
        start = int(self.lengths[slot])
        first_pg = start // self.page_size
        last_pg = min((start + int(n) - 1) // self.page_size,
                      len(pages) - 1)
        copied = False
        for i in range(first_pg, last_pg + 1):
            p = pages[i]
            if int(self._refcounts[p]) <= 1:
                continue
            q = self._cow_reserve.pop(slot, None)
            if q is None:
                raise CacheAdmissionError(
                    f"slot {slot} must write shared page {p} but holds "
                    "no CoW reserve"
                )
            self.k_pages[:, q] = self.k_pages[:, p]
            self.v_pages[:, q] = self.v_pages[:, p]
            pages[i] = q
            self.block_tables[slot, i] = q
            self._refcounts[p] -= 1
            copied = True
        return copied

    def advance(self, slot: int, n: int = 1) -> None:
        """Account ``n`` more cache positions written for ``slot``.
        Tripwire: the written range must not cover a still-shared page."""
        if not self.active[slot]:
            raise KeyError(f"slot {slot} is not active")
        old = int(self.lengths[slot])
        new = old + n
        pages = self._slot_pages[slot]
        if new > len(pages) * self.page_size:
            raise CacheAdmissionError(
                f"slot {slot} advanced past its {len(pages)}"
                f"-page reservation ({new} tokens)"
            )
        for i in range(old // self.page_size,
                       (max(new - 1, old)) // self.page_size + 1):
            if int(self._refcounts[pages[i]]) > 1:
                raise CacheAdmissionError(
                    f"slot {slot} wrote into shared page {pages[i]} "
                    "without copy-on-write"
                )
        self.lengths[slot] = new

    # -- tensors for the step ------------------------------------------
    def tables_array(self) -> torch.Tensor:
        return torch.tensor(self.block_tables, device=self.device)

    def lengths_array(self) -> torch.Tensor:
        return torch.tensor(self.lengths, device=self.device)

    def set_pages(self, k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
        """Install replacement page tensors (the engine's steps write
        the pool in place and do not need this)."""
        self.k_pages, self.v_pages = k_pages, v_pages
