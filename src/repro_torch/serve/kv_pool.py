"""Paged KV-cache bookkeeping: a global page pool + per-request block tables.

The device side holds one page pool per attention layer
(``[num_pages, NK, page, H]``, see ``init_stack_cache_paged``); this
module owns the *host-side* accounting that drives it:

* a free list over page ids — **page 0 is reserved** as the write
  scratch that inactive batch rows and pad tokens redirect into, so it
  is never handed out;
* per-slot block tables (``[slots, table_width]`` int32) mapping a
  request's logical cache pages to pool pages.  Table entries beyond a
  slot's allocation stay 0 (scratch): the decode kernel masks those
  positions via ``lengths``, so stale gathers are exact no-ops;
* alloc/free at admit/evict plus on-demand growth as a request's
  position crosses a page boundary — KV memory tracks *actual* tokens,
  not the padded max length (the continuous-batching win).

Shapes are bucketed to powers of two (``ceil_pow2``), as in the JAX
package, so page accounting matches it step for step.

Own copy of ``repro/serve/kv_pool.py`` (numpy only): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def ceil_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n - 1).bit_length())


def bucket_length(n: int, cap: int) -> int:
    """Pad a prompt length to its pow2 shape bucket, clamped to ``cap``
    so the bucketed sequence still fits the engine's max length."""
    return max(1, min(ceil_pow2(n), cap)) if n < cap else cap


@dataclass
class PagePool:
    """Host-side page allocator for the paged KV cache.

    ``tables[s, i]`` is the pool page holding logical cache positions
    ``[i*page_size, (i+1)*page_size)`` of slot ``s``; 0 = unallocated
    (reads masked, writes redirected to the scratch page).
    """
    num_pages: int            # total pool pages, including scratch page 0
    page_size: int
    table_width: int          # pages per slot the tables can address
    slots: int
    tables: np.ndarray = field(init=False)
    _counts: np.ndarray = field(init=False)
    _free: list[int] = field(init=False)
    _owner: np.ndarray = field(init=False)   # page -> slot, -1 = free

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self.tables = np.zeros((self.slots, self.table_width), np.int32)
        self._counts = np.zeros((self.slots,), np.int32)
        # LIFO free list keeps recently-used pages hot
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._owner = np.full((self.num_pages,), -1, np.int32)

    # -- queries ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` cache positions."""
        return -(-int(length) // self.page_size)

    def allocated(self, slot: int) -> int:
        return int(self._counts[slot])

    # -- alloc / free -------------------------------------------------------
    def alloc(self, slot: int, n: int) -> bool:
        """Grow ``slot`` by ``n`` pages.  All-or-nothing: on exhaustion
        nothing is taken and False is returned (caller evicts/preempts).
        Raises on double-alloc — a page coming off the free list that
        some slot still owns means the free list is corrupt, and
        continuing would silently alias two requests' KV."""
        if n <= 0:
            return True
        have = int(self._counts[slot])
        if have + n > self.table_width or n > len(self._free):
            return False
        for i in range(have, have + n):
            p = self._free.pop()
            if self._owner[p] != -1:
                raise RuntimeError(
                    f"double-alloc: page {p} handed to slot {slot} but "
                    f"still owned by slot {int(self._owner[p])}")
            self._owner[p] = slot
            self.tables[slot, i] = p
        self._counts[slot] = have + n
        return True

    def ensure(self, slot: int, n_pages: int) -> bool:
        """Grow ``slot`` to at least ``n_pages`` pages."""
        return self.alloc(slot, n_pages - int(self._counts[slot]))

    def free_slot(self, slot: int) -> int:
        """Return all of ``slot``'s pages to the free list (evict).
        Freeing an empty slot is a no-op; returning a page the slot does
        not own (double-free) raises instead of corrupting the list."""
        n = int(self._counts[slot])
        for i in range(n):
            p = int(self.tables[slot, i])
            if self._owner[p] != slot:
                raise RuntimeError(
                    f"double-free: slot {slot} returning page {p} owned "
                    f"by slot {int(self._owner[p])}")
            self._owner[p] = -1
            self._free.append(p)
        self.tables[slot, :] = 0
        self._counts[slot] = 0
        return n
