"""Fixed-size KV page pool: refcounted alloc/free under zero-copy sharing
(port of `repro.serving.pager`; numpy only, like the original).

K/V live in a pool of fixed-size pages shared by every layer -- a logical
page id addresses the same pool row in each layer's `(L, pool_pages,
page_size, Hkv, words)` leaf -- and each slot maps positions to pages
through a `(B, n_pages)` int32 page table. A packed page is ~32x smaller
than a float one (`kv_bits=1` stores sign bitplanes), so the same device
memory holds ~32x more pages, which is what makes the prefix cache over
pages (`serving.prefix_cache`) worth its bookkeeping.

This module is host-side bookkeeping over integer page ids; it never
touches device memory. Ownership model:

  * `alloc(n)` hands out n pages with refcount 1 (the caller -- a slot --
    owns one reference each). All-or-nothing: returns None if the pool
    cannot satisfy the request, so admission can evict-and-retry.
  * `incref(pages)` adds a reference (a prefix-cache hit pins shared pages
    into another slot's table -- zero copies).
  * `decref(pages)` drops one reference each and returns the page ids that
    hit zero (returned to the free list).
  * `cow(page)` is the copy-on-write primitive for a partially filled tail
    page: refcount 1 means the caller holds it exclusively and may write in
    place (returns the same id); refcount > 1 allocates a fresh page, moves
    the caller's reference onto it, and returns the new id -- the caller
    then copies the device rows before writing. The serving scheduler never
    shares partially filled pages (prefix matches are capped to full-page
    boundaries), so in serving cow() always takes the in-place path.

Invariants: refcounts never go negative, a page is free iff its refcount is
0, and no operation ever frees a page that still has a holder. `audit()`
returns violations as strings; `check()` asserts them (tests call it).
Pass `fault_plan` (`serving.faults`) to make `alloc` consult the 'alloc'
site: an armed 'exhaust' fault makes it return None exactly as if the pool
were full, which is how admission's evict-and-retry and requeue paths are
exercised deterministically.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PagePool"]


class PagePool:
    def __init__(self, n_pages: int, fault_plan=None):
        assert n_pages >= 1
        self.n_pages = n_pages
        self.refs = np.zeros((n_pages,), np.int32)
        # LIFO free stack, lowest ids on top: deterministic ids
        self._free = list(range(n_pages - 1, -1, -1))
        self.fault_plan = fault_plan

    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n fresh pages at refcount 1, or None (all-or-nothing)."""
        assert n >= 0
        if self.fault_plan is not None:
            if any(f.kind == "exhaust" for f in self.fault_plan.tick("alloc")):
                return None        # injected exhaustion: the pool is "full"
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refs[pages] += 1
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            assert self.refs[p] > 0, f"incref on free page {p}"
            self.refs[p] += 1

    def decref(self, pages) -> list[int]:
        """Drop one reference per page; return the ids that reached 0
        (now back on the free list)."""
        freed = []
        for p in pages:
            assert self.refs[p] > 0, f"decref on free page {p}"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def cow(self, page: int) -> int | None:
        """Copy-on-write prepare for writing into `page`: exclusive
        (refcount 1) -> write in place, same id back. Shared -> allocate
        a fresh page, move the caller's reference onto it, return the new
        id (caller copies device rows). None if the pool is full."""
        assert self.refs[page] > 0, f"cow on free page {page}"
        if self.refs[page] == 1:
            return page
        got = self.alloc(1)
        if got is None:
            return None
        self.refs[page] -= 1          # caller's ref moves to the copy
        return got[0]

    def audit(self) -> list[str]:
        """Pool invariants as violation strings (empty == consistent):
        refcounts non-negative, no duplicate free-list entries, and a
        page is on the free list iff its refcount is 0. The non-crashing
        twin of `check()`."""
        out = []
        if (self.refs < 0).any():
            out.append(f"negative refcounts at pages "
                       f"{np.nonzero(self.refs < 0)[0].tolist()}")
        free = set(self._free)
        if len(free) != len(self._free):
            out.append("free list holds duplicates (double-free)")
        for p in range(self.n_pages):
            if (self.refs[p] == 0) != (p in free):
                out.append(f"page {p}: refs={self.refs[p]} "
                           f"free={p in free}")
        return out

    def check(self) -> None:
        """Assert the pool invariants (tests call this after every op)."""
        violations = self.audit()
        assert not violations, "\n".join(violations)

    def stats(self) -> dict:
        return {"pages": self.n_pages, "free": len(self._free),
                "allocated": self.allocated}
