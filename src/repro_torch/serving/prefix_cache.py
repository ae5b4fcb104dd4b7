"""Radix-tree prefix cache over immutable full KV pages (port of
`repro.serving.prefix_cache`; numpy only, like the original).

Converts the bit-residency memory win into *hit rate*: identical system
prompts / few-shot headers across requests share their KV pages instead
of re-prefilling them. The tree is keyed by page-granular token runs —
each node owns one full page (`page_size` tokens) and its children are
the next-page continuations — so lookup walks token runs from the root
and returns the longest cached full-page prefix.

Zero-copy contract with the scheduler:

  * `lookup(tokens)` pins every matched page for the caller (one
    `PagePool.incref` per page) and returns the page ids in prefix order
    plus each node's payload (the running V-scale snapshot at that page
    boundary, `kv_bits=1`). The caller writes the ids straight into the
    new slot's page table — the pages themselves are immutable and never
    copied. A page matched by a live slot has refcount >= 2, which is
    exactly what protects it from eviction mid-flight.
  * `insert(tokens, pages, payloads)` is called at slot retirement with
    the request's prompt-region full pages. New nodes take ownership of
    the caller's reference (the returned set says which — the caller
    must NOT decref those); pages whose token run already has a node are
    left to the caller to release, deduplicating storage across requests
    that prefilled the same prefix concurrently.
  * `evict(n_needed)` frees least-recently-used *leaves* whose pages
    only the tree still references (pool refcount 1) until `n_needed`
    pages came free or nothing is evictable. Interior nodes become
    leaves as their children go, so cold chains peel back-to-front;
    pages pinned by any slot are structurally untouchable.

Host-side only, like `PagePool` — device pages move via the page tables
the scheduler maintains.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.serving.pager import PagePool

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("page", "payload", "children", "stamp")

    def __init__(self, page: int, payload: Any, stamp: int):
        self.page = page
        self.payload = payload          # e.g. v_scale snapshot at boundary
        self.children: dict[tuple, _Node] = {}
        self.stamp = stamp              # LRU clock at last touch


class PrefixCache:
    def __init__(self, pool: PagePool, page_size: int):
        assert page_size >= 1
        self.pool = pool
        self.page_size = page_size
        self.root: dict[tuple, _Node] = {}
        self._clock = 0
        self.hits = 0                   # lookups that matched >= 1 page
        self.lookups = 0
        self.evicted = 0

    # -- helpers ------------------------------------------------------------
    def _runs(self, tokens) -> list[tuple]:
        toks = np.asarray(tokens)
        n = toks.size // self.page_size
        ps = self.page_size
        return [tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                for i in range(n)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- scheduler API ------------------------------------------------------
    def lookup(self, tokens) -> tuple[list[int], list[Any]]:
        """Longest cached full-page prefix of `tokens`. Pins each matched
        page (incref) for the caller and bumps the chain's LRU stamps.
        Returns ([] , []) on a miss."""
        self.lookups += 1
        pages: list[int] = []
        payloads: list[Any] = []
        children = self.root
        for run in self._runs(tokens):
            node = children.get(run)
            if node is None:
                break
            node.stamp = self._tick()
            pages.append(node.page)
            payloads.append(node.payload)
            children = node.children
        self.pool.incref(pages)
        self.hits += bool(pages)
        return pages, payloads

    def insert(self, tokens, pages: list[int], payloads: list[Any]
               ) -> set[int]:
        """Insert the full-page prefix of `tokens` backed by `pages`
        (caller holds one reference per page). Returns the page ids whose
        reference OWNERSHIP transferred into the tree — the caller keeps
        responsibility for releasing the rest (its run already had a
        node, so the tree keeps the incumbent page)."""
        runs = self._runs(tokens)
        assert len(pages) <= len(runs) and len(pages) == len(payloads)
        taken: set[int] = set()
        children = self.root
        for run, page, payload in zip(runs, pages, payloads):
            node = children.get(run)
            if node is None:
                node = _Node(page, payload, self._tick())
                children[run] = node
                taken.add(page)
            else:
                node.stamp = self._tick()
            children = node.children
        return taken

    def evict(self, n_needed: int) -> int:
        """Free LRU evictable leaves until `n_needed` pages came free or
        none is evictable; returns pages actually freed. Evictable =
        leaf node whose page only the tree references (pool refcount 1):
        a page pinned by any slot has refcount >= 2 and is never
        touched, and interior nodes wait for their children."""
        freed = 0
        while freed < max(0, n_needed):
            victim = None            # (stamp, parent_children, run, node)
            stack = [(self.root, run, node) for run, node
                     in self.root.items()]
            while stack:
                parent, run, node = stack.pop()
                if not node.children:
                    if self.pool.refs[node.page] == 1 and \
                            (victim is None or node.stamp < victim[0]):
                        victim = (node.stamp, parent, run, node)
                else:
                    stack.extend((node.children, r, n)
                                 for r, n in node.children.items())
            if victim is None:
                break
            _, parent, run, node = victim
            del parent[run]
            freed += len(self.pool.decref([node.page]))
            self.evicted += 1
        return freed

    # -- audit API -----------------------------------------------------------
    def _nodes(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            children = stack.pop()
            for node in children.values():
                out.append(node)
                stack.append(node.children)
        return out

    def pages(self) -> list[int]:
        """Every page id the tree currently holds a reference to (one
        per node): an audit counts these against the pool's refcounts."""
        return [n.page for n in self._nodes()]

    def audit(self) -> list[str]:
        """Tree/refcount invariants as violation strings (empty ==
        consistent): every node's page is a valid pool id the pool still
        counts a reference for (the tree's own reference), and no two
        nodes claim the same page (insert moves ownership, never shares
        it)."""
        out, seen = [], set()
        for node in self._nodes():
            if not 0 <= node.page < self.pool.n_pages:
                out.append(f"tree node references out-of-range page "
                           f"{node.page}")
                continue
            if self.pool.refs[node.page] < 1:
                out.append(f"tree node references page {node.page} with "
                           f"pool refcount {int(self.pool.refs[node.page])}")
            if node.page in seen:
                out.append(f"two tree nodes claim page {node.page}")
            seen.add(node.page)
        return out

    def clear(self) -> int:
        """Drop every node and release the tree's page references: slots
        keep their own references, so in-flight requests are untouched. A
        node whose page the pool no longer counts is skipped rather than
        asserted on. Returns pages actually freed."""
        freed = 0
        for node in self._nodes():
            if 0 <= node.page < self.pool.n_pages and \
                    self.pool.refs[node.page] > 0:
                freed += len(self.pool.decref([node.page]))
        self.root = {}
        return freed

    # -- introspection ------------------------------------------------------
    @property
    def n_pages(self) -> int:
        """Pages currently pinned by the tree (== node count)."""
        n, stack = 0, [self.root]
        while stack:
            children = stack.pop()
            n += len(children)
            stack.extend(c.children for c in children.values())
        return n

    def stats(self) -> dict:
        return {"nodes": self.n_pages, "lookups": self.lookups,
                "hits": self.hits, "evicted": self.evicted}
