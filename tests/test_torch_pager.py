"""The port's page pool and radix-tree prefix cache (`repro_torch.serving.
pager`, `repro_torch.serving.prefix_cache`, copies of the JAX package's
numpy modules): the property tests of tests/test_pager.py run against the
port's classes, and a differential test drives the JAX package's classes
and the port's with the same random sequence of alloc / incref / decref /
cow / lookup / insert / evict and holds every return value and the whole
state (refcounts, free list, tree nodes, LRU stamps, counters) equal after
each operation. Host-side bookkeeping only: all comparisons are exact."""
import numpy as np
import pytest

from repro.serving.pager import PagePool as JaxPagePool
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.serving.pager import PagePool
from repro_torch.serving.prefix_cache import PrefixCache


def test_alloc_is_all_or_nothing():
    pool = PagePool(4)
    got = pool.alloc(3)
    assert got is not None and len(got) == 3
    assert pool.alloc(2) is None          # only 1 free: nothing handed out
    assert pool.free_count() == 1
    pool.check()
    assert pool.alloc(1) is not None
    assert pool.free_count() == 0


def test_decref_returns_exactly_the_freed_pages():
    pool = PagePool(4)
    a, b = pool.alloc(2)
    pool.incref([a])                      # a: 2 refs, b: 1 ref
    assert pool.decref([a, b]) == [b]     # a survives its first decref
    assert pool.decref([a]) == [a]
    pool.check()
    assert pool.free_count() == 4


def test_cow_exclusive_in_place_shared_copies():
    pool = PagePool(3)
    (p,) = pool.alloc(1)
    assert pool.cow(p) == p               # refcount 1: write in place
    pool.incref([p])
    q = pool.cow(p)                       # shared: caller's ref moves
    assert q != p and pool.refs[p] == 1 and pool.refs[q] == 1
    pool.check()
    # shared cow with a full pool cannot allocate the copy
    pool.incref([p])
    r = pool.alloc(1)
    assert r is not None and pool.free_count() == 0
    assert pool.cow(p) is None
    pool.check()


def test_pool_refcounts_under_random_interleaving():
    """Mirror-model property test: against a dict {page: refcount} driven
    by the same random alloc/incref/decref/cow schedule, the pool must
    agree exactly, hold its invariants after every operation, and never
    free a page whose mirror refcount is positive."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        pool = PagePool(int(rng.integers(1, 12)))
        mirror: dict[int, int] = {}       # live page -> refcount
        for _ in range(300):
            op = rng.integers(0, 4)
            if op == 0:
                n = int(rng.integers(0, pool.n_pages + 2))
                got = pool.alloc(n)
                if n > pool.n_pages - len(mirror):
                    assert got is None
                else:
                    assert got is not None and len(got) == n
                    for p in got:
                        assert p not in mirror, "handed out a live page"
                        mirror[p] = 1
            elif op == 1 and mirror:
                p = int(rng.choice(list(mirror)))
                pool.incref([p])
                mirror[p] += 1
            elif op == 2 and mirror:
                k = int(rng.integers(1, len(mirror) + 1))
                pages = [int(p) for p in
                         rng.choice(list(mirror), size=k, replace=False)]
                freed = pool.decref(pages)
                expect = []
                for p in pages:
                    mirror[p] -= 1
                    if mirror[p] == 0:
                        del mirror[p]
                        expect.append(p)
                assert sorted(freed) == sorted(expect)
            elif op == 3 and mirror:
                p = int(rng.choice(list(mirror)))
                q = pool.cow(p)
                if mirror[p] == 1:
                    assert q == p
                elif q is not None:
                    assert q != p and q not in mirror
                    mirror[p] -= 1
                    mirror[q] = 1
            pool.check()
            assert {p: int(pool.refs[p]) for p in range(pool.n_pages)
                    if pool.refs[p]} == mirror


def _toks(rng, n):
    return rng.integers(0, 50, n, dtype=np.int32)


def test_prefix_lookup_pins_longest_full_page_prefix():
    pool = PagePool(16)
    tree = PrefixCache(pool, page_size=4)
    toks = np.arange(12, dtype=np.int32)
    pages = pool.alloc(3)
    taken = tree.insert(toks, pages, [None] * 3)
    assert taken == set(pages)            # fresh runs: tree took ownership

    hit, payloads = tree.lookup(np.concatenate([toks[:8], [99, 98]]))
    assert hit == pages[:2] and len(payloads) == 2
    assert all(pool.refs[p] == 2 for p in hit)     # pinned for the caller
    pool.decref(hit)

    miss, _ = tree.lookup(np.asarray([7, 7, 7, 7], np.int32))
    assert miss == []
    # a 3-token prompt has no full page to match
    short, _ = tree.lookup(toks[:3])
    assert short == []
    pool.check()


def test_insert_dedupes_against_incumbent_pages():
    """Two requests that prefilled the same prefix concurrently retire
    with different physical pages for the same token runs: the second
    insert must keep the incumbents and leave the duplicates to the
    caller, who releases them back to the pool."""
    pool = PagePool(8)
    tree = PrefixCache(pool, page_size=2)
    toks = np.asarray([1, 2, 3, 4], np.int32)
    first = pool.alloc(2)
    assert tree.insert(toks, first, [None, None]) == set(first)
    dup = pool.alloc(2)
    taken = tree.insert(toks, dup, [None, None])
    assert taken == set()
    assert pool.decref(dup) == dup        # caller releases both duplicates
    hit, _ = tree.lookup(toks)
    assert hit == first
    pool.decref(hit)
    pool.check()


def test_evict_never_touches_slot_pinned_pages():
    pool = PagePool(8)
    tree = PrefixCache(pool, page_size=2)
    a = np.asarray([1, 2, 3, 4], np.int32)
    b = np.asarray([5, 6, 7, 8], np.int32)
    tree.insert(a, pool.alloc(2), [None, None])
    tree.insert(b, pool.alloc(2), [None, None])
    pin, _ = tree.lookup(a)               # a's chain now refcount 2
    freed = tree.evict(10)                # ask for more than exists
    assert freed == 2                     # only b's chain was evictable
    assert all(pool.refs[p] == 2 for p in pin)
    again, _ = tree.lookup(a)
    assert again == pin                   # pinned chain still served
    pool.decref(pin + again)
    pool.check()


def test_evict_peels_interior_chains_back_to_front():
    pool = PagePool(8)
    tree = PrefixCache(pool, page_size=1)
    toks = np.asarray([1, 2, 3], np.int32)
    pages = pool.alloc(3)
    tree.insert(toks, pages, [None] * 3)
    assert tree.evict(1) == 1             # deepest leaf goes first
    hit, _ = tree.lookup(toks)
    assert hit == pages[:2]
    pool.decref(hit)
    assert tree.evict(2) == 2
    assert tree.n_pages == 0
    pool.check()
    assert pool.free_count() == 8


def test_tree_and_slots_interleaved_never_free_pinned(seed=0):
    """Scheduler-shaped property test: random interleaving of admissions
    (lookup + alloc), retirements (insert + decref of the rest) and
    evictions. After every step the pool invariants hold, every page a
    live slot references is still allocated, and at quiescence exactly
    the tree's nodes remain."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        pool = PagePool(12)
        tree = PrefixCache(pool, page_size=2)
        # a small universe of prompts so prefixes actually collide
        prompts = [_toks(np.random.default_rng(s), n)
                   for s, n in [(0, 6), (0, 8), (1, 6), (2, 4)]]
        slots: list[tuple[np.ndarray, list[int], int]] = []
        for _ in range(200):
            op = rng.integers(0, 3)
            if op == 0 and len(slots) < 3:
                prompt = prompts[rng.integers(0, len(prompts))]
                pinned, _ = tree.lookup(prompt)
                need = prompt.size // 2 + 1 - len(pinned)
                fresh = pool.alloc(need)
                if fresh is None and tree.evict(need - pool.free_count()):
                    fresh = pool.alloc(need)
                if fresh is None:
                    if pinned:
                        pool.decref(pinned)
                else:
                    slots.append((prompt, pinned + fresh, len(pinned)))
            elif op == 1 and slots:
                prompt, pages, _ = slots.pop(rng.integers(0, len(slots)))
                n_full = prompt.size // 2
                taken = tree.insert(prompt[:n_full * 2], pages[:n_full],
                                    [None] * n_full)
                pool.decref([p for p in pages if p not in taken])
            elif op == 2:
                tree.evict(rng.integers(0, 4))
            pool.check()
            for _, pages, _ in slots:
                assert all(pool.refs[p] >= 1 for p in pages), \
                    "a live slot's page was freed"
        for prompt, pages, _ in slots:
            pool.decref(pages)
        pool.check()
        assert pool.allocated == tree.n_pages



def test_fault_plan_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue A"):
        PagePool(4, fault_plan=object())


def _tree_state(tree) -> dict:
    def walk(children):
        return {run: (node.page, None if node.payload is None
                      else np.asarray(node.payload).tolist(), node.stamp,
                      walk(node.children))
                for run, node in children.items()}
    return {"nodes": walk(tree.root), "clock": tree._clock,
            "stats": tree.stats()}


def _pool_state(pool) -> dict:
    return {"refs": pool.refs.tolist(), "free": list(pool._free),
            "stats": pool.stats()}


@pytest.mark.parametrize("seed", range(6))
def test_same_operations_leave_equal_states(seed):
    """One random sequence of operations, applied to the JAX package's
    pool and tree and to the port's: equal return values and equal states
    after every operation. The caller's held references are tracked so
    every operation is one a scheduler could make."""
    rng = np.random.default_rng(seed)
    n_pages, ps = int(rng.integers(4, 16)), int(rng.integers(1, 4))
    pools = [JaxPagePool(n_pages), PagePool(n_pages)]
    trees = [JaxPrefixCache(pools[0], ps), PrefixCache(pools[1], ps)]
    prompts = [rng.integers(0, 6, int(rng.integers(1, 4 * ps + 3)))
               for _ in range(5)]
    held: list[int] = []               # references the caller holds
    for _ in range(400):
        op = int(rng.integers(0, 7))
        if op == 0:
            n = int(rng.integers(0, n_pages + 2))
            got = [p.alloc(n) for p in pools]
            held += got[0] or []
        elif op == 1 and held:
            page = held[int(rng.integers(0, len(held)))]
            got = [p.incref([page]) for p in pools]
            held.append(page)
        elif op == 2 and held:
            k = int(rng.integers(1, len(held) + 1))
            pick = [held[int(i)] for i in rng.choice(len(held), k,
                                                     replace=False)]
            got = [p.decref(pick) for p in pools]
            for page in pick:
                held.remove(page)
        elif op == 3 and held:
            page = held[int(rng.integers(0, len(held)))]
            got = [p.cow(page) for p in pools]
            if got[0] is not None:
                held.remove(page)
                held.append(got[0])
        elif op == 4:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            got = [t.lookup(prompt) for t in trees]
            held += got[0][0]
            got = [pages for pages, _ in got]
        elif op == 5 and held:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            # distinct pages the tree does not hold yet, as at retirement
            fresh = [p for p in dict.fromkeys(held)
                     if p not in trees[0].pages()]
            n = min(len(fresh), prompt.size // ps)
            pages = fresh[-n:] if n else []
            payloads = [rng.uniform(0, 1, 2).astype(np.float32)
                        for _ in pages]
            got = [t.insert(prompt, pages, payloads) for t in trees]
            for page in got[0]:
                held.remove(page)
        elif op == 6:
            n = int(rng.integers(0, 4))
            got = [t.evict(n) for t in trees]
        else:
            continue
        assert got[0] == got[1], (op, got)
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        assert _tree_state(trees[0]) == _tree_state(trees[1])
        pools[1].check()
        assert pools[1].audit() == [] and trees[1].audit() == []
    # the tree's pages are exactly what it holds beyond the caller's refs
    assert sorted(trees[1].pages()) == sorted(trees[0].pages())
