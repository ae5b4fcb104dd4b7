"""The port's serving lifecycle and fault injection (`repro_torch.serving.
faults`, the scheduler's hooks) against the JAX package's, on the CPU:
typed submit-time validation, bounded-queue backpressure, deadline
shedding, priority, per-request poison isolation, burst retry, pool
exhaustion, the invariant watchdog's degradation, and the engine's
statuses. Each test mirrors a single-device test of tests/test_faults.py
on the same smoke qwen2-72b (2 layers, d 64, float32, kv_bits=0), served
from one numpy tree carried into both packages (`_torch_families.params`,
frozen by each package itself); every surviving request's tokens equal
the fault-free run's, bit for bit.

Parity: the fault-free tokens equal the JAX scheduler's; under the nan
plan and the drain-under-pressure plan, the port's statuses, error
strings, tokens and stats counters equal the JAX scheduler's under the
same plan (one JAX scheduler per scenario, in module fixtures);
`FaultPlan.random` gives JAX's faults for three seeds. Tokens are compared
exactly: the port runs in XLA's float mode (denormals flushed, one thread;
`test_torch_whole_prompt._flush_denormals`).

Deadlines expire by a sleep past them (deadline 1 ms, a 20 ms sleep after
the last submit), never by a 0.0-second deadline against the clock's
resolution. tests/conftest.py sets REPRO_CHECK_INVARIANTS=1, so every paged
scheduler here runs the watchdog at each burst boundary.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro.kernels import tune
from repro.models.api import get_model as jax_get_model
from repro.serving import faults as JF
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs.smoke import smoke_config
from repro_torch.models.api import get_model
from repro_torch.serving import faults as F
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import (Fault, FaultPlan, InvariantViolation,
                                        QueueFull, RequestError,
                                        TransientDeviceError, parse_plan)
from repro_torch.serving.pager import PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Scheduler

from _torch_families import params
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)

pytestmark = pytest.mark.faults

ARCH = "qwen2-72b"
TRAFFIC = [(5, 4), (11, 3), (3, 5), (8, 2)]
PRESSURE = [(5, 4), (11, 3), (3, 5), (8, 2), (13, 4), (6, 3), (9, 2)]
EXPIRED, WAIT = 0.001, 0.02          # a deadline, and a sleep past it
# the counters both schedulers keep (the port adds decode_steps, host_syncs)
COUNTERS = ("prefill_tokens", "bursts", "tokens_out", "completed",
            "max_admit_stall_tokens", "prefill_tokens_saved", "prefix_hits",
            "shed", "errors", "rejected", "burst_retries",
            "invariant_violations")


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, _, jf, _, pf = params(ARCH)
    return jcfg, cfg, jf, pf


def _requests(seed, lens_budgets, cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 128, p, dtype=np.int32),
                max_new_tokens=m, **kw) for p, m in lens_budgets]


def _sched(cfg, pf, plan=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("interleave_steps", 2)
    kw.setdefault("page_size", 4)
    return Scheduler(cfg, get_model(cfg), pf, fault_plan=plan,
                     backoff_s=0.001, **kw)


def _drain(s):
    """poll(drain=True) until idle: {rid: completion}, each rid once."""
    seen = {}
    while not s.idle:
        for c in s.poll(drain=True):
            assert c.rid not in seen, f"rid {c.rid} resolved twice"
            seen[c.rid] = c
    return seen


def _nan_plan(mod):
    return mod.FaultPlan([mod.Fault("nan", "admit", 1)])


def _pressure_plan(mod):
    return mod.FaultPlan([mod.Fault("device_error", "burst", 1),
                          mod.Fault("nan", "admit", 3),
                          mod.Fault("exhaust", "alloc", 2, times=2)])


def _pressure_requests(cls):
    reqs = _requests(0, PRESSURE, cls)
    for i in (2, 5):
        reqs[i] = dataclasses.replace(reqs[i], deadline_s=EXPIRED)
    return reqs


def _run_jax(setup, plan, reqs, **kw):
    """The JAX scheduler under `plan`: (rids, {rid: completion}, stats)."""
    jcfg, _, jf, _ = setup
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 24)
    with tune.gspmd_safe():
        s = JaxScheduler(jcfg, jax_get_model(jcfg), jf, prefill_chunk=4,
                         interleave_steps=2, page_size=4, fault_plan=plan,
                         backoff_s=0.001, **kw)
        rids = [s.submit(r) for r in reqs]
        time.sleep(WAIT)
        comps = _drain(s)
    return rids, comps, s.stats


@pytest.fixture(scope="module")
def baseline(setup):
    """Fault-free tokens of TRAFFIC: the bit-identity reference, equal to
    the JAX scheduler's."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf)
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    out = {i: comps[r].tokens for i, r in enumerate(rids)}
    jrids, jcomps, _ = _run_jax(setup, None, _requests(0, TRAFFIC,
                                                       JaxRequest))
    for i, r in enumerate(jrids):
        np.testing.assert_array_equal(out[i], np.asarray(jcomps[r].tokens))
    return out


@pytest.fixture(scope="module")
def jax_nan(setup):
    return _run_jax(setup, _nan_plan(JF), _requests(0, TRAFFIC, JaxRequest))


@pytest.fixture(scope="module")
def jax_pressure(setup):
    return _run_jax(setup, _pressure_plan(JF),
                    _pressure_requests(JaxRequest), pool_pages=12,
                    prefix_cache=True)


def _same_as_jax(rids, comps, stats, jax_run):
    jrids, jcomps, jstats = jax_run
    for r, jr in zip(rids, jrids, strict=True):
        a, b = comps[r], jcomps[jr]
        assert (a.status, a.error) == (b.status, b.error), r
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    assert {k: stats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}


# -- the plan itself ---------------------------------------------------------
def test_fault_plan_tick_windows():
    plan = FaultPlan([Fault("device_error", "burst", 2, times=3),
                      Fault("slow", "burst", 3, param=0.5)])
    kinds = [sorted(f.kind for f in plan.tick("burst")) for _ in range(7)]
    assert kinds == [[], [], ["device_error"], ["device_error", "slow"],
                     ["device_error"], [], []]
    assert plan.occurrences("burst") == 7
    assert plan.occurrences("alloc") == 0
    assert [(s, i, k) for s, i, k in plan.fired] == [
        ("burst", 2, "device_error"), ("burst", 3, "device_error"),
        ("burst", 3, "slow"), ("burst", 4, "device_error")]


def test_parse_plan_roundtrip_and_errors():
    spec = "device_error@burst:2*3, slow@burst:6:0.05,death@replica0:1"
    plan = parse_plan(spec)
    got = [(f.kind, f.site, f.index, f.times, f.param) for f in plan.faults]
    assert got == [("device_error", "burst", 2, 3, 0.0),
                   ("slow", "burst", 6, 1, 0.05),
                   ("death", "replica0", 1, 1, 0.0)]
    assert got == [dataclasses.astuple(f) for f in JF.parse_plan(spec).faults]
    for bad in ("nonsense", "kind@site", "kind@site:x", "a@b:1:2:3"):
        with pytest.raises(ValueError):
            parse_plan(bad)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_plan_is_replayable_and_jax_s(seed):
    rates = {"burst": 0.3, "alloc": 0.1, "admit": 0.05, "replica1": 0.2}
    a = FaultPlan.random(seed, rates, horizon=32)
    b = FaultPlan.random(seed, rates, horizon=32)
    assert [dataclasses.astuple(f) for f in a.faults] == \
        [dataclasses.astuple(f) for f in b.faults]
    assert [dataclasses.astuple(f) for f in a.faults] == \
        [dataclasses.astuple(f)
         for f in JF.FaultPlan.random(seed, rates, horizon=32).faults]
    assert any(f.site == "burst" for f in a.faults)


# -- submit-time validation --------------------------------------------------
@pytest.mark.parametrize("req,match", [
    (Request(prompt=np.zeros((0,), np.int32)), "non-empty"),
    (Request(prompt=np.zeros((2, 3), np.int32)), "1-D"),
    (Request(prompt=np.zeros((3,), np.float32)), "integer token ids"),
    (Request(prompt=np.full((3,), -1, np.int32)), "lie in"),
    (Request(prompt=np.zeros((30,), np.int32)), "exceeds max_len"),
    (Request(prompt=np.zeros((3,), np.int32), max_new_tokens=0),
     "max_new_tokens"),
    (Request(prompt=np.zeros((3,), np.int32), deadline_s=-1.0),
     "deadline_s"),
    (Request(prompt=np.zeros((3,), np.int32),
             img_emb=np.zeros((2, 2), np.float32)), "vlm-only"),
])
def test_submit_rejects_malformed(setup, req, match):
    _, cfg, _, pf = setup
    s = _sched(cfg, pf)
    with pytest.raises(RequestError, match=match):
        s.submit(req)
    assert s.idle                       # nothing half-admitted


def test_submit_rejects_bad_img_emb():
    import torch
    cfg = smoke_config("llama-3.2-vision-11b")
    model = get_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    s = Scheduler(cfg, model, p, n_slots=2, max_len=24)
    with pytest.raises(RequestError, match="img_emb"):
        s.submit(Request(prompt=np.zeros((3,), np.int32)))
    with pytest.raises(RequestError, match="img_emb shape"):
        s.submit(Request(prompt=np.zeros((3,), np.int32),
                         img_emb=np.zeros((1, 1), np.float32)))


def test_request_error_is_a_value_error(setup):
    """The typed hierarchy is JAX's: every error a ServingError,
    RequestError a ValueError too (callers catching ValueError work), and
    ReplicaDead carrying the partial completions."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf)
    with pytest.raises(ValueError):
        s.submit(Request(prompt=np.zeros((0,), np.int32)))
    for name in F.__all__:
        if name.endswith(("Error", "Full", "Fault", "Dead", "Violation")):
            mine, theirs = getattr(F, name), getattr(JF, name)
            assert [c.__name__ for c in mine.__mro__] == \
                [c.__name__ for c in theirs.__mro__], name
    assert F.ReplicaDead("x", {1: 2}).partial == {1: 2}
    assert F.ReplicaDead("x").partial == {}


# -- backpressure and shedding -----------------------------------------------
def test_queue_cap_reject(setup, baseline):
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, queue_cap=2, overflow="reject")
    reqs = _requests(0, TRAFFIC)
    rids = [s.submit(r) for r in reqs[:2]]
    with pytest.raises(QueueFull):
        s.submit(reqs[2])
    assert s.stats["rejected"] == 1
    comps = s.run()                     # admitted requests unaffected
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(comps[r].tokens, baseline[i])
    with pytest.raises(ValueError, match="overflow"):
        _sched(cfg, pf, queue_cap=2, overflow="drop")


def test_queue_cap_block_loses_nothing(setup, baseline):
    """'block' serves the queue down inside submit; the completions
    harvested there are buffered, not dropped."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, queue_cap=2, overflow="block")
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    assert sorted(comps) == sorted(rids)
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(comps[r].tokens, baseline[i])


def test_deadline_shed_before_prefill(setup, baseline):
    """An expired TTFT deadline sheds the request before any prefill
    compute; everything else completes bit-identically."""
    _, cfg, _, pf = setup
    reqs = _requests(0, TRAFFIC)
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=EXPIRED)
    s = _sched(cfg, pf)
    rids = [s.submit(r) for r in reqs]
    time.sleep(WAIT)
    comps = s.run()
    assert comps[rids[1]].status == "shed"
    assert comps[rids[1]].tokens.size == 0
    assert s.stats["shed"] == 1
    # the shed request's prompt never touched the prefill path
    others = sum(len(r.prompt) for i, r in enumerate(reqs) if i != 1)
    assert s.stats["prefill_tokens"] == others
    for i, r in enumerate(rids):
        if i != 1:
            np.testing.assert_array_equal(comps[r].tokens, baseline[i])


def test_priority_admits_first(setup):
    """With one slot, the high-priority request admits ahead of earlier-
    submitted default-priority ones."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, n_slots=1)
    reqs = _requests(0, TRAFFIC[:3])
    reqs[2] = dataclasses.replace(reqs[2], priority=5)
    rids = [s.submit(r) for r in reqs]
    first = None
    while first is None:
        done = s.poll()
        if done:
            first = done[0].rid
    assert first == rids[2]
    s.run()


# -- fault classes, each bit-identical for survivors -------------------------
def test_transient_burst_error_retried_bit_identical(setup, baseline):
    plan = FaultPlan([Fault("device_error", "burst", 1, times=2),
                      Fault("slow", "burst", 4, param=0.005)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan)
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    assert s.stats["burst_retries"] == 2
    assert ("burst", 4, "slow") in plan.fired
    assert all(comps[r].status == "completed" for r in rids)
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(comps[r].tokens, baseline[i])


def test_burst_retries_exhausted_raises(setup):
    plan = FaultPlan([Fault("device_error", "burst", 0, times=99)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan, burst_retries=2)
    s.submit(_requests(0, TRAFFIC[:1])[0])
    with pytest.raises(TransientDeviceError):
        s.run()
    assert s.stats["burst_retries"] == 3        # 1 + burst_retries attempts
    assert s.stats["decode_steps"] == 0         # no attempt ran a step


def test_nan_poison_isolated_to_one_request(setup, baseline, jax_nan):
    """A NaN-poisoned admission retires alone with status 'error' and no
    tokens; every co-resident slot decodes bit-identically; statuses,
    errors, tokens and counters equal the JAX scheduler's."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, _nan_plan(F))
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    time.sleep(WAIT)
    comps = _drain(s)
    statuses = [comps[r].status for r in rids]
    assert statuses.count("error") == 1 and s.stats["errors"] == 1
    bad = statuses.index("error")
    assert comps[rids[bad]].error == "non-finite logits"
    assert comps[rids[bad]].tokens.size == 0
    for i, r in enumerate(rids):
        if i != bad:
            np.testing.assert_array_equal(comps[r].tokens, baseline[i])
    s._pager.check()
    assert s._pager.allocated == 0
    _same_as_jax(rids, comps, s.stats, jax_nan)


def test_injected_poison_errors_before_admission(setup, baseline):
    plan = FaultPlan([Fault("poison", "admit", 0)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan)
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    sts = [comps[r].status for r in rids]
    assert sts.count("error") == 1
    assert comps[rids[0]].error == "injected poison fault at admission"
    for i, r in enumerate(rids):
        if comps[r].status == "completed":
            np.testing.assert_array_equal(comps[r].tokens, baseline[i])


def test_pool_exhaustion_requeues_and_recovers(setup, baseline):
    """A transient alloc failure (evict-retry also exhausted) requeues the
    admission; it completes bit-identically once pages free up."""
    plan = FaultPlan([Fault("exhaust", "alloc", 1, times=2)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan)
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    assert all(comps[r].status == "completed" for r in rids)
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(comps[r].tokens, baseline[i])
    s._pager.check()


def test_pool_exhausted_nothing_in_flight_errors_not_wedges(setup):
    """Persistent exhaustion with nothing in flight errors the request (it
    can never be satisfied) instead of wedging the loop."""
    plan = FaultPlan([Fault("exhaust", "alloc", 0, times=999)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan)
    rids = [s.submit(r) for r in _requests(0, TRAFFIC[:2])]
    comps = s.run()
    assert all(comps[r].status == "error" for r in rids)
    assert all("exhausted" in comps[r].error for r in rids)
    assert s.idle


def test_corruption_degrades_to_cache_bypass(setup, baseline):
    """An injected prefix-tree corruption trips the watchdog, which drops
    the tree (cache bypass) and keeps serving: tokens bit-identical, pool
    invariants intact, no crash."""
    plan = FaultPlan([Fault("corrupt", "audit", 1)])
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, plan, prefix_cache=True)
    assert s._use_tree
    rids = [s.submit(r) for r in _requests(0, TRAFFIC)]
    comps = s.run()
    assert s.stats["invariant_violations"] == 1
    assert not s._use_tree
    assert s.last_violations
    assert all(comps[r].status == "completed" for r in rids)
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(comps[r].tokens, baseline[i])
    assert s.audit() == []
    s._pager.check()


def test_pool_corruption_survives_degradation_raises(setup):
    """Corruption in the pool ledger itself (not the tree) cannot be
    degraded around: the watchdog raises InvariantViolation."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, prefix_cache=True)
    s.submit(_requests(0, [(5, 6)])[0])
    s.poll()                             # get a burst in flight
    s._pager.refs[0] = -1                # a simulated double free
    with pytest.raises(InvariantViolation, match="negative refcounts"):
        s.run()


def test_audit_catches_each_violation_kind(setup):
    pool = PagePool(4)
    pages = pool.alloc(2)
    assert pool.audit() == []
    pool.refs[pages[0]] = 0              # refcount says free, list disagrees
    assert any("free=False" in v for v in pool.audit())
    pool.refs[pages[0]] = 1
    pool._free.append(pool._free[0])
    assert any("duplicates" in v for v in pool.audit())

    pool = PagePool(4)
    tree = PrefixCache(pool, page_size=2)
    got = pool.alloc(1)
    tree.insert([1, 2], got, [None])
    assert tree.audit() == []
    tree.corrupt()
    assert tree.audit()
    freed = tree.clear()                 # skips the corrupt node
    assert freed == 1 and pool.audit() == []

    # the scheduler's ledger: a slot table holding a page the pool does
    # not count for it
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, check_invariants=False)
    s.submit(_requests(0, [(5, 6)])[0])
    s.poll()
    slot = next(iter(s._slot_pages))
    s._slot_pages[slot].append(s._slot_pages[slot][0])
    assert any("references held" in v for v in s.audit())


# -- drain under pressure ------------------------------------------------------
def test_drain_under_pressure_accounts_every_rid(setup, jax_pressure):
    """poll(drain=True) with a pool sized to force eviction and requeue
    pressure, slots mid-admission, an injected burst fault, expired
    deadlines and a poisoned admission: every rid resolves exactly once to
    completed / shed / error, the pool closes clean, and everything equals
    the JAX scheduler's run under the same plan."""
    _, cfg, _, pf = setup
    s = _sched(cfg, pf, _pressure_plan(F), pool_pages=12, prefix_cache=True)
    rids = [s.submit(r) for r in _pressure_requests(Request)]
    time.sleep(WAIT)
    seen = _drain(s)
    assert sorted(seen) == sorted(rids)  # exactly once each
    counts = [c.status for c in seen.values()]
    assert counts.count("shed") == 2
    assert counts.count("error") == 1
    assert counts.count("completed") == len(rids) - 3
    s._pager.check()
    assert s._pager.allocated == 0 or s._use_tree
    assert s.audit() == []
    _same_as_jax(rids, seen, s.stats, jax_pressure)


# -- engine plumbing ---------------------------------------------------------
def test_engine_serve_surfaces_statuses(setup):
    _, cfg, _, pf = setup
    plan = FaultPlan([Fault("nan", "admit", 0)])
    eng = ServingEngine(cfg, pf, max_len=24, slots=2, prefill_chunk=4,
                        fault_plan=plan)
    reqs = _requests(0, TRAFFIC[:2])
    comps = eng.serve(reqs)
    assert [c.status for c in comps] == ["error", "completed"]
    assert comps[0].tokens.size == 0     # error rows carry no tokens
    toks = eng.generate(reqs)            # plan spent: a clean rerun serves
    assert all(t.size > 0 for t in toks)

