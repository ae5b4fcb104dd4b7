"""Deterministic fault injection and the serving path's typed errors (port
of `repro.serving.faults`; numpy only, like the original, and a copy of it:
the JAX package's `serving/__init__` imports its engine).

Failure is a first-class, tested input to the serving path: the paper's
deployment economics (32x smaller weights, XNOR+popcount arithmetic) are
worthless if one malformed request or one dead replica takes the engine
down. This module gives the stack two things:

  1. **Typed errors.** `RequestError` (malformed submission, raised at
     `Scheduler.submit` instead of deep inside a forward), `QueueFull`
     (bounded-admission backpressure under the "reject" policy),
     `TransientDeviceError` (a burst-level device fault, retried with
     backoff), `ReplicaDead` (a replica worker died; its in-flight
     requests fail over to survivors), and `InvariantViolation` (the
     watchdog found corruption it could not degrade around).

  2. **A deterministic fault plan.** `FaultPlan` is a step-indexed
     schedule the scheduler / replica server / page pool consult at
     explicit hook points ("sites"). Each `tick(site)` advances that
     site's occurrence counter and returns the faults armed for exactly
     that occurrence — so a plan is reproducible run to run, and a
     faulted run can be compared token-for-token against a fault-free
     one. `FaultPlan.random(seed, ...)` derives a schedule from a PRNG
     seed for soak-style testing; the derived indices are fixed at
     construction, so it is exactly as replayable as an explicit plan.

Sites and the fault kinds each one honors:

    site          consulted by                     kinds
    ------------  -------------------------------  ----------------------
    admit         Scheduler, per admission attempt nan (poison the first-
                                                   token logits), poison
                                                   (raise at admission)
    burst         Scheduler, per decode-burst      device_error (raise
                  attempt (retries re-tick)        TransientDeviceError),
                                                   slow (sleep param s)
    alloc         PagePool.alloc, per call         exhaust (return None)
    audit         Scheduler watchdog, per burst-   corrupt (corrupt the
                  boundary invariant audit         prefix tree first)
    replica<i>    ReplicaServer worker i, per      death (raise
                  scheduler poll                   ReplicaDead)

The `replica<i>` site and `ReplicaDead` belong to `serving.replica`'s
`ReplicaServer`; no single-device path consults them.

Spec strings (`launch/serve.py --inject-faults`) are comma-separated
`kind@site:index[*times][:param]` entries, e.g.

    device_error@burst:2*3,slow@burst:6:0.05,death@replica0:1

arms a 3-attempt device-error burst starting at burst 2, a 50 ms stall
at burst 6, and kills replica 0 at its second poll.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Fault", "FaultPlan", "parse_plan",
    "ServingError", "RequestError", "QueueFull", "TransientDeviceError",
    "InjectedFault", "ReplicaDead", "InvariantViolation",
]


# -- typed errors -----------------------------------------------------------
class ServingError(Exception):
    """Base of every typed serving-path error."""


class RequestError(ServingError, ValueError):
    """Malformed request, rejected at submit() before any device work."""


class QueueFull(ServingError):
    """Bounded admission queue at capacity under the 'reject' policy."""


class TransientDeviceError(ServingError):
    """A decode burst failed transiently; the scheduler retries with
    backoff and re-runs the burst bit-identically (state untouched)."""


class InjectedFault(ServingError):
    """A fault-plan 'poison' fired: the request it targeted retires with
    Completion.status == 'error'; every other slot is unaffected."""


class ReplicaDead(ServingError):
    """A replica worker died mid-batch. `partial` carries the
    completions it harvested before dying (by caller-side position), so
    failover resubmits only the in-flight remainder."""

    def __init__(self, msg: str, partial: dict | None = None):
        super().__init__(msg)
        self.partial = partial or {}


class InvariantViolation(ServingError):
    """The invariant watchdog found corruption that survived degradation
    (dropping the prefix tree) — the pool itself is inconsistent."""


# -- the plan ---------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault: fires at occurrences [index, index + times) of
    `site`. `param` is kind-specific (seconds for 'slow')."""
    kind: str
    site: str
    index: int
    times: int = 1
    param: float = 0.0

    def __post_init__(self):
        assert self.index >= 0 and self.times >= 1, (self.index, self.times)


class FaultPlan:
    """Step-indexed fault schedule. Hook points call `tick(site)` once
    per occurrence; the returned faults are whatever is armed for that
    exact occurrence. `fired` logs every hit as (site, occurrence, kind)
    so tests and benchmarks can assert the schedule actually ran."""

    def __init__(self, faults: list[Fault] | tuple = ()):
        self.faults = list(faults)
        self._count: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    @classmethod
    def random(cls, seed: int, rates: dict[str, float], horizon: int = 64,
               kinds: dict[str, str] | None = None) -> "FaultPlan":
        """Seeded Bernoulli schedule: for each `site -> p` in rates, every
        occurrence in [0, horizon) is armed with probability p. The draw
        happens here, once — the resulting plan is a fixed step-indexed
        schedule, replayable like any other. `kinds` maps site -> fault
        kind (default: the site's canonical kind)."""
        default_kind = {"burst": "device_error", "admit": "nan",
                        "alloc": "exhaust", "audit": "corrupt"}
        rng = np.random.default_rng(seed)
        faults = []
        for site, p in sorted(rates.items()):
            kind = (kinds or {}).get(
                site, default_kind.get(site.rstrip("0123456789"), "death"))
            for i in np.nonzero(rng.random(horizon) < p)[0]:
                faults.append(Fault(kind, site, int(i)))
        return cls(faults)

    def tick(self, site: str) -> list[Fault]:
        """Advance `site`'s occurrence counter; return the faults armed
        for the occurrence just consumed."""
        i = self._count.get(site, 0)
        self._count[site] = i + 1
        hits = [f for f in self.faults
                if f.site == site and f.index <= i < f.index + f.times]
        self.fired.extend((site, i, f.kind) for f in hits)
        return hits

    def occurrences(self, site: str) -> int:
        """How many times `site` has ticked so far."""
        return self._count.get(site, 0)


def parse_plan(spec: str) -> FaultPlan:
    """Parse a `kind@site:index[*times][:param]` comma list (see module
    docstring) into a FaultPlan. Raises ValueError on malformed entries
    — a bad --inject-faults flag should fail loudly at launch."""
    faults = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        try:
            kind, rest = entry.split("@", 1)
            site, idx, *param = rest.split(":")
            if len(param) > 1:
                raise ValueError(f"at most one :param, got {param}")
            times = 1
            if "*" in idx:
                idx, t = idx.split("*")
                times = int(t)
            faults.append(Fault(kind, site, int(idx), times,
                                float(param[0]) if param else 0.0))
        except (ValueError, AssertionError) as e:
            raise ValueError(
                f"bad fault spec entry {entry!r} "
                f"(want kind@site:index[*times][:param]): {e}") from None
    return FaultPlan(faults)
