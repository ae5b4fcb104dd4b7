"""Data-parallel replica serving: one request queue, R single-device engines
(port of `repro.serving.replica`).

The mesh scheduler (`ServingEngine(mesh=)`) shards one slot batch over
devices; this is the other axis of scale-out: whole model replicas, each a
single-device `ServingEngine` with its own scheduler, fed round-robin from
one queue. Replicas share nothing at run time, so R replicas multiply
request throughput by R as long as each fits its device -- which is the
paper's deployment argument in device units: packed 1-bit weights are ~32x
smaller than their fp32 masters (`devices_needed`).

Each replica's params (placed by `.to(device)`, then frozen per replica
with `freeze=True`), cache and state live on its own device; `serve` drives
every replica's scheduler from a thread of its own, inside
`torch.cuda.device(dev)` on a card (the kernels launch on the current
device). A worker thread does not inherit the caller's grad mode,
inference mode or flush-denormal setting: it takes the caller's. A device
may repeat (two replicas on one card).

Greedy outputs equal a single engine's on the same requests (per-row
compute does not depend on the batch). Sampled requests draw from each
replica's own generator (seeded from the engine's `seed`): deterministic
for a replica assignment (round-robin by submission order), not a single
engine's draws.

Failure is an input (`serving.faults`): each worker consults the server's
`FaultPlan` at site `replica<i>` once per poll, and an armed 'death' raises
`ReplicaDead` carrying the completions it harvested. `serve` marks the
replica unhealthy and fails over: its unfinished requests go round-robin to
the survivors after an exponential backoff, for up to `failover_rounds`
rounds; greedy tokens stay those of a fault-free run. Any other worker
exception reaches the caller, health unchanged. With every replica dead (or
the rounds spent) `serve` raises `ReplicaDead` with what it collected in
`.partial`.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch._device import on_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import params_to
from repro_torch.launch.mesh import visible_devices
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan, ReplicaDead

__all__ = ["ReplicaServer", "devices_needed"]


def devices_needed(resident_bytes: int, device_budget_bytes: int) -> int:
    """Devices a tenant of `resident_bytes` needs under a per-device memory
    budget -- the unit the 32x packed shrink is spent in."""
    if device_budget_bytes <= 0:
        raise ValueError(f"budget must be > 0, got {device_budget_bytes}")
    return max(1, -(-int(resident_bytes) // int(device_budget_bytes)))


def _flushes_denormals() -> bool:
    """Whether this thread flushes float32 denormals to zero (torch has a
    setter and no getter)."""
    tiny = torch.tensor(1e-40, dtype=torch.float32)
    return float(tiny * 1.0) == 0.0


class ReplicaServer:
    """R single-device serving engines behind one queue.

    `devices`: one device per replica (default: every visible card; a
    device may repeat). Engine kwargs (`freeze`, `kv_bits`, `slots`,
    `prefill_chunk`, `page_size`, ...) apply to every replica; each
    replica holds its own copy of `params`, its own KV cache or pool and
    its own prefix tree, which is why assignment is round-robin (repeated
    prefixes land on every replica)."""

    def __init__(self, cfg: ModelConfig, params, *, devices=None,
                 fault_plan: FaultPlan | None = None,
                 failover_rounds: int = 2, backoff_s: float = 0.01,
                 **engine_kw):
        self.devices = [torch.device(d) for d in (
            devices if devices is not None else visible_devices())]
        if not self.devices:
            raise ValueError("no devices for replicas")
        if "mesh" in engine_kw:
            raise ValueError("replicas are single-device engines: use "
                             "ServingEngine(mesh=) for sharded serving")
        self.fault_plan = fault_plan
        self.failover_rounds = failover_rounds
        self.backoff_s = backoff_s
        self.health = [True] * len(self.devices)
        self.last_errors: dict[int, str] = {}
        self.failovers = 0
        self.engines = [ServingEngine(cfg, params_to(params, dev),
                                      **engine_kw) for dev in self.devices]

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def _drive(self, i: int, shard: list[Request]) -> list:
        """Drive replica i's scheduler over its requests, consulting the
        fault plan at site `replica<i>` once per poll. Returns the
        completions in order; an armed 'death' raises ReplicaDead whose
        `.partial` maps shard position -> Completion for the requests that
        finished (failover resubmits only the rest)."""
        sched = self.engines[i].scheduler()
        pos = {sched.submit(r): j for j, r in enumerate(shard)}
        done: dict = {}
        while len(done) < len(shard):
            if self.fault_plan is not None:
                for f in self.fault_plan.tick(f"replica{i}"):
                    if f.kind == "death":
                        raise ReplicaDead(
                            f"replica {i} ({self.devices[i]}) died "
                            f"(injected fault)", partial=done)
            for c in sched.poll(drain=True):
                if c.rid in pos:
                    done[pos[c.rid]] = c
        return [done[j] for j in range(len(shard))]

    def serve(self, requests: list[Request]) -> list:
        """Serve `requests` over the healthy replicas (round-robin by
        index), one scheduler thread per replica; returns the
        `Completion`s in request order, with failover as the module
        docstring says."""
        if not requests:
            raise ValueError("empty batch")
        results: dict = {}
        remaining = list(range(len(requests)))
        caller = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                  _flushes_denormals())
        for attempt in range(self.failover_rounds + 1):
            alive = [i for i, h in enumerate(self.health) if h]
            if not alive:
                break
            shards = {r: remaining[j::len(alive)]
                      for j, r in enumerate(alive)}
            outs: dict = {}
            errs: dict = {}

            def work(i: int) -> None:
                grad, inference, flush = caller
                try:
                    torch.set_flush_denormal(flush)
                    with on_device(self.devices[i]), \
                            torch.inference_mode(inference), \
                            torch.set_grad_enabled(grad):
                        outs[i] = self._drive(
                            i, [requests[g] for g in shards[i]])
                except BaseException as e:   # inspected on caller's thread
                    errs[i] = e

            threads = [threading.Thread(target=work, args=(i,), daemon=True)
                       for i in alive if shards[i]]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for e in errs.values():
                if not isinstance(e, ReplicaDead):
                    raise e              # a bug: propagate, don't fail over
            still: list[int] = []
            for i in alive:
                if i in errs:
                    self.health[i] = False
                    self.last_errors[i] = str(errs[i])
                    partial = errs[i].partial
                    for j, g in enumerate(shards[i]):
                        if j in partial:
                            results[g] = partial[j]
                        else:
                            still.append(g)
                elif shards[i]:
                    for j, g in enumerate(shards[i]):
                        results[g] = outs[i][j]
            remaining = sorted(still)
            if not remaining:
                return [results[g] for g in range(len(requests))]
            self.failovers += 1
            time.sleep(self.backoff_s * (2 ** attempt))
        raise ReplicaDead(
            f"{len(remaining)} request(s) unserved after "
            f"{self.failovers} failover round(s): "
            f"{sum(self.health)}/{self.n_replicas} replicas healthy",
            partial=results)

    def generate(self, requests: list[Request]) -> list[np.ndarray]:
        """Tokens of each request in request order (`serve`'s, failover
        and exception propagation included)."""
        return [c.tokens for c in self.serve(requests)]

    def stats(self) -> dict:
        """Aggregate and per-replica serving stats, resident bytes and
        health: which replicas are alive, why each dead one died
        (`last_errors`), and how many failover rounds ran."""
        per = []
        for i, (dev, eng) in enumerate(zip(self.devices, self.engines)):
            wb = eng.resident_weight_bytes()
            entry = {"device": str(dev), "healthy": self.health[i],
                     "weight_bytes": wb["binary"] + wb["other"],
                     "cache_bytes": eng.resident_cache_bytes()["total"]}
            if i in self.last_errors:
                entry["error"] = self.last_errors[i]
            if eng._sched is not None:
                entry["scheduler"] = dict(eng._sched.stats)
            per.append(entry)
        tokens = sum(e.get("scheduler", {}).get("tokens_out", 0)
                     for e in per)
        return {"replicas": self.n_replicas,
                "healthy": sum(self.health), "failovers": self.failovers,
                "tokens_out": tokens, "per_replica": per}
