"""Serving engine over the bit-resident LM (port of the chunked-admission,
single-device part of `repro.serving.engine`).

    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=C)
    tokens = eng.generate([Request(prompt, max_new_tokens=16), ...])

`freeze=True` packs the fp32 masters into 1-bit `PackedWeight`s once, at
load; `kv_bits=1` keeps K/V as sign bitplanes plus a per-head V scale. Every
binarized matmul, sign-pack and attention then runs through the port's
hand-written kernels on the card (`kernel_path="auto"`), or through their
plain PyTorch versions on any device (`kernel_path="ref"`, the yardstick the
kernels are held to). A CPU tensor always runs the plain versions.

Not ported yet (ROADMAP Queue A): `generate_static`; and raising
NotImplementedError: whole-prompt admission (`prefill_chunk=None`), the
float KV cache (`kv_bits=0`), the mesh, paging and the prefix cache, the
bounded queue and fault plans.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import params_frozen, resident_weight_bytes
from repro_torch.models.api import get_model
from repro_torch.serving.scheduler import (
    Completion, Request, RequestError, Scheduler,
)

__all__ = ["Completion", "Request", "RequestError", "Scheduler",
           "ServingEngine"]


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 mesh=None, freeze: bool = False, slots: int = 4,
                 seed: int = 0, kv_bits: int | None = None,
                 prefill_chunk: int | None = None,
                 interleave_steps: int = 8, page_size: int | None = None,
                 pool_pages: int | None = None, prefix_cache: bool = False,
                 queue_cap: int | None = None, fault_plan=None,
                 kernel_path: str = "auto"):
        if kv_bits is not None:
            if kv_bits not in (0, 1):
                raise ValueError(f"kv_bits must be 0 (float cache) or 1 "
                                 f"(packed sign bitplanes), got {kv_bits}")
            cfg = cfg.scaled(kv_bits=kv_bits)
        if cfg.kv_bits != 1:
            raise NotImplementedError("the float KV cache (kv_bits=0) comes "
                                      "with the next slice (ROADMAP Queue A)")
        if prefill_chunk is None:
            raise NotImplementedError("whole-prompt admission "
                                      "(prefill_chunk=None) comes with the "
                                      "next slice (ROADMAP Queue A)")
        self.cfg = cfg
        self.kernel_path = kernel_path
        self.model = get_model(cfg, path=kernel_path)
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = interleave_steps
        self._sched_kw = dict(page_size=page_size, pool_pages=pool_pages,
                              prefix_cache=prefix_cache, mesh=mesh,
                              queue_cap=queue_cap, fault_plan=fault_plan)
        self.frozen = params_frozen(params)
        self._sched: Scheduler | None = None
        if freeze:
            self.freeze()
        self.scheduler()      # raises now for what is not ported

    def freeze(self) -> "ServingEngine":
        """Freeze fp32 masters to packed 1-bit weights, in place (load-time
        quantization). Idempotent; returns self."""
        if not self.frozen:
            if self._sched is not None and not self._sched.idle:
                raise RuntimeError("cannot freeze with requests in flight — "
                                   "drain the scheduler (run()) first")
            self.params = self.model.freeze(self.params)
            self.frozen = True
            self._sched = None     # rebuild over the frozen params
        return self

    def resident_weight_bytes(self) -> dict:
        """Bytes of weights resident on the device, split binary vs other."""
        return resident_weight_bytes(self.params)

    def resident_cache_bytes(self) -> dict:
        """Bytes of the slot cache (`slots` rows at `max_len`), split
        `packed` (int32 sign bitplanes) vs `float` (V scales). Computed
        from shapes; nothing is allocated."""
        cache = self.model.init_cache(self.slots, self.max_len, device="meta")
        out = {"packed": 0, "float": 0}
        for leaf in cache.values():
            kind = "packed" if leaf.dtype == torch.int32 else "float"
            out[kind] += leaf.numel() * leaf.element_size()
        out["total"] = out["packed"] + out["float"]
        return out

    def scheduler(self) -> Scheduler:
        """The engine's continuous-batching scheduler (built lazily)."""
        if self._sched is None:
            self._sched = Scheduler(
                self.cfg, self.model, self.params, n_slots=self.slots,
                max_len=self.max_len, prefill_chunk=self.prefill_chunk,
                interleave_steps=self.interleave_steps, seed=self.seed,
                **self._sched_kw)
        return self._sched

    def serve(self, requests: list[Request]) -> list[Completion]:
        """Full `Completion`s (status, ttft, itl, ...) in request order."""
        if not requests:
            raise ValueError("empty batch")
        sched = self.scheduler()
        rids = [sched.submit(r) for r in requests]
        comps = sched.run()
        return [comps[rid] for rid in rids]

    def generate(self, requests: list[Request]) -> list[np.ndarray]:
        """Tokens of each request, in request order (ragged prompts,
        per-request budgets and eos)."""
        return [c.tokens for c in self.serve(requests)]
