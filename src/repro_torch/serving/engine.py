"""Serving engine over the bit-resident LM (port of the chunked-admission,
single-device part of `repro.serving.engine`).

    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=C)
    tokens = eng.generate([Request(prompt, max_new_tokens=16), ...])
    # paged 1-bit KV pool with the radix-tree prefix cache
    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=C,
                        page_size=P, prefix_cache=True)

`freeze=True` packs the fp32 masters into 1-bit `PackedWeight`s once, at
load; `kv_bits=1` keeps K/V as sign bitplanes plus a per-head V scale. Every
binarized matmul, sign-pack and attention then runs through the port's
hand-written kernels on the card (`kernel_path="auto"`), or through their
plain PyTorch versions on any device (`kernel_path="ref"`, the yardstick the
kernels are held to). A CPU tensor always runs the plain versions.

`page_size=P` keeps K/V in a pool of P-token pages shared by every slot
(`pool_pages`, default what the contiguous cache holds) and `prefix_cache`
shares full prompt pages across requests (`serving.scheduler`).

falcon-mamba-7b (`family="ssm"`) serves the same way from O(1) recurrent
state per slot, its selective scan through kernel 10:

    eng = ServingEngine(get_config("falcon-mamba-7b"), params, freeze=True,
                        prefill_chunk=C)

`kv_bits`, `page_size`, `pool_pages` and `prefix_cache` have no effect
there, as in the JAX package.

Not ported yet (ROADMAP Queue A): `generate_static`; and raising
NotImplementedError: whole-prompt admission (`prefill_chunk=None`), the
float KV cache (`kv_bits=0`), the mesh, the bounded queue and fault plans.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import params_frozen, resident_weight_bytes
from repro_torch.models.api import ATTENTION_FAMILIES, get_model
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
        if cfg.kv_bits != 1 and cfg.family in ATTENTION_FAMILIES:
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
        self.page_size, self.pool_pages = page_size, pool_pages
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

    def _cache_kw(self) -> dict:
        """init_cache's paging arguments (the scheduler's default pool);
        none for a recurrent family, whose state is never paged."""
        if self.page_size is None or \
                self.cfg.family not in ATTENTION_FAMILIES:
            return {}
        n_pages = -(-self.max_len // self.page_size)
        return {"page_size": self.page_size,
                "pool_pages": (self.pool_pages if self.pool_pages is not None
                               else self.slots * n_pages)}

    def resident_cache_bytes(self) -> dict:
        """Bytes of the slot cache (`slots` rows at `max_len`, or the page
        pool), split `packed` (int32 sign bitplanes, and int32 page tables)
        vs `float` (V scales; the Mamba stack's conv and SSM states). Computed from shapes; nothing is allocated.
        Paged, `packed` also counts each layer's sink page, and a
        `page_pool` section holds the scheduler's `page_stats()`: pages,
        allocated, free, pinned by the prefix tree, the tree's counters."""
        cache = self.model.init_cache(self.slots, self.max_len, device="meta",
                                      **self._cache_kw())
        out = {"packed": 0, "float": 0}
        for name, leaf in cache.items():
            kind = "packed" if leaf.dtype == torch.int32 else "float"
            n = leaf.numel()
            if name in ("k", "v") and "page_table" in cache:
                n += n // leaf.shape[1]              # the sink pages
            out[kind] += n * leaf.element_size()
        out["total"] = out["packed"] + out["float"]
        if self._sched is not None:
            stats = self._sched.page_stats()
            if stats is not None:
                out["page_pool"] = stats
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
