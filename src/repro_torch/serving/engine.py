"""Serving engine over the LM (port of the single-device part of
`repro.serving.engine`).

    eng = ServingEngine(cfg, params, freeze=True)     # the JAX defaults:
    tokens = eng.generate([Request(prompt, max_new_tokens=16), ...])
    # whole-prompt admission, float KV cache (kv_bits=0)
    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=C)
    # paged 1-bit KV pool with the radix-tree prefix cache
    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=C,
                        page_size=P, prefix_cache=True)
    tokens = eng.generate_static([Request(p, max_new_tokens=8), ...])
    # same-length prompts, one batched prefill then decode steps

`freeze=True` packs the fp32 masters into 1-bit `PackedWeight`s once, at
load. `kv_bits=0` (the default, as in the JAX package) keeps K/V in the
activation dtype; `kv_bits=1` keeps them as sign bitplanes plus a per-head
V scale. `prefill_chunk=None` (the default) admits each prompt whole,
`prefill_chunk=C` in chunks of C. Every binarized matmul, sign-pack, packed
attention and selective scan then runs through the port's hand-written
kernels on the card (`kernel_path="auto"`), or through their plain
PyTorch versions on any device (`kernel_path="ref"`, the yardstick the
kernels are held to); the float attention is plain PyTorch on both. A CPU
tensor always runs the plain versions.

`page_size=P` keeps K/V in a pool of P-token pages shared by every slot
(`pool_pages`, default what the contiguous cache holds; needs
`prefill_chunk`) and `prefix_cache` shares full prompt pages across
requests (`serving.scheduler`).

falcon-mamba-7b (`family="ssm"`) serves the same way from O(1) recurrent
state per slot, its selective scan through kernel 10; `kv_bits`,
`page_size`, `pool_pages` and `prefix_cache` have no effect there, as in
the JAX package. recurrentgemma-2b (`family="hybrid"`) serves from its
rec layers' state and a ring of `local_window` K/V rows per attention
layer (float, or packed at `kv_bits=1`, where decode attends through
kernel 6); `page_size`, `pool_pages` and `prefix_cache` have no effect
there, and its cache does not grow with `max_len`. llama-3.2-vision
(`family="vlm"`) serves through `generate` / `serve` with each request's
image embeddings (`Request.img_emb`, (n_img_tokens, d_vision)): their K/V
stay per slot beside the self-attention cache, and the prefix cache is off
for it, as in the JAX package.

`queue_cap` / `overflow`, `fault_plan` (`serving.faults`),
`check_invariants`, `burst_retries` and `backoff_s` pass to the scheduler
(the serving lifecycle: backpressure, deadline shedding, poison isolation,
burst retries and the invariant watchdog; `serving.scheduler`); `serve`
returns each request's `Completion` with its status. `freeze(kv_bits=1)`
switches an idle engine to the packed cache.

`mesh=` (`launch.mesh.make_serving_mesh(data, model, devices=...)`) shards
the slot batch over the mesh's 'data' axis (`serving.scheduler`; `slots`
must divide over it): tokens, greedy and sampled, are the single-device
engine's. `resident_bytes_per_device()` reports what each shard holds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import params_frozen, resident_weight_bytes
from repro_torch.models.api import ATTENTION_FAMILIES, get_model
from repro_torch.serving.sampling import sample_tokens
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
                 queue_cap: int | None = None, overflow: str = "reject",
                 fault_plan=None, check_invariants: bool | None = None,
                 burst_retries: int = 3, backoff_s: float = 0.01,
                 kernel_path: str = "auto"):
        if kv_bits is not None:
            if kv_bits not in (0, 1):
                raise ValueError(f"kv_bits must be 0 (float cache) or 1 "
                                 f"(packed sign bitplanes), got {kv_bits}")
            cfg = cfg.scaled(kv_bits=kv_bits)
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
        self.mesh = mesh
        self._sched_kw = dict(page_size=page_size, pool_pages=pool_pages,
                              prefix_cache=prefix_cache, mesh=mesh,
                              queue_cap=queue_cap, overflow=overflow,
                              fault_plan=fault_plan,
                              check_invariants=check_invariants,
                              burst_retries=burst_retries,
                              backoff_s=backoff_s)
        self.frozen = params_frozen(params)
        self._sched: Scheduler | None = None
        self._gen: torch.Generator | None = None
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}
        if freeze:
            self.freeze()
        self.scheduler()      # a bad mesh or paging argument raises now

    def freeze(self, kv_bits: int | None = None) -> "ServingEngine":
        """Freeze fp32 masters to packed 1-bit weights, in place (load-time
        quantization). `kv_bits=1` also switches the KV cache to packed
        sign bitplanes (0 back to the float cache): the model and the
        scheduler are rebuilt with the new cache, so, like freezing the
        weights, it needs an idle engine (RuntimeError with requests in
        flight). Idempotent; returns self."""
        busy = self._sched is not None and not self._sched.idle
        if not self.frozen:
            if busy:
                raise RuntimeError("cannot freeze with requests in flight — "
                                   "drain the scheduler (run()) first")
            self.params = self.model.freeze(self.params)
            self.frozen = True
            self._sched = None     # rebuild over the frozen params
        if kv_bits is not None and kv_bits != self.cfg.kv_bits:
            if kv_bits not in (0, 1):
                raise ValueError(f"kv_bits must be 0 or 1, got {kv_bits}")
            if busy:
                raise RuntimeError("cannot change kv_bits with requests in "
                                   "flight — drain the scheduler (run()) "
                                   "first")
            self.cfg = self.cfg.scaled(kv_bits=kv_bits)
            self.model = get_model(self.cfg, path=self.kernel_path)
            self._sched = None     # the cache layout changed: rebuild
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

    def kernel_routes(self) -> dict:
        """Resolved kernel routes (`kernels.tune`) for this engine's
        characteristic shapes, the JAX package's keys: the fused GEMMs at
        `slots` rows for both lhs forms (packed words after the chain's
        entry, float at it), decode attention over `max_len` (paged: over
        the slot's pages, keyed by page size and pool) and, with chunked
        admission, prefill attention over a chunk. Each value is what
        `tune.get_route` resolves: on the CPU the JAX package's table
        (every route runs the plain version there), on the card `cuda`
        and the launch's fields. Diagnostic only: dispatch resolves the
        same table per call shape."""
        from repro_torch.core.bitpack import packed_width
        from repro_torch.kernels import tune
        cfg, m, out = self.cfg, self.slots, {}
        for k, n in [(cfg.d_model, cfg.d_model), (cfg.d_model, cfg.d_ff),
                     (cfg.d_ff, cfg.d_model)]:
            if k and n:
                for pl, tag in ((1, "bits"), (0, "f32")):
                    out[f"binary_gemm_fused[{m}x{k}->{n}|{tag}]"] = \
                        tune.get_route("binary_gemm_fused", m=m, n=n,
                                       kw=packed_width(k), pl=pl)
        if cfg.n_kv_heads:
            g = max(1, cfg.n_heads // cfg.n_kv_heads)
            shape = dict(hkv=cfg.n_kv_heads, g=g, hd=cfg.head_dim)
            paged = self._cache_kw()
            if paged:
                ps = self.page_size
                t = -(-self.max_len // ps) * ps
                pool = paged["pool_pages"]
                out[f"decode_attention_paged[b{m}_t{t}_ps{ps}]"] = \
                    tune.get_route("decode_attention_paged", b=m, t=t, ps=ps,
                                   p=pool, **shape)
                if self.prefill_chunk:
                    out[f"prefill_attention_paged[b{m}"
                        f"_s{self.prefill_chunk}_t{t}_ps{ps}]"] = \
                        tune.get_route("prefill_attention_paged", b=m,
                                       s=self.prefill_chunk, t=t, ps=ps,
                                       p=pool, **shape)
            else:
                out[f"decode_attention[b{m}_t{self.max_len}]"] = \
                    tune.get_route("decode_attention", b=m, t=self.max_len,
                                   **shape)
                if self.prefill_chunk:
                    out[f"prefill_attention[b{m}_s{self.prefill_chunk}"
                        f"_t{self.max_len}]"] = tune.get_route(
                        "prefill_attention", b=m, s=self.prefill_chunk,
                        t=self.max_len, **shape)
        return out

    def resident_cache_bytes(self) -> dict:
        """Bytes of the slot cache (`slots` rows at `max_len`, or the page
        pool), split `packed` (int32 sign bitplanes, and int32 page tables)
        vs `float` (float K/V at kv_bits=0, V scales; the Mamba stack's conv
        and SSM states). Computed from shapes; nothing is allocated.
        Paged, `packed` also counts each layer's sink page, and a
        `page_pool` section holds the scheduler's `page_stats()`: pages,
        allocated, free, pinned by the prefix tree, the tree's counters."""
        out = _cache_bytes(self.model.init_cache(
            self.slots, self.max_len, device="meta", **self._cache_kw()))
        if self._sched is not None:
            stats = self._sched.page_stats()
            if stats is not None:
                out["page_pool"] = stats
        return out

    def resident_bytes_per_device(self) -> dict:
        """What each shard of the mesh holds, in bytes: {shard: {"weights",
        "cache", "state", "total"}}, keyed `"cuda:0 (data 0, model 1)"` so
        that repeated devices stay apart. A data row's 'model' 0 shard
        holds the params placed on its device (shards on one device share
        that tree), the row's cache (paged: a whole pool replica) and its
        slots' serving state; the row's other 'model' shards hold nothing,
        as the engine runs no tensor parallelism yet. Builds the scheduler
        if need be (placement happens there)."""
        if self.mesh is None:
            raise ValueError("resident_bytes_per_device needs a mesh")
        sched = self.scheduler()
        data = self.mesh.axis_names.index("data")
        out = {}
        for index in np.ndindex(*self.mesh.devices.shape):
            b = dict.fromkeys(("weights", "cache", "state"), 0)
            if not any(i for a, i in enumerate(index) if a != data):
                shard = sched._shards[index[data]]
                wb = resident_weight_bytes(shard.params)
                b = {"weights": wb["binary"] + wb["other"],
                     "cache": _cache_bytes(shard.cache)["total"],
                     "state": sum(x.numel() * x.element_size()
                                  for x in shard.state.values())}
            b["total"] = b["weights"] + b["cache"] + b["state"]
            out[self.mesh.shard_name(index)] = b
        return out

    def scheduler(self) -> Scheduler:
        """The engine's continuous-batching scheduler (built lazily). On a
        mesh the engine then serves its other paths from the first shard's
        placement of the params, as the JAX engine does."""
        if self._sched is None:
            self._sched = Scheduler(
                self.cfg, self.model, self.params, n_slots=self.slots,
                max_len=self.max_len, prefill_chunk=self.prefill_chunk,
                interleave_steps=self.interleave_steps, seed=self.seed,
                **self._sched_kw)
            if self.mesh is not None:
                self.params = self._sched.params
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

    def generate_static(self, requests: list[Request]) -> list[np.ndarray]:
        """The static batch loop: same-length prompts prefilled together in
        one batch (`Model.prefill`, a new cache of max_len, or a new
        recurrent state), then every request decoded for the batch's
        largest budget; each gets its own budget back. Greedy rows take
        the argmax; if any request samples, rows draw from the engine's
        generator (`serving.sampling`, seeded from `seed`). Tokens stay on
        the device until one transfer at the end."""
        if not requests:
            raise ValueError("empty batch")
        if self.cfg.family == "vlm":
            raise ValueError("generate_static passes no image: serve the vlm "
                             "family with generate or serve")
        lens = {len(r.prompt) for r in requests}
        if len(lens) != 1:
            raise ValueError("the static path batches same-length prompts")
        s = lens.pop()
        max_new = max(r.max_new_tokens for r in requests)
        # a KV cache holds max_len positions; a recurrent state has no cap
        if self.cfg.family in ATTENTION_FAMILIES and \
                s + max_new > self.max_len:
            raise ValueError(f"prompt ({s}) + max_new_tokens ({max_new}) "
                             f"exceeds max_len={self.max_len}")
        dev = self.params["embed"].device
        tokens = torch.from_numpy(np.stack(
            [np.asarray(r.prompt, np.int64) for r in requests])).to(dev)
        temps = torch.tensor([float(r.temperature) for r in requests],
                             dtype=torch.float32, device=dev)
        gen = None                      # greedy rows draw nothing
        if any(r.temperature > 0 for r in requests):
            if self._gen is None:
                self._gen = torch.Generator(device=dev).manual_seed(self.seed)
            gen = self._gen
        t0 = time.time()
        logits, cache = self.model.prefill(self.params, tokens,
                                           max_len=self.max_len)
        cur = sample_tokens(logits, temps, generator=gen)
        _sync(dev)
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefill_tokens"] += int(tokens.numel())
        steps = [cur]
        t0 = time.time()
        for i in range(max_new - 1):
            logits, cache = self.model.decode(self.params, cur, cache, s + i)
            cur = sample_tokens(logits, temps, generator=gen)
            steps.append(cur)
            self.stats["decode_steps"] += 1
        out = torch.stack(steps, dim=1).cpu().numpy()      # one transfer
        self.stats["decode_s"] += time.time() - t0
        return [out[j, :r.max_new_tokens].astype(np.int32)
                for j, r in enumerate(requests)]


def _cache_bytes(cache: dict) -> dict:
    """A cache's bytes, split `packed` (int32 words and page tables) vs
    `float`; a paged pool counts each layer's sink page too."""
    out = {"packed": 0, "float": 0}
    for name, leaf in cache.items():
        kind = "packed" if leaf.dtype == torch.int32 else "float"
        n = leaf.numel()
        if name in ("k", "v") and "page_table" in cache:
            n += n // leaf.shape[-4]                 # the sink pages
        out[kind] += n * leaf.element_size()
    out["total"] = out["packed"] + out["float"]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
