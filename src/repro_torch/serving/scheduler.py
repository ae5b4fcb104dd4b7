"""Continuous-batching scheduler: fixed decode slots over a request queue
(port of the single-device subset of `repro.serving.scheduler`: whole-prompt
or chunked admission, contiguous or paged cache, with the prefix cache).

Admission is whole-prompt by default (`prefill_chunk=None`, the JAX
package's default): `Model.prefill` runs the request's prompt at batch 1
straight into its slot's cache rows, in place, and samples its first
token; in-flight slots stall for the whole prefill, and `prefill_shape_
count` grows with every new prompt length (("whole", S)), as in the JAX
package. Chunked admission (`prefill_chunk=C`): a prompt advances through
its slot's cache row one fixed-shape (1, C) chunk per poll, through
`Model.prefill_chunk` (K/V rows and, packed, the running V scale land
incrementally). Between chunks the scheduler runs a decode burst bounded
to `interleave_steps`, so admitting a long prompt does not freeze the
running slots. Rows mid-admission decode with a pos = -1 sentinel: they
compute but write nothing, so a burst cannot corrupt a partially prefilled
row.

Decode: one step advances every slot together (per-slot position,
temperature and eos). Slot state and output tokens live on the device; the
host reads one flag per step -- whether the burst should stop (a slot
finished, or none is active) -- and reads it one step late, after the next
step is already queued, so the device never waits on the host between
steps. That extra step is harmless where each row's compute is its own: a
finished row is inactive and writes nothing, and an active row only gets
its next token early. The MoE family is the exception (below): there the
host reads each step's flag before it queues the next, so every step runs
on the slot batch the JAX package's burst would give it. A freed slot is
recycled to the next queued request at the next poll. Completions carry
`ttft` (the request's own admission compute, device-synced), `ttft_wall`,
`latency` and burst-granularity inter-token intervals `itl`, as in the JAX
package.

Paged mode (`page_size=P`, attention families only, with `prefill_chunk`:
paged caches fill through chunked admission, a ValueError otherwise where
the JAX scheduler asserts): the cache's K/V are pools of P-token pages
shared by every slot plus a per-slot page table (`models.transformer`).
Pages are refcounted (`serving.pager.PagePool`) and allocated at admission
for every position the request can reach, evicting cold prefix-tree pages
when the pool is short; a request the pool cannot take yet waits in its
place in the queue. With `prefix_cache=True` a radix tree over retired,
immutable full prompt pages (`serving.prefix_cache.PrefixCache`) lets
admission pin the longest cached full-page prefix (capped below the whole
prompt) into the new slot's table with no copy: prefill runs only for the
unseen suffix, the slot's running V scale is restored from the snapshot
taken at that page boundary (hence `page_size % prefill_chunk == 0`), and
`Completion.cached_tokens` counts the pinned tokens (`ttft` charges only
the suffix). Retirement offers the request's full prompt pages to the tree.
Paging changes addressing only: tokens equal the contiguous cache's. The
vlm family pages its self-attention K/V but never shares them (the prefix
tree is off for it, as in the JAX scheduler: its image embeddings condition
every K/V row, so equal token prefixes do not mean equal pages); its image
K/V stay per slot. The
Mamba stack (`ssm`) keeps O(1) recurrent state per slot, and the hybrid
(`hybrid`) that and a ring of `local_window` K/V rows per attention layer:
`page_size`, `pool_pages` and `prefix_cache` are ignored for them, as in
the JAX package. A request is still capped at `max_len` positions (its
token buffer), as there.

Greedy outputs do not depend on the batch's composition for any family
whose rows compute independently. The MoE family under expert-capacity
pressure is the exception, as in the JAX package: capacity-based dispatch
drops routes by a batch-global count (`models.common.moe_ffn`), so slot
neighbours can evict each other's expert assignments, the inactive rows of
a decode step (which run on their last token at pos -1) take capacity as
the active ones do, and a padded final chunk adds its pad rows to the same
count. The port feeds the router the rows the JAX scheduler feeds it: the
whole slot batch at every decode step, a chunk with its pad rows, a
whole prompt at batch 1 with exactly its rows.

Sampling (temperature > 0) draws Gumbel noise from one generator seeded
from the engine (`serving.sampling`): greedy outputs are the JAX package's,
sampled ones are not its draws.

Resilience (`serving.faults`), as in the JAX package: `submit` validates a
request up front and raises a typed `RequestError`; a bounded admission
queue (`queue_cap`) applies backpressure -- `submit` raises `QueueFull`
(`overflow="reject"`) or serves until the queue has room
(`overflow="block"`; what completes meanwhile is delivered by the next
`poll`); a request whose `deadline_s` (TTFT, from submit) passed while it
was queued is shed at admission, before any prefill (`Completion.status ==
"shed"`); a poisoned request -- non-finite logits, an injected admission
fault, or pages the pool can never give it -- retires alone with status
"error" while every other slot decodes as it would have. A `FaultPlan`
fires faults at the hook sites by occurrence, as the JAX scheduler ticks
them, so one plan fires the same faults in both packages: 'admit' once per
admission attempt ('nan' adds NaN to that admission's first-token logits,
'poison' errors it before it takes a slot), 'burst' once per decode-burst
attempt, before its first step is queued ('slow' sleeps, 'device_error'
raises `TransientDeviceError`, retried `burst_retries` times with backoff:
no step of the failed attempt ran, so the retry is bit-identical), 'alloc'
in the page pool ('exhaust'), and 'audit' in the invariant watchdog
('corrupt' grafts a bad prefix-tree node). The watchdog (`check_invariants`,
default `REPRO_CHECK_INVARIANTS == "1"`) audits the pool, the tree and the
refcount ledger (`audit()`) at burst boundaries; on a violation it drops
the prefix tree (cache bypass) and raises `InvariantViolation` only if the
ledger is still inconsistent.

Whole-prompt admission writes the slot's K/V rows past the prompt too (the
float cache's are zeroed, as the JAX scheduler overwrites the slot's whole
row): rows the last occupant left are masked by length, but a masked row's
softmax weight 0 times a non-finite V is NaN.

The mesh (`mesh=`, a `launch.mesh.Mesh` with a 'data' axis; the JAX
scheduler's `_init_mesh` and `_sharded_burst`): the slots split into
contiguous blocks, one per 'data' shard (as `P("data")` on the batch axis
gives; `n_slots` must divide, else ValueError). Each shard holds its rows of
the slot state and of every cache leaf (along `cache_batch_axes`), the
params placed on its device (`.to(device)`: on a repeated device the same
tensors), and, paged, its own replica of the page pools. One process steps
through the shards in turn, each on its own device. Admission runs at batch
1 on the owning shard through the route table, as on one device (the JAX
package pins its admission to plain XLA because `pallas_call` is opaque to
GSPMD; a shard's operands here are whole tensors on one device, so nothing
needs that pin); a decode step runs every shard's model on its own rows,
so a MoE router sees exactly its shard's rows, as under JAX's `shard_map`.
The shards run in lockstep: one stop flag over every row (JAX's per-device
loops may stop apart, which moves burst boundaries and never tokens), and
a step's Gumbel noise drawn once for the whole slot batch and split by
rows, so greedy and sampled tokens are the single-device scheduler's. A
write to a replicated pool reaches every replica before any shard reads
it: after each admission chunk its pages, and after each burst the running
slots' decode pages, are copied from the writing shard to the others
(JAX's exact masked `psum`), so a prefix-cache hit may pin pages another
shard wrote. A data row's tensors live on its 'model' 0 device only: the
engine does not split its layers over 'model' yet (tensor parallelism is
the `kernels.sharded` wrappers, ROADMAP Queue A item 6c), so the other
'model' devices hold nothing of it. The fault sites tick once per event,
as on one device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch._device import on_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import params_to
from repro_torch.models.api import (ATTENTION_FAMILIES, PAGED, Model,
                                    cache_batch_axes)
from repro_torch.serving.faults import (FaultPlan, InvariantViolation,
                                        QueueFull, RequestError,
                                        TransientDeviceError)
from repro_torch.serving.pager import PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import gumbel_noise, sample_tokens


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 => greedy
    eos_id: int | None = None    # stop early when this token is sampled
    img_emb: np.ndarray | None = None   # vlm only: (n_img_tokens, d_vision)
    # TTFT deadline in seconds from submit: a request still queued when it
    # expires is shed at admission instead of taking prefill compute
    deadline_s: float | None = None
    priority: int = 0            # higher admits first; ties go by rid


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray           # includes the eos token, if one was sampled
    latency: float               # seconds, submit -> harvest
    ttft: float = 0.0            # seconds of the request's own admission
    ttft_wall: float = 0.0       # seconds, submit -> first token
    cached_tokens: int = 0       # prompt tokens served from the prefix cache
    itl: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    # how the rid resolved, exactly once: "completed", "shed" (its deadline
    # passed before admission; no compute spent) or "error" (non-finite
    # logits, an injected admission fault, or a page pool that cannot take
    # the request with nothing in flight)
    status: str = "completed"
    error: str | None = None


@dataclasses.dataclass
class _Running:
    rid: int
    prompt_len: int
    prompt: np.ndarray | None = None   # kept only for prefix-tree insertion


@dataclasses.dataclass
class _Shard:
    """One 'data' shard of the slot batch: slots [lo, lo + rows), their
    state and cache rows (paged: and a replica of the pools), and the
    params, all on `device`."""
    device: torch.device
    params: Any
    lo: int
    rows: int
    state: dict
    cache: dict


@dataclasses.dataclass
class _Admission:
    slot: int
    rid: int
    req: Request
    n_chunks: int
    next: int = 0
    start: int = 0      # prompt tokens served from the prefix cache
    poison: float = 0.0  # injected NaN added to the first-token logits


class Scheduler:
    """Admits requests from a queue into `n_slots` decode slots.

    submit(request) -> rid; poll() runs one admit/decode/harvest round and
    returns the newly completed requests; run() polls until idle and
    returns {rid: Completion}."""

    def __init__(self, cfg: ModelConfig, model: Model, params, *,
                 n_slots: int = 4, max_len: int = 512,
                 prefill_chunk: int | None = None, interleave_steps: int = 8,
                 seed: int = 0, page_size: int | None = None,
                 pool_pages: int | None = None, prefix_cache: bool = False,
                 mesh=None, queue_cap: int | None = None,
                 overflow: str = "reject",
                 fault_plan: FaultPlan | None = None,
                 check_invariants: bool | None = None,
                 burst_retries: int = 3, backoff_s: float = 0.01):
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError(f"a serving mesh needs a 'data' axis, got "
                             f"{mesh.axis_names}")
        dp = 1 if mesh is None else mesh.shape["data"]
        if n_slots % dp:
            raise ValueError(f"n_slots={n_slots} must divide over the data "
                             f"axis ({dp})")
        if (prefill_chunk is not None and prefill_chunk < 1) \
                or interleave_steps < 0:
            raise ValueError("prefill_chunk >= 1 (or None: whole-prompt "
                             "admission) and interleave_steps >= 0")
        if overflow not in ("reject", "block"):
            raise ValueError(f"overflow must be 'reject' or 'block', got "
                             f"{overflow!r}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.queue_cap, self.overflow = queue_cap, overflow
        self._faults = fault_plan
        self.burst_retries, self.backoff_s = burst_retries, backoff_s
        # the invariant watchdog: an explicit argument wins, else the
        # environment's switch (the test suite sets it)
        self._check_inv = (check_invariants if check_invariants is not None
                           else os.environ.get("REPRO_CHECK_INVARIANTS") == "1")
        self.last_violations: list[str] = []
        # completions harvested inside a blocking submit, delivered by the
        # next poll()
        self._done_buf: list[Completion] = []
        # paging, the prefix cache and the V scale apply to the attention
        # families only: a recurrent family's state is O(1) per slot and
        # stays slot-resident, so page_size, pool_pages and prefix_cache
        # are ignored there, as in the JAX scheduler
        attn_fam = cfg.family in ATTENTION_FAMILIES
        self._paged = page_size is not None and attn_fam
        cache_kw = {}
        if self._paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if prefill_chunk is None:
                raise ValueError("paged KV fills through chunked admission "
                                 "-- pass prefill_chunk")
            self.page_size = page_size
            self.n_pages = -(-max_len // page_size)
            self.pool_pages = (pool_pages if pool_pages is not None
                               else n_slots * self.n_pages)
            cache_kw = {"page_size": page_size, "pool_pages": self.pool_pages}
            self._pager = PagePool(self.pool_pages, fault_plan=fault_plan)
            self._slot_pages: dict[int, list[int]] = {}
        elif pool_pages is not None and attn_fam:
            raise ValueError("pool_pages needs the paged cache -- pass "
                             "page_size")
        if prefix_cache and not self._paged and attn_fam:
            raise ValueError("prefix_cache needs the paged cache -- pass "
                             "page_size")
        # equal token prefixes do not mean equal pages for the vlm family:
        # its image conditions every K/V row (its pools are paged, never
        # shared)
        self._use_tree = bool(prefix_cache) and self._paged and \
            cfg.family != "vlm"
        if self._use_tree:
            # running V-scale snapshots are taken at chunk ends, so page
            # boundaries must land on chunk ends to be insertable
            if cfg.kv_bits == 1 and page_size % prefill_chunk:
                raise ValueError(
                    f"prefix_cache with kv_bits=1 needs page_size divisible "
                    f"by prefill_chunk ({page_size} % {prefill_chunk})")
            self._ptree = PrefixCache(self._pager, page_size)
        self._needs_vs = cfg.kv_bits == 1 and attn_fam
        self.cfg, self.model = cfg, model
        self.n_slots, self.max_len = n_slots, max_len
        self.max_out = max_len
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = interleave_steps
        # MoE rows share expert capacity: a step queued ahead of the host's
        # read of the stop flag would run on another batch than JAX's burst
        self._flag_lag = not cfg.n_experts
        if mesh is None:
            devices = [params["embed"].device]   # the model's device
            placed = {devices[0]: params}
        else:
            devices = [mesh.device(data=d) for d in range(dp)]
            # the params on every data shard's device (one tree per
            # distinct device); nothing runs on the other 'model' devices
            placed = {dev: params_to(params, dev)
                      for dev in dict.fromkeys(devices)}
        self.device = devices[0]       # the noise generator's device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        self._queue: deque[tuple[int, Request]] = deque()
        self._free = list(range(n_slots))
        self._running: dict[int, _Running] = {}
        self._admitting: deque[_Admission] = deque()
        self._temps: dict[int, float] = {}     # slot -> temperature (host)
        self._submit_time: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._ttft_wall: dict[int, float] = {}
        self._req_prefill_s: dict[int, float] = {}
        self._cached_tokens: dict[int, int] = {}
        # rid -> {page boundary: that layer-stack's V scales (L, Hkv)}
        self._vs_snaps: dict[int, dict[int, torch.Tensor | None]] = {}
        self._itl: dict[int, list] = {}
        self._slot_last_tok: dict[int, float] = {}
        self._prev_out_len = np.zeros((n_slots,), np.int64)
        self._prefill_shapes: set = set()
        self.stats = {"prefill_tokens": 0, "prefill_s": 0.0, "bursts": 0,
                      "decode_s": 0.0, "tokens_out": 0, "completed": 0,
                      "max_admit_stall_tokens": 0, "errors": 0,
                      "decode_steps": 0, "host_syncs": 0,
                      "prefill_tokens_saved": 0, "prefix_hits": 0,
                      "shed": 0, "rejected": 0, "burst_retries": 0,
                      "invariant_violations": 0}

        rows = n_slots // dp
        self._rows = rows
        self._shards = [
            _Shard(dev, placed[dev], d * rows, rows,
                   self._new_state(rows, dev),
                   model.init_cache(rows, max_len, device=dev, **cache_kw))
            for d, dev in enumerate(devices)]
        # the pool leaves a shard's write must reach every replica of
        self._pools = [] if dp == 1 or not self._paged else \
            [name for name, ax in cache_batch_axes(model, max_len,
                                                   **cache_kw).items()
             if ax == PAGED]

    def _new_state(self, n: int, device: torch.device) -> dict:
        z = dict(dtype=torch.int32, device=device)
        return {
            "cur": torch.zeros((n,), **z),
            "pos": torch.zeros((n,), **z),
            "active": torch.zeros((n,), dtype=torch.bool, device=device),
            "out_len": torch.zeros((n,), **z),
            "budget": torch.ones((n,), **z),
            "temp": torch.zeros((n,), dtype=torch.float32, device=device),
            "eos": torch.full((n,), -1, **z),
            "outs": torch.zeros((n, self.max_out), **z),
            "done": torch.zeros((n,), dtype=torch.bool, device=device),
            "err": torch.zeros((n,), dtype=torch.bool, device=device),
        }

    # the first shard's (without a mesh: the whole slot batch's) params,
    # state and cache
    @property
    def params(self):
        return self._shards[0].params

    @property
    def _state(self) -> dict:
        return self._shards[0].state

    @property
    def _cache(self) -> dict:
        return self._shards[0].cache

    # -- helpers ------------------------------------------------------------
    def _owner(self, slot: int) -> tuple[_Shard, int]:
        """The shard holding `slot`, and the slot's row in it."""
        sh = self._shards[slot // self._rows]
        return sh, slot - sh.lo

    def _host(self, key: str) -> np.ndarray:
        """State leaf `key` of every slot, on the host (one transfer per
        shard)."""
        parts = [sh.state[key].cpu().numpy() for sh in self._shards]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _share_pages(self, src: _Shard, pages) -> None:
        """Copy pool pages `pages` of `src`'s replica to every other
        shard's (a no-op without a mesh or a paged cache)."""
        if not self._pools or not pages:
            return
        idx = torch.as_tensor(sorted(set(pages)), dtype=torch.long,
                              device=src.device)
        for name in self._pools:
            leaf = src.cache[name]
            ax = leaf.ndim - 4                 # (..., P, ps, Hkv, w)
            rows = leaf.index_select(ax, idx)
            for sh in self._shards:
                if sh is not src:
                    sh.cache[name].index_copy_(ax, idx.to(sh.device),
                                               rows.to(sh.device))

    def _sync(self) -> None:
        """Wait for the devices, so a host clock reads compute, not
        dispatch."""
        for dev in dict.fromkeys(sh.device for sh in self._shards):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _noise(self, temps, shape, device) -> torch.Tensor | None:
        """Gumbel noise of `shape` from the engine's generator when some
        row samples, on `device`; None when every row is greedy (nothing
        is drawn)."""
        if not any(t > 0 for t in temps):
            return None
        return gumbel_noise(shape, self._gen, self.device).to(device)

    # -- submission ---------------------------------------------------------
    def _validate(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise RequestError(f"prompt must be a non-empty 1-D token "
                               f"array, got shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise RequestError(f"prompt must hold integer token ids, got "
                               f"dtype {prompt.dtype}")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            raise RequestError(f"prompt token ids must lie in "
                               f"[0, {self.cfg.vocab}), got [{lo}, {hi}]")
        if req.max_new_tokens < 1:
            raise RequestError(f"max_new_tokens must be >= 1, got "
                               f"{req.max_new_tokens}")
        if prompt.size + req.max_new_tokens > self.max_len:
            raise RequestError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len={self.max_len}")
        if self.cfg.family == "vlm":
            if req.img_emb is None:
                raise RequestError("vlm request needs img_emb")
            shape = np.asarray(req.img_emb).shape
            want = (self.cfg.n_img_tokens, self.cfg.d_vision)
            if shape != want:
                raise RequestError(f"img_emb shape {shape} != {want} "
                                   f"(n_img_tokens, d_vision)")
        elif req.img_emb is not None:
            raise RequestError(
                f"img_emb is vlm-only (family is {self.cfg.family!r})")
        if req.deadline_s is not None and req.deadline_s < 0:
            raise RequestError(f"deadline_s must be >= 0, got "
                               f"{req.deadline_s}")
        if self._paged:
            need = -(-(int(prompt.size) + req.max_new_tokens - 1)
                     // self.page_size)
            if need > self.pool_pages:
                raise RequestError(f"request needs {need} pages > "
                                   f"pool_pages={self.pool_pages}")
        return prompt.astype(np.int32)

    def submit(self, req: Request) -> int:
        prompt = self._validate(req)
        if self.queue_cap is not None and len(self._queue) >= self.queue_cap:
            if self.overflow == "reject":
                self.stats["rejected"] += 1
                raise QueueFull(
                    f"admission queue at capacity ({self.queue_cap}); "
                    f"resubmit later or construct with overflow='block'")
            # "block": serve until the queue has room; what completes here
            # is buffered for the caller's next poll()
            while len(self._queue) >= self.queue_cap:
                self._done_buf.extend(self._poll_impl(False))
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, dataclasses.replace(req, prompt=prompt)))
        self._submit_time[rid] = time.time()
        return rid

    @property
    def idle(self) -> bool:
        return not self._queue and not self._running and not self._admitting

    @property
    def prefill_shape_count(self) -> int:
        return len(self._prefill_shapes)

    def _pop_next(self) -> tuple[int, Request]:
        """Highest priority first, FIFO (lowest rid) within a level."""
        q = self._queue
        if len(q) > 1 and any(r.priority != q[0][1].priority for _, r in q):
            i = max(range(len(q)), key=lambda j: (q[j][1].priority, -q[j][0]))
            rid_req = q[i]
            del q[i]
            return rid_req
        return q.popleft()

    # -- paged cache --------------------------------------------------------
    def _set_page_row(self, slot: int, pages: list[int]) -> None:
        """Write one slot's page-table row: `pages` in position order, the
        sentinel pool_pages beyond (unallocated: kernels clip and mask)."""
        row = np.full((self.n_pages,), self.pool_pages, np.int32)
        row[:len(pages)] = pages
        sh, ls = self._owner(slot)
        sh.cache["page_table"][ls] = torch.from_numpy(row).to(sh.device)

    def _alloc_pages(self, n: int) -> list[int] | None:
        """All-or-nothing page allocation, evicting cold prefix-tree
        entries when the free list alone cannot cover it."""
        got = self._pager.alloc(n)
        if got is None and self._use_tree:
            self._ptree.evict(n - self._pager.free_count())
            got = self._pager.alloc(n)
        return got

    def page_stats(self) -> dict | None:
        """Page-pool use: allocated vs pinned only by the prefix tree vs
        free, plus the tree's counters. None when the cache is contiguous."""
        if not self._paged:
            return None
        out = self._pager.stats()
        out["page_size"] = self.page_size
        out["pinned_by_prefix"] = self._ptree.n_pages if self._use_tree else 0
        if self._use_tree:
            out["prefix_tree"] = self._ptree.stats()
        return out

    def _retire_slot(self, slot: int, info: _Running, ok: bool) -> None:
        """Release a completed slot's pages. With the prefix tree, its full
        prompt pages (immutable from here on: decode writes only past the
        prompt) are offered to the tree first: a new token run hands its
        page's reference to the tree, a run already cached keeps the
        incumbent page and ours is released. Every other page drops the
        slot's reference. A slot retiring with an error donates nothing."""
        pages = self._slot_pages.pop(slot)
        taken: set = set()
        if ok and self._use_tree and info.prompt is not None:
            ps = self.page_size
            snaps = self._vs_snaps.get(info.rid, {})
            payloads = []
            for i in range(info.prompt_len // ps):
                if self._needs_vs and snaps.get((i + 1) * ps) is None:
                    break       # boundary missed its snapshot: stop here
                payloads.append(snaps.get((i + 1) * ps))
            taken = self._ptree.insert(info.prompt[:len(payloads) * ps],
                                       pages[:len(payloads)], payloads)
        self._vs_snaps.pop(info.rid, None)
        self._pager.decref([p for p in pages if p not in taken])
        self._set_page_row(slot, [])

    def _image_kw(self, req: Request, device: torch.device) -> dict:
        """The vlm family's image argument of a prefill call: the request's
        img_emb as a (1, n_img_tokens, d_vision) float32 tensor on `device`
        (JAX's float32 array); none for other families."""
        if self.cfg.family != "vlm":
            return {}
        img = np.asarray(req.img_emb, np.float32)[None]
        return {"img_emb": torch.from_numpy(img).to(device)}

    # -- whole-prompt admission ---------------------------------------------
    def _admit(self, slot: int, rid: int, req: Request,
               poison: float = 0.0) -> None:
        """Prefill the whole prompt at batch 1 straight into `slot`'s cache
        rows, sample the first token and arm the slot (in-flight slots
        stall for the whole prefill)."""
        plen = int(req.prompt.size)
        if self._running:
            self.stats["max_admit_stall_tokens"] = max(
                self.stats["max_admit_stall_tokens"], plen)
        t0 = time.time()
        sh, ls = self._owner(slot)
        tokens = torch.from_numpy(req.prompt[None].astype(np.int64)) \
            .to(sh.device)
        with on_device(sh.device):
            logits, sh.cache = self.model.prefill(
                sh.params, tokens, cache=sh.cache, slot=ls,
                **self._image_kw(req, sh.device))
            self._first_token(slot, logits, plen, req, poison)
        self._sync()                                  # honest prefill_s
        dt = time.time() - t0
        self.stats["prefill_s"] += dt
        self._req_prefill_s[rid] = dt
        self._prefill_shapes.add(("whole", plen))
        self._running[slot] = _Running(rid, plen)
        self.stats["prefill_tokens"] += plen
        self._note_first_token(slot, rid)

    # -- chunked admission --------------------------------------------------
    def _start_admission(self, slot: int, rid: int, req: Request,
                         poison: float = 0.0) -> bool:
        """Reserve `slot` and queue the request's chunked admission. Paged:
        allocate every page the request can reach (decode never runs out
        mid-flight), after pinning the longest cached full-page prefix from
        the tree (zero copies; only the unseen suffix is prefilled). Returns
        False, with nothing reserved, when the pool cannot take the request
        even after evicting cold tree pages."""
        start = 0
        if self._paged:
            plen, ps = int(req.prompt.size), self.page_size
            pinned: list[int] = []
            payloads: list = []
            if self._use_tree:
                # the last prompt token must prefill here, for the
                # first-token logits: the match stays below the whole prompt
                cap = ((plen - 1) // ps) * ps
                pinned, payloads = self._ptree.lookup(req.prompt[:cap])
                start = len(pinned) * ps
            need = -(-(plen + req.max_new_tokens - 1) // ps)
            fresh = self._alloc_pages(need - len(pinned))
            if fresh is None:
                if pinned:
                    self._pager.decref(pinned)
                return False
            pages = pinned + fresh
            self._slot_pages[slot] = pages
            self._set_page_row(slot, pages)
            if start:
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += start
                self._cached_tokens[rid] = start
            # the matched pages' snapshots seed this request's map, and the
            # running V scale resumes from the last one, so the suffix
            # prefill continues the mean exactly where the pages left off
            self._vs_snaps[rid] = {(i + 1) * ps: payloads[i]
                                   for i in range(len(payloads))}
            if start and self._needs_vs:
                sh, ls = self._owner(slot)
                sh.cache["v_scale"][:, ls] = payloads[-1].to(sh.device)
        n_chunks = max(1, -(-(int(req.prompt.size) - start)
                            // self.prefill_chunk))
        self._admitting.append(_Admission(slot, rid, req, n_chunks,
                                          start=start, poison=poison))
        return True

    def _advance_admission(self) -> None:
        """Advance the head admission by exactly one chunk; the last chunk
        samples the first token and arms the slot's decode state."""
        adm = self._admitting[0]
        req, slot, c = adm.req, adm.slot, self.prefill_chunk
        lo = adm.start + adm.next * c
        n_valid = min(c, int(req.prompt.size) - lo)
        final = adm.next == adm.n_chunks - 1
        if self._running:   # running slots wait only for THIS chunk
            self.stats["max_admit_stall_tokens"] = max(
                self.stats["max_admit_stall_tokens"], n_valid)
        t0 = time.time()
        sh, ls = self._owner(slot)
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :n_valid] = req.prompt[lo:lo + n_valid]
        tokens = torch.from_numpy(chunk).to(sh.device)
        # the vlm family's image K/V are written with the first chunk
        img = self._image_kw(req, sh.device) if adm.next == 0 else {}
        with on_device(sh.device):
            logits, sh.cache = self.model.prefill_chunk(
                sh.params, tokens, sh.cache, ls, lo, n_valid, **img)
            if final:
                self._first_token(slot, logits, lo + n_valid, req,
                                  adm.poison)
        if self._paged:       # the chunk's pages, to every pool replica
            ps = self.page_size
            self._share_pages(sh, self._slot_pages[slot][
                lo // ps:(lo + n_valid - 1) // ps + 1])
        self._sync()                                  # honest prefill_s
        dt = time.time() - t0
        self.stats["prefill_s"] += dt
        self._req_prefill_s[adm.rid] = \
            self._req_prefill_s.get(adm.rid, 0.0) + dt
        self.stats["prefill_tokens"] += n_valid
        self._prefill_shapes.add(("chunk", c, final))
        adm.next += 1
        end = lo + n_valid
        if self._use_tree and end % self.page_size == 0 and \
                end not in self._vs_snaps[adm.rid]:
            # the chunk ended on a page boundary: keep the running V scale
            # there (a device copy, no host sync), so the page can enter
            # the tree at retirement and a hit can resume from it
            self._vs_snaps[adm.rid][end] = (
                sh.cache["v_scale"][:, ls].clone()
                if self._needs_vs else None)
        if final:
            self._admitting.popleft()
            self._running[slot] = _Running(
                adm.rid, int(req.prompt.size),
                prompt=req.prompt if self._use_tree else None)
            self._note_first_token(slot, adm.rid)

    def _first_token(self, slot: int, logits1: torch.Tensor, prompt_len: int,
                     req: Request, poison: float = 0.0) -> None:
        """Sample the first token from the last chunk's logits and arm the
        slot, on the device (no host sync). `poison` (NaN when a fault plan
        poisons this admission) is added to the logits: the slot finishes
        at once with its error flag set."""
        if poison != 0.0:
            logits1 = logits1 + poison
        sh, ls = self._owner(slot)
        st = sh.state
        temp = torch.full((1,), float(req.temperature), device=sh.device)
        tok = sample_tokens(logits1, temp, gumbel=self._noise(
            [req.temperature], logits1.shape, sh.device))[0]
        eos = -1 if req.eos_id is None else int(req.eos_id)
        bad = ~torch.isfinite(logits1).all()
        finished = bad | (tok == eos) | (req.max_new_tokens <= 1)
        st["cur"][ls] = tok
        st["pos"][ls] = prompt_len
        st["active"][ls] = ~finished
        st["out_len"][ls] = 1
        st["budget"][ls] = req.max_new_tokens
        st["temp"][ls] = float(req.temperature)
        st["eos"][ls] = eos
        st["outs"][ls] = 0
        st["outs"][ls, 0] = tok
        st["done"][ls] = finished
        st["err"][ls] = bad
        self._temps[slot] = float(req.temperature)

    def _note_first_token(self, slot: int, rid: int) -> None:
        now = time.time()
        wall = now - self._submit_time[rid]
        self._ttft_wall[rid] = wall
        self._ttft[rid] = self._req_prefill_s.pop(rid, wall)
        self._slot_last_tok[slot] = now
        self._prev_out_len[slot] = 1

    # -- decode -------------------------------------------------------------
    def _step(self, drain: bool) -> torch.Tensor:
        """One decode step of every slot (each shard's model on its own
        rows, the step's noise drawn once for all of them); returns the
        device flag 'stop the burst after this step'."""
        temps = [self._temps[s] for s in self._running]
        noise, active, done = None, [], []
        for sh in self._shards:
            with on_device(sh.device):
                st = sh.state
                act = st["active"]
                pos = torch.where(act, st["pos"], -1)
                logits, sh.cache = self.model.decode(sh.params, st["cur"],
                                                     sh.cache, pos)
                if noise is None:
                    noise = self._noise(temps, (self.n_slots,
                                                logits.shape[-1]),
                                        self.device)
                nxt = sample_tokens(logits, st["temp"], gumbel=None
                                    if noise is None else
                                    noise[sh.lo:sh.lo + sh.rows].to(
                                        sh.device))
                nxt = torch.where(act, nxt, st["cur"])
                # per-row poison isolation: non-finite logits finish that
                # row now
                bad = act & ~torch.isfinite(logits).all(dim=-1)
                rows = torch.arange(sh.rows, device=sh.device)
                idx = st["out_len"].clamp(max=self.max_out - 1).long()
                old = st["outs"][rows, idx]
                st["outs"][rows, idx] = torch.where(act, nxt, old)
                out_len = st["out_len"] + act.to(torch.int32)
                finished = act & (bad | (nxt == st["eos"])
                                  | (out_len >= st["budget"]))
                st["cur"] = nxt
                st["pos"] = st["pos"] + act.to(torch.int32)
                st["active"] = act & ~finished
                st["out_len"] = out_len
                st["done"] = st["done"] | finished
                st["err"] = st["err"] | bad
                active.append(st["active"].any())
                if not drain:
                    done.append(st["done"].any())
        stop = ~self._any(active)
        if not drain:
            stop = stop | self._any(done)
        return stop

    def _any(self, flags: list[torch.Tensor]) -> torch.Tensor:
        """The shards' device flags OR-ed, on the first shard's device."""
        if len(flags) == 1:
            return flags[0]
        return torch.stack([f.to(self.device) for f in flags]).any()

    def _run_burst(self, drain: bool, max_steps: int) -> None:
        """Decode until some slot completes (with `drain`: until every slot
        has), or for at most `max_steps` steps (> 0 while an admission is
        mid-flight). The stop flag of step i is read after step i+1 is
        queued (the MoE family: before it): one host sync per step, never
        one per token per slot.

        The 'burst' fault site ticks once per attempt, before the attempt's
        first step is queued (state changes at that first step), so a
        failed attempt ran nothing and its retry is bit-identical.
        Injected stalls and backoff sleeps count in decode_s."""
        t0 = time.time()
        for attempt in range(self.burst_retries + 1):
            try:
                for f in self._plan_tick("burst"):
                    if f.kind == "slow":
                        time.sleep(f.param)       # a straggler
                    elif f.kind == "device_error":
                        raise TransientDeviceError(
                            f"injected device error (burst attempt "
                            f"{attempt})")
                break
            except TransientDeviceError:
                self.stats["burst_retries"] += 1
                if attempt == self.burst_retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))
        steps, prev = 0, None
        while not (max_steps and steps >= max_steps):
            stop = self._step(drain)
            steps += 1
            if not self._flag_lag:
                prev = stop
            if prev is not None:
                self.stats["host_syncs"] += 1
                if bool(prev):
                    break
            prev = stop
        if self._pools:         # the decode pages, to every pool replica
            for slot, info in self._running.items():
                sh, _ = self._owner(slot)
                self._share_pages(sh, self._slot_pages[slot][
                    info.prompt_len // self.page_size:])
        self._sync()
        self.stats["decode_s"] += time.time() - t0
        self.stats["decode_steps"] += steps
        self.stats["bursts"] += 1
        self._note_burst_tokens(t0)

    def _note_burst_tokens(self, t_start: float) -> None:
        """Burst-granularity inter-token bookkeeping: a burst's n tokens
        split its duration evenly; time a slot sat stalled before the burst
        lands on its first token's interval."""
        now = time.time()
        dur = now - t_start
        out_len = self._host("out_len")
        for slot, info in self._running.items():
            rid = info.rid
            n = int(out_len[slot] - self._prev_out_len[slot])
            if n > 0:
                per = dur / n
                stall = t_start - self._slot_last_tok.get(slot, t_start)
                self._itl.setdefault(rid, []).extend(
                    [stall + per] + [per] * (n - 1))
                self._slot_last_tok[slot] = now
            self._prev_out_len[slot] = out_len[slot]

    def _harvest(self) -> list[Completion]:
        """One transfer of the done/out state; frees every completed slot.
        A slot with non-finite logits retires with status 'error'."""
        if not self._running:
            return []
        done = self._host("done")
        if not done.any():
            return []
        out_len = self._host("out_len")
        outs = self._host("outs")
        errf = self._host("err")
        slots = [int(s) for s in np.nonzero(done)[0] if int(s) in self._running]
        completed = []
        now = time.time()
        for slot in sorted(slots, key=lambda s: self._running[s].rid):
            info = self._running.pop(slot)
            rid = info.rid
            bad = bool(errf[slot])
            toks = (np.zeros((0,), np.int32) if bad else
                    outs[slot, :int(out_len[slot])].astype(np.int32))
            if bad:
                self.stats["errors"] += 1
            else:
                self.stats["tokens_out"] += int(toks.size)
                self.stats["completed"] += 1
            if self._paged:
                self._retire_slot(slot, info, ok=not bad)
            self._free.append(slot)
            self._temps.pop(slot, None)
            self._slot_last_tok.pop(slot, None)
            completed.append(Completion(
                rid, toks, now - self._submit_time.pop(rid),
                ttft=self._ttft.pop(rid, 0.0),
                ttft_wall=self._ttft_wall.pop(rid, 0.0),
                cached_tokens=self._cached_tokens.pop(rid, 0),
                itl=np.asarray(self._itl.pop(rid, [])),
                status="error" if bad else "completed",
                error="non-finite logits" if bad else None))
        for sh in self._shards:
            mine = [s - sh.lo for s in slots if sh.lo <= s < sh.lo + sh.rows]
            if mine:
                idx = torch.as_tensor(mine, dtype=torch.long,
                                      device=sh.device)
                sh.state["done"][idx] = False
                sh.state["err"][idx] = False
        return completed

    # -- faults and the invariant watchdog ----------------------------------
    def _plan_tick(self, site: str) -> list:
        """Consult the fault plan at a hook site (none: no faults)."""
        return self._faults.tick(site) if self._faults is not None else []

    def _resolve(self, rid: int, status: str,
                 error: str | None = None) -> Completion:
        """The no-token completion of a request that never reached a slot:
        shed (deadline) or error (poison, pages it can never get). Counts
        the rid once, as a harvested completion."""
        self.stats["shed" if status == "shed" else "errors"] += 1
        return Completion(rid, np.zeros((0,), np.int32),
                          time.time() - self._submit_time.pop(rid),
                          status=status, error=error)

    def audit(self) -> list[str]:
        """Invariant audit, as violation strings (empty: consistent): the
        page pool's own (`PagePool.audit`), the prefix tree's
        (`PrefixCache.audit`), and the refcount ledger -- every pool page's
        refcount equals the references the slot page tables and the tree's
        nodes hold. A contiguous cache has nothing to audit."""
        if not self._paged:
            return []
        out = self._pager.audit()
        tree_pages: list[int] = []
        if self._use_tree:
            out += self._ptree.audit()
            tree_pages = self._ptree.pages()
        if out:
            # structurally corrupt (a node on a freed or out-of-range page):
            # the ledger would only report it again
            return out
        expect = np.zeros((self.pool_pages,), np.int64)
        for pages in self._slot_pages.values():
            for p in pages:
                expect[p] += 1
        for p in tree_pages:
            expect[p] += 1
        return [f"page {int(p)}: pool refcount "
                f"{int(self._pager.refs[p])} != {int(expect[p])} "
                f"references held (slot tables + prefix tree)"
                for p in np.nonzero(expect != self._pager.refs)[0]]

    def _watchdog(self) -> None:
        """The invariant watchdog, at burst boundaries when enabled. The
        'audit' site ticks here ('corrupt' corrupts the tree first). On a
        violation it degrades rather than crashes: the prefix tree is
        dropped (cache bypass: slots hold their own page references) and
        serving goes on; only a ledger still inconsistent after that raises
        InvariantViolation."""
        if not (self._check_inv and self._paged):
            return
        for f in self._plan_tick("audit"):
            if f.kind == "corrupt" and self._use_tree:
                self._ptree.corrupt()
        violations = self.audit()
        if not violations:
            return
        self.stats["invariant_violations"] += 1
        self.last_violations = violations
        if self._use_tree:
            self._ptree.clear()
            self._use_tree = False
            if not self.audit():
                return                   # degraded cleanly: tree bypassed
        raise InvariantViolation("\n".join(violations))

    # -- the loop -----------------------------------------------------------
    def poll(self, drain: bool = False) -> list[Completion]:
        """One round: admit into free slots (whole-prompt, or start chunked
        admissions and advance the head one by one chunk), harvest, else
        decode until the next completion event (bounded to
        `interleave_steps` while an admission is mid-flight), then run the
        watchdog. A request whose deadline passed is shed before it ticks
        the 'admit' site. A request the page pool cannot take yet goes back
        to its place at the head of the queue until running requests
        retire pages; with nothing in flight it could never be taken, and
        it completes alone with status 'error'. Every submitted rid
        resolves exactly once across the polls; completions buffered by a
        blocking submit come first."""
        out, self._done_buf = self._done_buf, []
        return out + self._poll_impl(drain)

    def _poll_impl(self, drain: bool) -> list[Completion]:
        completed: list[Completion] = []
        while self._queue and self._free:
            rid, req = self._pop_next()
            if req.deadline_s is not None and \
                    time.time() - self._submit_time[rid] > req.deadline_s:
                completed.append(self._resolve(rid, "shed"))
                continue
            slot = self._free.pop(0)
            poison, injected = 0.0, False
            for f in self._plan_tick("admit"):
                if f.kind == "nan":
                    poison = float("nan")
                elif f.kind == "poison":
                    injected = True
            if injected:
                self._free.insert(0, slot)
                completed.append(self._resolve(
                    rid, "error", "injected poison fault at admission"))
                continue
            if self.prefill_chunk is None:
                self._admit(slot, rid, req, poison)
                continue
            if not self._start_admission(slot, rid, req, poison):
                self._free.insert(0, slot)
                if not self._running and not self._admitting:
                    completed.append(self._resolve(
                        rid, "error",
                        "page pool exhausted with nothing in flight"))
                    continue
                self._queue.appendleft((rid, req))
                break
        if self._admitting:
            self._advance_admission()
        completed += self._harvest()
        if not completed and self._running:
            bounded = self.interleave_steps if self._admitting else 0
            dr = drain and not self._queue and not self._admitting
            self._run_burst(dr, bounded)
            self._watchdog()
            completed += self._harvest()
        return completed

    def run(self) -> dict[int, Completion]:
        """Poll until every submitted request has resolved."""
        out: dict[int, Completion] = {}
        while not self.idle or self._done_buf:
            for c in self.poll(drain=True):
                out[c.rid] = c
        return out

    def decode_steps(self) -> int:
        """Decode steps run so far: every slot steps together, and a mesh's
        shards in lockstep, so this is also the busiest shard's count."""
        return self.stats["decode_steps"]
