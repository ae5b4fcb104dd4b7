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

Not ported yet, and raising NotImplementedError naming ROADMAP Queue A:
the mesh, fault plans, the bounded queue and deadlines.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import ATTENTION_FAMILIES, Model
from repro_torch.serving.pager import PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import sample_tokens


class RequestError(ValueError):
    """A malformed request, rejected at submit."""


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 => greedy
    eos_id: int | None = None    # stop early when this token is sampled
    img_emb: np.ndarray | None = None   # vlm only: (n_img_tokens, d_vision)
    deadline_s: float | None = None     # not ported
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
    # "completed" | "error" (non-finite logits, or a page pool that cannot
    # take the request with nothing in flight)
    status: str = "completed"
    error: str | None = None


@dataclasses.dataclass
class _Running:
    rid: int
    prompt_len: int
    prompt: np.ndarray | None = None   # kept only for prefix-tree insertion


@dataclasses.dataclass
class _Admission:
    slot: int
    rid: int
    req: Request
    n_chunks: int
    next: int = 0
    start: int = 0      # prompt tokens served from the prefix cache


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                               f"item {item}, serving/scheduler.py)")


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
                 fault_plan=None):
        for name, value, item in (("the mesh", mesh, 6),
                                  ("queue_cap", queue_cap, 4),
                                  ("fault plans", fault_plan, 4)):
            if value is not None:
                raise _not_ported(name, item)
        if (prefill_chunk is not None and prefill_chunk < 1) \
                or interleave_steps < 0:
            raise ValueError("prefill_chunk >= 1 (or None: whole-prompt "
                             "admission) and interleave_steps >= 0")
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
            self._pager = PagePool(self.pool_pages)
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
        self.cfg, self.model, self.params = cfg, model, params
        self.n_slots, self.max_len = n_slots, max_len
        self.max_out = max_len
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = interleave_steps
        # MoE rows share expert capacity: a step queued ahead of the host's
        # read of the stop flag would run on another batch than JAX's burst
        self._flag_lag = not cfg.n_experts
        self.device = params["embed"].device     # the model's device
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
                      "prefill_tokens_saved": 0, "prefix_hits": 0}

        self._cache = model.init_cache(n_slots, max_len, device=self.device,
                                       **cache_kw)
        z = dict(dtype=torch.int32, device=self.device)
        self._state = {
            "cur": torch.zeros((n_slots,), **z),
            "pos": torch.zeros((n_slots,), **z),
            "active": torch.zeros((n_slots,), dtype=torch.bool,
                                  device=self.device),
            "out_len": torch.zeros((n_slots,), **z),
            "budget": torch.ones((n_slots,), **z),
            "temp": torch.zeros((n_slots,), dtype=torch.float32,
                                device=self.device),
            "eos": torch.full((n_slots,), -1, **z),
            "outs": torch.zeros((n_slots, self.max_out), **z),
            "done": torch.zeros((n_slots,), dtype=torch.bool,
                                device=self.device),
            "err": torch.zeros((n_slots,), dtype=torch.bool,
                               device=self.device),
        }

    # -- helpers ------------------------------------------------------------
    def _sync(self) -> None:
        """Wait for the device, so a host clock reads compute, not
        dispatch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generator(self, temps) -> torch.Generator | None:
        """The noise generator when some row samples, else None (greedy
        rows draw nothing)."""
        return self._gen if any(t > 0 for t in temps) else None

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
        if req.deadline_s is not None:
            raise _not_ported("deadlines (deadline_s)", 4)
        if self._paged:
            need = -(-(int(prompt.size) + req.max_new_tokens - 1)
                     // self.page_size)
            if need > self.pool_pages:
                raise RequestError(f"request needs {need} pages > "
                                   f"pool_pages={self.pool_pages}")
        return prompt.astype(np.int32)

    def submit(self, req: Request) -> int:
        prompt = self._validate(req)
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
        self._cache["page_table"][slot] = torch.from_numpy(row).to(self.device)

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

    def _image_kw(self, req: Request) -> dict:
        """The vlm family's image argument of a prefill call: the request's
        img_emb as a (1, n_img_tokens, d_vision) float32 tensor on the
        device (JAX's float32 array); none for other families."""
        if self.cfg.family != "vlm":
            return {}
        img = np.asarray(req.img_emb, np.float32)[None]
        return {"img_emb": torch.from_numpy(img).to(self.device)}

    # -- whole-prompt admission ---------------------------------------------
    def _admit(self, slot: int, rid: int, req: Request) -> None:
        """Prefill the whole prompt at batch 1 straight into `slot`'s cache
        rows, sample the first token and arm the slot (in-flight slots
        stall for the whole prefill)."""
        plen = int(req.prompt.size)
        if self._running:
            self.stats["max_admit_stall_tokens"] = max(
                self.stats["max_admit_stall_tokens"], plen)
        t0 = time.time()
        tokens = torch.from_numpy(req.prompt[None].astype(np.int64)) \
            .to(self.device)
        logits, self._cache = self.model.prefill(self.params, tokens,
                                                 cache=self._cache, slot=slot,
                                                 **self._image_kw(req))
        self._first_token(slot, logits, plen, req)
        self._sync()                                  # honest prefill_s
        dt = time.time() - t0
        self.stats["prefill_s"] += dt
        self._req_prefill_s[rid] = dt
        self._prefill_shapes.add(("whole", plen))
        self._running[slot] = _Running(rid, plen)
        self.stats["prefill_tokens"] += plen
        self._note_first_token(slot, rid)

    # -- chunked admission --------------------------------------------------
    def _start_admission(self, slot: int, rid: int, req: Request) -> bool:
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
                self._cache["v_scale"][:, slot] = payloads[-1]
        n_chunks = max(1, -(-(int(req.prompt.size) - start)
                            // self.prefill_chunk))
        self._admitting.append(_Admission(slot, rid, req, n_chunks,
                                          start=start))
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
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :n_valid] = req.prompt[lo:lo + n_valid]
        tokens = torch.from_numpy(chunk).to(self.device)
        # the vlm family's image K/V are written with the first chunk
        img = self._image_kw(req) if adm.next == 0 else {}
        logits, self._cache = self.model.prefill_chunk(
            self.params, tokens, self._cache, slot, lo, n_valid, **img)
        if final:
            self._first_token(slot, logits, lo + n_valid, req)
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
                self._cache["v_scale"][:, slot].clone()
                if self._needs_vs else None)
        if final:
            self._admitting.popleft()
            self._running[slot] = _Running(
                adm.rid, int(req.prompt.size),
                prompt=req.prompt if self._use_tree else None)
            self._note_first_token(slot, adm.rid)

    def _first_token(self, slot: int, logits1: torch.Tensor, prompt_len: int,
                     req: Request) -> None:
        """Sample the first token from the last chunk's logits and arm the
        slot, on the device (no host sync)."""
        st = self._state
        temp = torch.full((1,), float(req.temperature), device=self.device)
        tok = sample_tokens(logits1, temp,
                            generator=self._generator([req.temperature]))[0]
        eos = -1 if req.eos_id is None else int(req.eos_id)
        bad = ~torch.isfinite(logits1).all()
        finished = bad | (tok == eos) | (req.max_new_tokens <= 1)
        st["cur"][slot] = tok
        st["pos"][slot] = prompt_len
        st["active"][slot] = ~finished
        st["out_len"][slot] = 1
        st["budget"][slot] = req.max_new_tokens
        st["temp"][slot] = float(req.temperature)
        st["eos"][slot] = eos
        st["outs"][slot] = 0
        st["outs"][slot, 0] = tok
        st["done"][slot] = finished
        st["err"][slot] = bad
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
        """One decode step of every slot; returns the device flag 'stop
        the burst after this step'."""
        st = self._state
        act = st["active"]
        pos = torch.where(act, st["pos"], -1)
        logits, self._cache = self.model.decode(self.params, st["cur"],
                                                self._cache, pos)
        gen = self._generator(self._temps[s] for s in self._running)
        nxt = sample_tokens(logits, st["temp"], generator=gen)
        nxt = torch.where(act, nxt, st["cur"])
        # per-row poison isolation: non-finite logits finish that row now
        bad = act & ~torch.isfinite(logits).all(dim=-1)
        rows = torch.arange(self.n_slots, device=self.device)
        idx = st["out_len"].clamp(max=self.max_out - 1).long()
        old = st["outs"][rows, idx]
        st["outs"][rows, idx] = torch.where(act, nxt, old)
        out_len = st["out_len"] + act.to(torch.int32)
        finished = act & (bad | (nxt == st["eos"]) | (out_len >= st["budget"]))
        st["cur"] = nxt
        st["pos"] = st["pos"] + act.to(torch.int32)
        st["active"] = act & ~finished
        st["out_len"] = out_len
        st["done"] = st["done"] | finished
        st["err"] = st["err"] | bad
        stop = ~st["active"].any()
        if not drain:
            stop = stop | st["done"].any()
        return stop

    def _run_burst(self, drain: bool, max_steps: int) -> None:
        """Decode until some slot completes (with `drain`: until every slot
        has), or for at most `max_steps` steps (> 0 while an admission is
        mid-flight). The stop flag of step i is read after step i+1 is
        queued (the MoE family: before it): one host sync per step, never
        one per token per slot."""
        t0 = time.time()
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
        out_len = self._state["out_len"].cpu().numpy()
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
        done = self._state["done"].cpu().numpy()
        if not done.any():
            return []
        out_len = self._state["out_len"].cpu().numpy()
        outs = self._state["outs"].cpu().numpy()
        errf = self._state["err"].cpu().numpy()
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
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self._state["done"][idx] = False
        self._state["err"][idx] = False
        return completed

    # -- the loop -----------------------------------------------------------
    def poll(self, drain: bool = False) -> list[Completion]:
        """One round: admit into free slots (whole-prompt, or start chunked
        admissions and advance the head one by one chunk), harvest, else
        decode until the next completion event (bounded to
        `interleave_steps` while an admission is mid-flight). A request the page pool cannot take yet goes back to
        its place at the head of the queue until running requests retire
        pages; with nothing in flight it could never be taken, and it
        completes alone with status 'error'."""
        completed: list[Completion] = []
        while self._queue and self._free:
            rid, req = self._pop_next()
            slot = self._free.pop(0)
            if self.prefill_chunk is None:
                self._admit(slot, rid, req)
                continue
            if not self._start_admission(slot, rid, req):
                self._free.insert(0, slot)
                if not self._running and not self._admitting:
                    self.stats["errors"] += 1
                    completed.append(Completion(
                        rid, np.zeros((0,), np.int32),
                        time.time() - self._submit_time.pop(rid),
                        status="error",
                        error="page pool exhausted with nothing in flight"))
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
            completed += self._harvest()
        return completed

    def run(self) -> dict[int, Completion]:
        """Poll until every submitted request has completed."""
        out: dict[int, Completion] = {}
        while not self.idle:
            for c in self.poll(drain=True):
                out[c.rid] = c
        return out
