"""Continuous-batching scheduler: fixed decode slots over a request queue
(port of the single-device, contiguous-cache, chunked-admission subset of
`repro.serving.scheduler`).

Admission is chunked (`prefill_chunk=C`): a prompt advances through its
slot's cache row one fixed-shape (1, C) chunk per poll, through
`Model.prefill_chunk` (packed K/V rows and the running V scale land
incrementally). Between chunks the scheduler runs a decode burst bounded to
`interleave_steps`, so admitting a long prompt does not freeze the running
slots. Rows mid-admission decode with a pos = -1 sentinel: they compute but
write nothing, so a burst cannot corrupt a partially prefilled row.

Decode: one step advances every slot together (per-slot position,
temperature and eos). Slot state and output tokens live on the device; the
host reads one flag per step -- whether the burst should stop (a slot
finished, or none is active) -- and reads it one step late, after the next
step is already queued, so the device never waits on the host between
steps. That extra step is harmless: a finished row is inactive and writes
nothing, and an active row only gets its next token early. A freed slot is
recycled to the next queued request at the next poll. Completions carry
`ttft` (the request's own admission compute, device-synced), `ttft_wall`,
`latency` and burst-granularity inter-token intervals `itl`, as in the JAX
package.

Sampling (temperature > 0) draws Gumbel noise from one generator seeded
from the engine (`serving.sampling`): greedy outputs are the JAX package's,
sampled ones are not its draws.

Not ported yet, and raising NotImplementedError naming ROADMAP Queue A:
whole-prompt admission (`prefill_chunk=None`), the mesh, the paged cache
and its prefix cache, fault plans, the bounded queue and deadlines.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model
from repro_torch.serving.sampling import sample_tokens


class RequestError(ValueError):
    """A malformed request, rejected at submit."""


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 => greedy
    eos_id: int | None = None    # stop early when this token is sampled
    img_emb: np.ndarray | None = None   # vlm only (not ported)
    deadline_s: float | None = None     # not ported
    priority: int = 0            # higher admits first; ties go by rid


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray           # includes the eos token, if one was sampled
    latency: float               # seconds, submit -> harvest
    ttft: float = 0.0            # seconds of the request's own admission
    ttft_wall: float = 0.0       # seconds, submit -> first token
    itl: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    status: str = "completed"    # "completed" | "error" (non-finite logits)
    error: str | None = None


@dataclasses.dataclass
class _Admission:
    slot: int
    rid: int
    req: Request
    n_chunks: int
    next: int = 0


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A, "
                               "serving/scheduler.py)")


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
        if prefill_chunk is None:
            raise _not_ported("whole-prompt admission (prefill_chunk=None)")
        for name, value in (("the paged cache (page_size)", page_size),
                            ("pool_pages", pool_pages),
                            ("the mesh", mesh), ("queue_cap", queue_cap),
                            ("fault plans", fault_plan)):
            if value is not None:
                raise _not_ported(name)
        if prefix_cache:
            raise _not_ported("the prefix cache")
        if prefill_chunk < 1 or interleave_steps < 0:
            raise ValueError("prefill_chunk >= 1 and interleave_steps >= 0")
        self.cfg, self.model, self.params = cfg, model, params
        self.n_slots, self.max_len = n_slots, max_len
        self.max_out = max_len
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = interleave_steps
        self.device = params["embed"].device     # the model's device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        self._queue: deque[tuple[int, Request]] = deque()
        self._free = list(range(n_slots))
        self._running: dict[int, int] = {}    # slot -> rid
        self._admitting: deque[_Admission] = deque()
        self._temps: dict[int, float] = {}     # slot -> temperature (host)
        self._submit_time: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._ttft_wall: dict[int, float] = {}
        self._req_prefill_s: dict[int, float] = {}
        self._itl: dict[int, list] = {}
        self._slot_last_tok: dict[int, float] = {}
        self._prev_out_len = np.zeros((n_slots,), np.int64)
        self._prefill_shapes: set = set()
        self.stats = {"prefill_tokens": 0, "prefill_s": 0.0, "bursts": 0,
                      "decode_s": 0.0, "tokens_out": 0, "completed": 0,
                      "max_admit_stall_tokens": 0, "errors": 0,
                      "decode_steps": 0, "host_syncs": 0}

        self._cache = model.init_cache(n_slots, max_len, device=self.device)
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
        if req.img_emb is not None:
            raise RequestError(
                f"img_emb is vlm-only (family is {self.cfg.family!r})")
        if req.deadline_s is not None:
            raise _not_ported("deadlines (deadline_s)")
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

    # -- chunked admission --------------------------------------------------
    def _advance_admission(self) -> None:
        """Advance the head admission by exactly one chunk; the last chunk
        samples the first token and arms the slot's decode state."""
        adm = self._admitting[0]
        req, slot, c = adm.req, adm.slot, self.prefill_chunk
        lo = adm.next * c
        n_valid = min(c, int(req.prompt.size) - lo)
        final = adm.next == adm.n_chunks - 1
        if self._running:   # running slots wait only for THIS chunk
            self.stats["max_admit_stall_tokens"] = max(
                self.stats["max_admit_stall_tokens"], n_valid)
        t0 = time.time()
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :n_valid] = req.prompt[lo:lo + n_valid]
        tokens = torch.from_numpy(chunk).to(self.device)
        logits, self._cache = self.model.prefill_chunk(
            self.params, tokens, self._cache, slot, lo, n_valid)
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
        if final:
            self._admitting.popleft()
            self._running[slot] = adm.rid
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
        queued: one host sync per step, never one per token per slot."""
        t0 = time.time()
        steps, prev = 0, None
        while not (max_steps and steps >= max_steps):
            stop = self._step(drain)
            steps += 1
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
        for slot, rid in self._running.items():
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
        for slot in sorted(slots, key=lambda s: self._running[s]):
            rid = self._running.pop(slot)
            bad = bool(errf[slot])
            toks = (np.zeros((0,), np.int32) if bad else
                    outs[slot, :int(out_len[slot])].astype(np.int32))
            if bad:
                self.stats["errors"] += 1
            else:
                self.stats["tokens_out"] += int(toks.size)
                self.stats["completed"] += 1
            self._free.append(slot)
            self._temps.pop(slot, None)
            self._slot_last_tok.pop(slot, None)
            completed.append(Completion(
                rid, toks, now - self._submit_time.pop(rid),
                ttft=self._ttft.pop(rid, 0.0),
                ttft_wall=self._ttft_wall.pop(rid, 0.0),
                itl=np.asarray(self._itl.pop(rid, [])),
                status="error" if bad else "completed",
                error="non-finite logits" if bad else None))
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self._state["done"][idx] = False
        self._state["err"][idx] = False
        return completed

    # -- the loop -----------------------------------------------------------
    def poll(self, drain: bool = False) -> list[Completion]:
        """One round: start admissions into free slots, advance the head
        admission by one chunk, harvest, else decode until the next
        completion event (bounded to `interleave_steps` while an admission
        is mid-flight)."""
        while self._queue and self._free:
            rid, req = self._pop_next()
            slot = self._free.pop(0)
            n_chunks = -(-int(req.prompt.size) // self.prefill_chunk)
            self._admitting.append(_Admission(slot, rid, req, n_chunks))
        if self._admitting:
            self._advance_admission()
        completed = self._harvest()
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
