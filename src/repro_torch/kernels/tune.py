"""Shape-keyed route table for the packed kernels (port of
`repro.kernels.tune`).

Every packed kernel entry point (`dispatch_binary_gemm{,_fused}`,
`decode_attention_packed{,_paged}`, `prefill_attention_packed{,_paged}`)
asks this module which launch to run for its shape:

    route, params = tune.get_route("binary_gemm", m=m, n=n, kw=kw, pl=1)

Shapes are bucketed as the JAX package buckets them (size-like dims rounded
up to powers of two; kv heads, GQA group, head_dim, page size and the GEMMs'
lhs form `pl` (1 = packed int32 words, 0 = float or bf16) kept exact) and
looked up in a JSON table committed to the repo, one per backend:

  * `tuned/cpu.json`, a copy of the JAX package's table with its route
    names (vpu | mxu | xla | float for the GEMMs, pallas | xla for
    attention). On the CPU every route runs the kernel's plain PyTorch
    version, so the table only makes `get_route` and
    `ServingEngine.kernel_routes` answer what the JAX package answers.
  * `tuned/<card>.json`, named from `torch.cuda.get_device_name()` (for an
    H100 `nvidia-h100-80gb-hbm3.json`), tuned on that card by `--tune`.
    Every route there is `cuda`, a launch of the hand-written kernel, and
    its params are the kernel's launch fields: `small_m`, `block_n` and
    `split` of `binary_gemm.GemmPlan` for the GEMMs, `split` (and a chunk's
    `block_rows`) of `prefill_attention.AttentionPlan` for attention. A card
    table that names a plain route raises.

On a miss the answer is the backend heuristic: JAX's on the CPU, and on the
card the fixed rule's fields (`gemm_plan`, `attention_plan`), so a missing
table or bucket launches exactly what the fixed rule launches. With
`REPRO_AUTOTUNE=1` on the card, outside CUDA graph capture, a missing
bucket is tuned on the spot and persisted. `route_override` pins a
kernel's route for every lookup inside it; `('cuda', {})` is the fixed
rule's launch.

Tuning a bucket on the card: operands at the shape given for it (a
standard shape of JAX's list is its bucket's corner, with a bf16 float
lhs; a card bucket is tuned at the real shape its first launch had, and a
float lhs in that launch's `dtype`, as recorded), and for every
launch of the lattice the kernels take there (`candidates`; the fixed
rule's always among them) (a) the output held to the plain version's,
every int32 dot and word bit for bit (the attention kernels' dots bit for
bit and their outputs within the kernel checks' tolerance with equal signs:
the float sums' order changes with the split), a candidate that differs
raising, never timed, then (b) its device time by CUDA events around 20
launches queued behind a spin kernel. The winner is persisted with every
candidate's time and the roofline counted from the shape (ops, bytes, the
least time at the card's peaks: `gemm_bound`, `attention_bound`, the
bounds `chip_smoke.py`'s kernel table prints too).

Two lists of shapes must be tuned (`--check` fails on a gap):
`STANDARD_SHAPES`, the JAX package's, and on the card `card_shapes()`,
every bucket `chip_smoke.py`'s serving and paper-net paths resolve, with
the real shape of its first launch (and a float lhs's `dtype`: the paper
nets feed float32, the LMs bf16), recorded at dispatch on the card
(`tuned/card_shapes.json`, written by `chip_smoke.py --record-shapes`):
tuned at its pow2 corner instead, phi3's decode GEMMs on the float lhs
(N 5,120 in the N 8,192 bucket, K 5,120 / 17,920 in K 8,192 / 32,768)
took launches 21% slower at their real shape on an H100. Batched MoE expert GEMMs (kernel 1 over
E experts) and the training path's `binary_gemm_mxu` have no key in the
JAX package's table and keep the fixed rule.

CLI:
    python -m repro_torch.kernels.tune --tune [--force]   # on the card
    python -m repro_torch.kernels.tune --check            # table complete?
    python -m repro_torch.kernels.tune --show             # decision table
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Any

import torch

TUNED_DIR = Path(__file__).resolve().parent / "tuned"
CARD_SHAPES = TUNED_DIR / "card_shapes.json"

# Size-like dims get pow2-bucketed; everything else is structural and kept
# exact in the key. The paged pool size `p` is size-like; the page size
# `ps` is structural.
_BUCKETED = {"m", "n", "kw", "b", "t", "s", "p"}

_GEMM_SHAPES = [
    dict(m=4, n=64, kw=2),
    dict(m=8, n=128, kw=2),
    dict(m=32, n=128, kw=4),
    dict(m=8, n=512, kw=16),
    dict(m=64, n=1024, kw=32),
    dict(m=256, n=2048, kw=64),
]
_FUSED_SHAPES = [
    dict(m=4, n=64, kw=2),
    dict(m=8, n=128, kw=2),
    dict(m=32, n=128, kw=4),
    dict(m=64, n=1024, kw=32),
]

# The JAX package's standard buckets, unchanged
STANDARD_SHAPES: dict[str, list[dict[str, int]]] = {
    "binary_gemm": [dict(s, pl=pl) for s in _GEMM_SHAPES for pl in (1, 0)],
    "binary_gemm_fused": [dict(s, pl=pl)
                          for s in _FUSED_SHAPES for pl in (1, 0)],
    "decode_attention": [
        dict(b=4, t=16, hkv=2, g=2, hd=16),
        dict(b=8, t=128, hkv=2, g=4, hd=64),
        dict(b=8, t=512, hkv=2, g=4, hd=64),
    ],
    "prefill_attention": [
        dict(b=4, s=8, t=16, hkv=2, g=2, hd=16),
        dict(b=4, s=8, t=128, hkv=2, g=4, hd=64),
        dict(b=8, s=16, t=512, hkv=2, g=4, hd=64),
    ],
    "decode_attention_paged": [
        dict(b=4, t=16, ps=4, p=16, hkv=2, g=2, hd=16),
        dict(b=8, t=128, ps=8, p=128, hkv=2, g=4, hd=64),
        dict(b=8, t=512, ps=8, p=512, hkv=2, g=4, hd=64),
    ],
    "prefill_attention_paged": [
        dict(b=4, s=8, t=16, ps=4, p=16, hkv=2, g=2, hd=16),
        dict(b=4, s=8, t=128, ps=8, p=128, hkv=2, g=4, hd=64),
    ],
}
KERNELS = tuple(STANDARD_SHAPES)
# each table kernel's routes in the JAX package's vocabulary, and the one
# route of a card table
ROUTES = {"binary_gemm": ("vpu", "mxu", "xla", "float"),
          "binary_gemm_fused": ("vpu", "xla", "float"),
          **{k: ("pallas", "xla") for k in KERNELS if "attention" in k}}
CARD_ROUTE = "cuda"

# the card's peaks for the rooflines (here and in chip_smoke.py)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
POPC_PER_CLOCK_PER_SM = 16         # 32-bit popc issue rate, compute 9.0
SM_CLOCK_HZ = 1.98e9               # H100 SXM max SM clock (torch.cuda._sleep)
# attention outputs, kernel against plain version: the sums are exact in
# both, exp may differ by an ulp between the CUDA math library and torch's
ATTN_TOL = {torch.bfloat16: 2.0 ** -7,     # one bf16 ulp at 1
            torch.float32: 1e-6}           # 8 float32 ulps at 1
# a float lhs's bytes a value, by the `dtype` a card shape records
LHS_BYTES = {"float32": 4, "bfloat16": 2}


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def bucket(shape: dict[str, int]) -> dict[str, int]:
    """Round size-like dims up to the next power of two; keep structural
    dims exact. Tuning happens at the bucket shape, so one table entry
    covers every shape that rounds into it. A recorded float lhs's `dtype`
    is not part of the key (the JAX package's `pl` is)."""
    return {k: (_pow2(v) if k in _BUCKETED else int(v))
            for k, v in shape.items() if k != "dtype"}


def bucket_key(shape: dict[str, int]) -> str:
    return "_".join(f"{k}{v}" for k, v in sorted(bucket(shape).items()))


def default_backend() -> str:
    """'cpu' without a card, else the card's name as a file stem
    ('NVIDIA H100 80GB HBM3' -> 'nvidia-h100-80gb-hbm3')."""
    if not torch.cuda.is_available():
        return "cpu"
    return re.sub(r"[^a-z0-9]+", "-",
                  torch.cuda.get_device_name(0).lower()).strip("-")


def cache_path(backend: str | None = None) -> Path:
    return TUNED_DIR / f"{backend or default_backend()}.json"


# dispatch's per-call-shape plan memos (binary_gemm._ROUTED,
# prefill_attention._ROUTED): emptied whenever a lookup could answer
# otherwise (a new table on disk, a persisted entry, a route override)
PLAN_MEMOS: list[dict] = []
_seen_table: list[tuple[str, float]] = []
# held while a memo is read and filled and while the pins change, so that a
# plan resolved in one thread (a replica's worker) cannot land in a memo
# another thread just emptied for its route override
LOCK = threading.RLock()


def forget_plans() -> None:
    with LOCK:
        for memo in PLAN_MEMOS:
            memo.clear()


@functools.lru_cache(maxsize=4)
def _load(path_str: str, _mtime: float) -> dict[str, Any]:
    with open(path_str) as f:
        return json.load(f)


def load_cache(backend: str | None = None) -> dict[str, Any]:
    p = cache_path(backend)
    if not p.exists():
        return {}
    mtime = p.stat().st_mtime
    if (str(p), mtime) not in _seen_table:
        _seen_table.append((str(p), mtime))
        forget_plans()
    return _load(str(p), mtime)


@functools.lru_cache(maxsize=1)
def card_shapes() -> dict[str, list[dict[str, int]]]:
    """The card's second list of standard buckets (recorded on the card)."""
    if not CARD_SHAPES.exists():
        return {}
    data = json.loads(CARD_SHAPES.read_text())
    return {k: v for k, v in data.items() if k != "_meta"}


def standard_shapes(backend: str | None = None
                    ) -> dict[str, list[dict[str, int]]]:
    """The buckets `--check` requires: STANDARD_SHAPES, and on a card
    also `card_shapes()`, one entry per distinct key."""
    out = {k: list(v) for k, v in STANDARD_SHAPES.items()}
    if (backend or default_backend()) != "cpu":
        for kernel, shapes in card_shapes().items():
            have = {bucket_key(s) for s in out.setdefault(kernel, [])}
            out[kernel] += [s for s in shapes if bucket_key(s) not in have]
    return out


def _gemm_kernel(kernel: str, shape: dict[str, int]) -> str:
    """The port's wrapper behind a table GEMM key."""
    if kernel == "binary_gemm_fused":
        return kernel
    return "binary_gemm_packed" if shape.get("pl", 1) \
        else "binary_gemm_packed_rhs"


def _sms() -> int:
    from repro_torch._device import sm_count
    return sm_count(torch.device("cuda"))


def rule_params(kernel: str, shape: dict[str, int],
                sms: int | None = None) -> dict:
    """The fixed rule's launch fields at `shape` (gemm_plan, aligned
    operands; attention_plan) on a card of `sms` SMs."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import prefill_attention as pa
    sms = sms or _sms()
    if kernel in ("binary_gemm", "binary_gemm_fused"):
        return bg.plan_params(bg.gemm_plan(_gemm_kernel(kernel, shape),
                                           shape["m"], shape["n"],
                                           32 * shape["kw"], sms))
    s = shape.get("s", 1)
    return pa.plan_params(pa.attention_plan(
        shape["b"], s, shape["t"], shape["hkv"], shape["g"], shape["hd"],
        sms), s)


def _heuristic(kernel: str, shape: dict[str, int]) -> tuple[str, dict]:
    """Miss fallback. On the CPU the JAX package's CPU guess (the names
    only: every route runs the plain version there); on the card the fixed
    rule's launch."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel: {kernel}")
    if default_backend() == "cpu":
        if kernel in ("binary_gemm", "binary_gemm_fused"):
            m, n, kw = shape["m"], shape["n"], shape["kw"]
            return ("xla", {}) if m * n * kw <= (1 << 23) else ("float", {})
        return "xla", {}
    return CARD_ROUTE, rule_params(kernel, shape)


# get_route misses, for tooling: maps (kernel, key) -> shape dict
misses: dict[tuple[str, str], dict[str, int]] = {}
# every (kernel, key) dispatch resolved outside a route override -> the
# real shape of its first launch (`note_dispatch`; what `chip_smoke.py
# --record-shapes` writes)
seen: dict[tuple[str, str], dict[str, int]] = {}

# Active route pins (kernel name -> route), installed by `route_override`.
# Highest dispatch priority: consulted before the table. Process-wide, as
# the JAX package's are: a pin holds in every thread while it is on.
_ROUTE_OVERRIDE: dict[str, str] = {}

@contextlib.contextmanager
def route_override(**kernel_routes: str):
    """Pin `kernel -> route` for every get_route call inside the context
    (params {}: on the card, the fixed rule's launch). Nests; inner
    contexts win on conflicts and restore the outer pins on exit."""
    with LOCK:
        old = dict(_ROUTE_OVERRIDE)
        _ROUTE_OVERRIDE.update(kernel_routes)
        forget_plans()
    try:
        yield
    finally:
        with LOCK:
            _ROUTE_OVERRIDE.clear()
            _ROUTE_OVERRIDE.update(old)
            forget_plans()


def check_route(kernel: str, route: str | None) -> None:
    """Raise for a route name that is neither the JAX package's nor the
    card's (the CPU runs every route's plain version)."""
    if route is not None and route != CARD_ROUTE \
            and route not in ROUTES[kernel]:
        raise ValueError(f"unknown {kernel} route: {route}")


def check_card_route(kernel: str, route: str) -> None:
    """On the card every route is a kernel launch: raise for any other."""
    if route != CARD_ROUTE:
        check_route(kernel, route)
        raise ValueError(f"{kernel} route {route!r} launches no kernel on "
                         f"the card (its routes are {CARD_ROUTE!r})")


def get_route(kernel: str, **shape: int) -> tuple[str, dict]:
    """Resolve (route, kernel params) for a shape. An active
    `route_override` pin wins; then a table hit; otherwise the backend
    heuristic (or, with REPRO_AUTOTUNE=1 on the card outside CUDA graph
    capture, tune the missing bucket now and persist it)."""
    if kernel in _ROUTE_OVERRIDE:
        return _ROUTE_OVERRIDE[kernel], {}
    key = bucket_key(shape)
    table = load_cache()
    entry = table.get(kernel, {}).get(key)
    if entry is not None:
        if table.get("_meta", {}).get("backend", "cpu") != "cpu":
            check_card_route(kernel, entry["route"])
        return entry["route"], dict(entry.get("params", {}))
    misses[(kernel, key)] = dict(shape)
    if os.environ.get("REPRO_AUTOTUNE") == "1" \
            and default_backend() != "cpu" and _capture_clean():
        entry = tune_bucket(kernel, shape)
        return entry["route"], dict(entry["params"])
    return _heuristic(kernel, shape)


def note_dispatch(kernel: str, shape: dict[str, int],
                  dtype: torch.dtype | None = None) -> None:
    """Record a shape a kernel launch resolved (`seen`: the first of its
    bucket, with a float lhs's `dtype`), unless a route override pins the
    kernel."""
    if kernel not in _ROUTE_OVERRIDE:
        first = dict(shape)
        if dtype is not None and dtype != torch.int32:
            first["dtype"] = str(dtype).removeprefix("torch.")
        seen.setdefault((kernel, bucket_key(shape)), first)


def _capture_clean() -> bool:
    """Not inside CUDA graph capture (nothing may sync or allocate there;
    a build without CUDA captures nothing)."""
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------------------
# Tuning: candidates, gating against the plain version, timing, persistence
# ---------------------------------------------------------------------------
def candidates(kernel: str, shape: dict[str, int],
               sms: int | None = None) -> list[tuple[str, dict]]:
    """The (route, params) lattice the tuner may pick for a shape's bucket
    on a card of `sms` SMs (default: this card's): every launch the kernel
    takes at that shape (`plan_from_params`, with the table's clamps), the
    fixed rule's first."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import prefill_attention as pa
    sms = sms or _sms()
    lattice = [rule_params(kernel, shape, sms)]
    if kernel in ("binary_gemm", "binary_gemm_fused"):
        kn = _gemm_kernel(kernel, shape)
        m, n, k = shape["m"], shape["n"], 32 * shape["kw"]
        widths = (32, 64, 128, 256) if kn == "binary_gemm_packed" else (32, 64)
        lattice += [dict(small_m=1, block_n=w, split=sp) for w in widths
                    for sp in (1, 2, 4, 8)]
        lattice += [dict(small_m=0, block_n=128, split=sp)
                    for sp in (1, 2, 4, 8)]
        lattice.append(dict(small_m=0, block_n=256, split=1))
        ok = [p for p in lattice
              if bg.plan_from_params(kn, m, n, k, sms, True, p) is not None]
    elif kernel in KERNELS:
        b, s, t = shape["b"], shape.get("s", 1), shape["t"]
        hkv, g, hd = shape["hkv"], shape["g"], shape["hd"]
        rows = [1] if s == 1 else [r for r in (1, 2, 4, 8, 16, 32)
                                   if r <= s and r * g <= 32]
        lattice += [pa.plan_params(pa.AttentionPlan(r, sp, 0), s)
                    for r in rows for sp in (1, 2, 4, 8)]
        ok = [p for p in lattice
              if pa.plan_from_params(b, s, t, hkv, g, hd, p) is not None]
    else:
        raise ValueError(f"unknown kernel: {kernel}")
    out: list[tuple[str, dict]] = []
    for p in ok:
        if (CARD_ROUTE, p) not in out:
            out.append((CARD_ROUTE, p))
    return out


def ragged(shape: dict[str, int]) -> dict[str, int]:
    """Another shape in `shape`'s bucket where one exists: each bucketed
    dim cut by an eighth (at least 1), else moved by one, within its
    power of two."""
    def move(v: int) -> int:
        for c in (v - max(1, v // 8), v - 1, v + 1):
            if c >= 1 and _pow2(c) == _pow2(v):
                return c
        return v
    return {k: (move(v) if k in _BUCKETED else v) for k, v in shape.items()}


def lhs_form(shape: dict) -> str:
    """A GEMM shape's lhs: 'packed' (pl 1), else the float dtype its first
    launch recorded, bf16 (the LMs') where none is."""
    return "packed" if shape.get("pl", 1) else shape.get("dtype", "bfloat16")


def device_ms(fn, iters: int = 20, launches=None) -> float:
    """Device time of one fn() call in ms, host dispatch hidden: CUDA events
    around `iters` calls queued behind a spin kernel, so the card runs them
    back to back after the spin. The spin must outlast the host's enqueuing
    (the start event still pending when the last call returns), else it is
    made longer and the calls run again. With `launches` (a launch count's
    reader) given, it must grow by exactly one per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        before = launches() if launches else 0
        torch.cuda._sleep(int(spin_s * SM_CLOCK_HZ))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            break
        spin_s *= 4
    else:
        raise AssertionError(f"{iters} calls took longer to enqueue than a "
                             f"{spin_s:.3f} s spin")
    if launches and launches() - before != iters:
        raise AssertionError("not one launch per call")
    return start.elapsed_time(end) / iters


def gemm_bound(kernel: str, lhs: str, m: int, k: int, n: int,
               popc_per_s: float) -> dict:
    """Least time of one binary GEMM, in ms: the larger of the bytes (each
    operand read once, the output written once; a float32 lhs 4 bytes a
    value, bf16 2, packed words 4 per 32; `lhs` 'packed', 'float32' or
    'bfloat16') over the HBM rate and the operations, the faster of the two
    ways the card computes the +-1 dots: popc words over its popc rate, or
    2*M*N*K int8 ops over its int8 tensor-core rate."""
    kw = (k + 31) // 32
    a_bytes = m * kw * 4 if lhs == "packed" else m * k * LHS_BYTES[lhs]
    fused = kernel == "binary_gemm_fused"
    out_bytes = m * ((n + 31) // 32) * 4 if fused else m * n * 4
    nbytes = a_bytes + n * kw * 4 + (2 * n * 4 if fused else 0) + out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_popc = m * n * kw / popc_per_s * 1e3
    t_tc = 2 * m * n * k / INT8_TC_OPS_PER_S * 1e3
    t_ops = min(t_popc, t_tc)
    return {"bytes": nbytes, "popc": m * n * kw, "flops": 2 * m * n * k,
            "bytes_ms": t_bytes, "popc_ms": t_popc, "int8_tc_ms": t_tc,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}


def attention_bound(pairs: int, kv_rows: int, b: int, s: int, hq: int,
                    hkv: int, hd: int, elt: int, popc_per_s: float) -> dict:
    """Least time of one packed-attention call, in ms: the bytes it must
    move (q and out of `elt` bytes a value, the `kv_rows` K/V rows up to
    each row's last valid position, v_scale) over the HBM rate, and its
    operations over their peaks: hd/32 popcs and hd V adds for each of the
    `pairs` valid (query head, position) pairs."""
    hdw = (hd + 31) // 32
    nbytes = 2 * b * s * hq * hd * elt + 2 * kv_rows * hkv * hdw * 4 \
        + b * hkv * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(pairs * hdw / popc_per_s, pairs * hd / FP32_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "flops": pairs * (hdw + hd), "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}


def roofline(kernel: str, shape: dict[str, int], work: dict,
             sms: int | None = None) -> dict:
    """A table entry's roofline: `gemm_bound` / `attention_bound` of one
    call at `shape` (attention's q bf16), in µs. `work` holds what the
    data decides (attention's valid pairs and the K/V rows read)."""
    popc_per_s = (sms or _sms()) * POPC_PER_CLOCK_PER_SM * SM_CLOCK_HZ
    if kernel in ("binary_gemm", "binary_gemm_fused"):
        bnd = gemm_bound(kernel, lhs_form(shape), shape["m"],
                         32 * shape["kw"], shape["n"], popc_per_s)
    else:
        hq = shape["hkv"] * shape["g"]
        bnd = attention_bound(work["valid"] * hq, work["kv_rows"], shape["b"],
                              shape.get("s", 1), hq, shape["hkv"],
                              shape["hd"], 2, popc_per_s)
    nbytes = bnd["bytes"]
    return {"flops": int(bnd["flops"]), "hbm_bytes": int(nbytes),
            "ai": round(bnd["flops"] / nbytes, 3) if nbytes else None,
            "bound_us": bnd["bound_ms"] * 1e3,
            "bound_by": "bytes" if bnd["bytes_ms"] >= bnd["ops_ms"]
            else "operations"}


def _words(gen, rows: int, k: int, dev) -> torch.Tensor:
    from repro_torch.core.bitpack import pack_bits
    return pack_bits(torch.randn(rows, k, generator=gen, device=dev))


def problem(kernel: str, shape: dict[str, int], dev=None, k_short: int = 0):
    """Operands on the card at `shape` and the call's closures. Returns
    (call(route, params) -> output, check(route, params), work): `check`
    raises where the launch's output differs from the plain version's (run
    once, at the first check), `work` is what the roofline counts from the
    data. A GEMM's K is 32 * kw - `k_short` (pad bits in the last word)."""
    from repro_torch.core.bitpack import pack_bits
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref
    dev = torch.device(dev or "cuda")
    gen = torch.Generator(device=dev).manual_seed(
        sum(v for d, v in shape.items() if d != "dtype"))
    if kernel in ("binary_gemm", "binary_gemm_fused"):
        m, n, kw = shape["m"], shape["n"], shape["kw"]
        k = 32 * kw - (k_short if kw > 1 else 0)
        # pl keys the lhs form: packed words, or float activations in the
        # recorded dtype
        lhs = lhs_form(shape)
        a = _words(gen, m, k, dev) if lhs == "packed" else \
            torch.randn(m, k, generator=gen, device=dev).to(
                getattr(torch, lhs))
        b = _words(gen, n, k, dev)

        if kernel == "binary_gemm":
            plain = bg.binary_gemm_packed_plain if a.dtype == torch.int32 \
                else bg.binary_gemm_packed_rhs_plain

            def want():
                return plain(a, b, k)

            def call(route, p):
                return bg.dispatch_binary_gemm(a, b, k, route=route, **p)
        else:
            d = int(k ** 0.5)
            th = torch.randint(-d, d + 1, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
            fl = torch.randint(0, 2, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
            def want():
                return bg.binary_gemm_fused_plain(a, b, th, fl, k)

            def call(route, p):
                return bg.dispatch_binary_gemm_fused(a, b, th, fl, k,
                                                     route=route, **p)

        want = functools.cache(want)

        def exact(route, p):
            if not torch.equal(call(route, p), want()):
                raise AssertionError(f"{kernel} {p} at {shape} differs from "
                                     f"its plain version")
        return call, exact, {}
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel: {kernel}")
    decode = kernel.startswith("decode")
    b, hkv, g, hd = shape["b"], shape["hkv"], shape["g"], shape["hd"]
    s = 1 if decode else shape["s"]
    ps = shape.get("ps", 0)
    n_pages = max(1, -(-shape["t"] // ps)) if ps else 0
    t = n_pages * ps if ps else shape["t"]
    q = torch.randint(-6, 7, (b, s, hkv * g, hd), generator=gen,
                      device=dev).to(torch.bfloat16)
    kp, vp = (pack_bits(torch.randn(b, t, hkv, hd, generator=gen, device=dev))
              for _ in range(2))
    vs = 0.5 + 0.5 * torch.rand(b, hkv, generator=gen, device=dev)
    lens = torch.randint(s, t + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    qpos = lens - s
    if ps:
        # the cache scattered into a shuffled pool, as served
        pool = max(shape["p"], b * n_pages)
        perm = torch.randperm(pool, generator=gen, device=dev)[
            :b * n_pages].reshape(b, n_pages).to(torch.int32)
        hdw = kp.shape[-1]
        kc = torch.zeros((pool, ps, hkv, hdw), dtype=torch.int32, device=dev)
        vc = torch.zeros_like(kc)
        kc[perm.reshape(-1).long()] = kp.reshape(b * n_pages, ps, hkv, hdw)
        vc[perm.reshape(-1).long()] = vp.reshape(b * n_pages, ps, hkv, hdw)
        cache = (kc, vc, vs, perm)
    else:
        cache = (kp, vp, vs)
    fn = {"decode_attention": da.decode_attention_packed,
          "decode_attention_paged": da.decode_attention_packed_paged,
          "prefill_attention": pa.prefill_attention_packed,
          "prefill_attention_paged": pa.prefill_attention_packed_paged}[kernel]
    tail = (lens,) if decode else (lens, qpos)

    def call(route, p, dots=False):
        return fn(q, *cache, *tail, route=route, return_dots=dots, **p)
    plain = (da.decode_attention_packed_plain if decode
             else pa.prefill_attention_packed_plain)
    wanted = functools.cache(lambda: plain(q, kp, vp, vs, *tail,
                                           return_dots=True))

    def close(route, p):
        """Dots bit for bit (a call with dots), outputs within ATTN_TOL
        with equal signs (the call as served, and the one with dots)."""
        want, want_dots = wanted()
        out, dots = call(route, p, dots=True)
        if not torch.equal(dots, want_dots):
            raise AssertionError(f"{kernel} {p} at {shape}: dots differ")
        for out in (call(route, p), out):
            eps = ATTN_TOL[q.dtype]
            torch.testing.assert_close(out.float(), want.float(), rtol=eps,
                                       atol=eps)
            if not torch.equal(out >= 0, want >= 0):
                raise AssertionError(f"{kernel} {p} at {shape}: output "
                                     f"signs differ")
    n_valid = int(lens.sum()) if decode else \
        int((s * qpos + s * (s + 1) // 2).sum())
    return call, close, {"valid": n_valid, "kv_rows": int(lens.sum())}


def tune_bucket(kernel: str, shape: dict[str, int],
                verbose: bool = False) -> dict:
    """Tune `shape`'s bucket on the card at `shape`: hold every candidate
    to the plain version (raising on a difference), time the survivors,
    persist and return the winning entry under the bucket's key (with the
    shape, the fixed rule's launch and its time)."""
    if default_backend() == "cpu":
        raise RuntimeError("tuning needs the CUDA card: the CPU table is the "
                           "JAX package's, and every route runs the plain "
                           "version there")
    shape = {k: (v if k == "dtype" else int(v)) for k, v in shape.items()}
    sms = _sms()
    call, check, work = problem(kernel, shape)
    rows = []
    for route, params in candidates(kernel, shape, sms):
        check(route, params)
        us = device_ms(lambda: call(route, params)) * 1e3
        rows.append((us, route, params))
        if verbose:
            print(f"    {route:5s} {json.dumps(params):48s} {us:10.2f} us")
    rule_us = rows[0][0]          # candidates() lists the fixed rule first
    rows.sort(key=lambda r: r[0])
    us, route, params = rows[0]
    entry = {
        "route": route, "params": params, "us": round(us, 3),
        "shape": shape,
        "timings": {f"{r}:{json.dumps(p, sort_keys=True)}": round(u, 3)
                    for u, r, p in rows},
        "rule": {"params": rule_params(kernel, shape, sms),
                 "us": round(rule_us, 3)},
        "roofline": roofline(kernel, shape, work, sms),
    }
    del call, check
    _persist(kernel, bucket_key(shape), entry)
    if verbose:
        print(f"  -> {route} {params} @ {us:.2f} us (rule {rule_us:.2f} us, "
              f"bound {entry['roofline']['bound_us']:.3f} us)")
    return entry


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip() \
            .splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "not read"


def _persist(kernel: str, key: str, entry: dict) -> None:
    p = cache_path()
    data = dict(load_cache())
    data["_meta"] = {"backend": default_backend(),
                     "device": torch.cuda.get_device_name(0),
                     "power_limit": _smi("power.limit"),
                     "sms": _sms(), "torch": torch.__version__,
                     "cuda": torch.version.cuda}
    data.setdefault(kernel, {})[key] = entry
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    _load.cache_clear()
    forget_plans()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _cli_tune(force: bool) -> int:
    if default_backend() == "cpu":
        print("tuning runs on the CUDA card: the CPU table "
              f"({cache_path('cpu')}) is the JAX package's copy")
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    cache = load_cache()
    t0 = time.perf_counter()
    for kernel, shapes in standard_shapes().items():
        for shape in shapes:
            key = bucket_key(shape)
            if not force and key in cache.get(kernel, {}):
                print(f"{kernel} {key}: cached "
                      f"({cache[kernel][key]['route']})")
                continue
            print(f"{kernel} {key}: tuning...")
            tune_bucket(kernel, shape, verbose=True)
            cache = load_cache()
    print(f"tuned in {time.perf_counter() - t0:.1f} s -> {cache_path()}")
    return 0


def missing(backend: str | None = None) -> list[tuple[str, str]]:
    """(kernel, key) of every standard bucket the backend's table lacks."""
    cache = load_cache(backend)
    return [(k, bucket_key(s))
            for k, shapes in standard_shapes(backend).items()
            for s in shapes if bucket_key(s) not in cache.get(k, {})]


def _cli_check() -> int:
    """Every standard bucket must have a committed entry for this backend
    (on a card, a `cuda` route). Exit 1 with instructions otherwise."""
    cache = load_cache()
    gaps = missing()
    if gaps:
        print(f"tune cache {cache_path()} is missing {len(gaps)} standard "
              f"shape(s):")
        for k, key in gaps:
            print(f"  {k}: {key}")
        print("run `python -m repro_torch.kernels.tune --tune` on this host "
              "and commit the updated table.")
        return 1
    if default_backend() != "cpu":
        for kernel in KERNELS:
            for entry in cache.get(kernel, {}).values():
                check_card_route(kernel, entry["route"])
    print(f"tune cache {cache_path().name}: "
          f"{sum(len(v) for k, v in cache.items() if k != '_meta')} "
          "entries, all standard shapes covered.")
    return 0


def _cli_show() -> int:
    cache = load_cache()
    meta = cache.get("_meta", {})
    print(f"backend={meta.get('backend', default_backend())} "
          f"(cache: {cache_path()}) {meta}")
    for kernel in sorted(k for k in cache if k != "_meta"):
        print(f"\n{kernel}")
        for key, e in sorted(cache[kernel].items()):
            rl = e.get("roofline") or {}
            ai = f"  AI={rl['ai']}" if rl.get("ai") else ""
            bound = f"  bound {rl['bound_us']:.3f} us" \
                if rl.get("bound_us") is not None else ""
            rule = e.get("rule")
            rule = f"  rule {rule['us']:.2f} us" if rule else ""
            print(f"  {key:40s} -> {e['route']:6s} "
                  f"{json.dumps(e['params']):44s} {e['us']:>9.2f} us"
                  f"{rule}{bound}{ai}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tune", action="store_true",
                    help="tune the standard shapes on this card")
    ap.add_argument("--force", action="store_true",
                    help="retune even if cached")
    ap.add_argument("--check", action="store_true",
                    help="fail if the committed table misses standard shapes")
    ap.add_argument("--show", action="store_true",
                    help="print the tuned decision table")
    args = ap.parse_args(argv)
    if args.tune:
        return _cli_tune(args.force)
    if args.check:
        return _cli_check()
    if args.show:
        return _cli_show()
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
