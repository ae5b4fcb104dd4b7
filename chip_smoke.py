#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases, each of which raises on failure (nothing is caught):
  1. device  - the card's name, count, and name + power limit from nvidia-smi
  2. build   - nvcc builds every kernel from the sources in this checkout,
               one nvcc per source, all started together
  3. kernels - each Hopper kernel against its plain PyTorch version on the
               card, at the shapes the main paths give it and at ragged
               ones: int32 dots and packed words must be equal (tolerance
               0); attention outputs within rtol = atol = 2^-7 (bf16, one
               ulp) or 1e-6 (float32, 8 ulps), with equal signs
  4. mlp     - bnn-mnist (784-1024x3-10) frozen, batches of 200 through the
               kernels; hidden words and scores equal the plain path's, the
               fp32-master path's, and the CPU's on a small batch
  5. cnn     - bnn-cifar10 (128,128,256,256,512,512 convs, 1024 FC, 32x32x3)
               frozen with shift-BN, batches of 100; the same checks
  6. lm      - phi3-medium-14b at full width, depth cut to 2, frozen, served
               by ServingEngine(kv_bits=1, prefill_chunk=32, slots=4,
               max_len=512): 8 greedy requests, prompts of 17-200 tokens
               from the seed, 16 new tokens, one stopping at an eos taken
               from its own greedy run; tokens equal the plain path's on the
               card (on a difference, the first differing cache sign bit)
  7. times   - per kernel and shape: its device time (calls queued behind
               a spin kernel, CUDA events) and its wrapper's CUDA-event
               time, the plain version's, one PyTorch
               library call computing the same function where there is one,
               and the card's bound; each forward per batch, one profiled
               frozen forward each; then the LM at full depth (40 layers,
               drawn and frozen one at a time): decode tokens/s, TTFT, ITL,
               resident bytes, one profiled decode step (device busy
               share, launches)
Launch counts are set to 0 just before each main path (mlp, cnn, lm) runs
and read just after. The line before the last is {"kernels": [...]}; the
last line is {"ok": true, "device": {...}}. Weights, BN statistics and
inputs are random from the seed; image inputs are multiples of 1/128 in
[-1, 1], like 8-bit pixels. Exits non-zero, printing no result, without a
card or without the repo.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
POPC_PER_CLOCK_PER_SM = 16         # 32-bit popc issue rate, compute 9.0
GEMMS = ("binary_gemm_packed", "binary_gemm_packed_rhs", "binary_gemm_fused")
SOURCES = {**{kn: "src/repro_torch/kernels/csrc/binary_gemm.cu" for kn in GEMMS},
           "pack_bits": "src/repro_torch/kernels/csrc/pack.cu",
           "decode_attention_packed": "src/repro_torch/kernels/csrc/attention.cu",
           "prefill_attention_packed": "src/repro_torch/kernels/csrc/attention.cu"}
REPLACES = {"binary_gemm_packed": "src/repro/kernels/binary_gemm.py:107",
            "binary_gemm_packed_rhs": "src/repro/kernels/binary_gemm.py:166",
            "binary_gemm_fused": "src/repro/kernels/binary_gemm.py:242",
            "pack_bits": "src/repro/kernels/pack.py:35",
            "decode_attention_packed": "src/repro/kernels/decode_attention.py:137",
            "prefill_attention_packed": "src/repro/kernels/prefill_attention.py:131"}
SPIN_CYCLES_PER_S = 1.98e9         # H100 SXM max SM clock (torch.cuda._sleep)
RAGGED = [(9, 100, 48), (17, 64, 10), (3, 37, 33), (130, 257, 129)]
# the LM serving path: phi3-medium-14b at full width, kv_bits=1, chunked
# admission; depth cut to LM_CHECK_DEPTH where the tokens are held against
# the plain path (its SWAR popcount GEMMs are slow), all 40 layers in the
# timed run (drawn and frozen one layer at a time: all fp32 masters at once
# would be 54.5 GB)
LM_ARCH, LM_SLOTS, LM_MAX_LEN, LM_CHUNK = "phi3-medium-14b", 4, 512, 32
LM_CHECK_DEPTH = 2
LM_REQUESTS, LM_NEW, LM_PROMPT = 8, 16, (17, 200)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main_path_shapes(mlp_cfg, cnn_cfg):
    """(kernel, lhs, M, K, N, where) of every binary GEMM in one forward of
    each network, in the order the forwards launch them."""
    hid, mb = mlp_cfg.hidden, mlp_cfg.batch
    shapes = [("binary_gemm_fused", "float", mb, hid, hid, "mlp.l1"),
              ("binary_gemm_fused", "packed", mb, hid, hid, "mlp.l2"),
              ("binary_gemm_packed", "packed", mb, hid, mlp_cfg.n_classes,
               "mlp.out")]
    cb, side, cin = cnn_cfg.batch, cnn_cfg.img, cnn_cfg.widths[0]
    for i, cout in enumerate(cnn_cfg.widths[1:], start=1):
        shapes.append(("binary_gemm_packed_rhs", "float", cb * side * side,
                       9 * cin, cout, f"cnn.conv{i + 1}"))
        cin = cout
        if i % 2 == 1:
            side //= 2
    flat = (cnn_cfg.img // 8) ** 2 * cnn_cfg.widths[-1]
    shapes += [("binary_gemm_fused", "float", cb, flat, cnn_cfg.fc, "cnn.fc1"),
               ("binary_gemm_fused", "packed", cb, cnn_cfg.fc, cnn_cfg.fc,
                "cnn.fc2"),
               ("binary_gemm_packed", "packed", cb, cnn_cfg.fc,
                cnn_cfg.n_classes, "cnn.out")]
    return shapes


class Operands:
    """Random operands of one GEMM on the card: float lhs with exact zeros
    (sign(0) := +1), its packed words, packed weights, thresholds."""

    def __init__(self, gen, m, k, n):
        from repro_torch.core.bitpack import pack_bits
        dev = gen.device
        x = torch.randn(m, k, generator=gen, device=dev)
        x[torch.rand(m, k, generator=gen, device=dev) < 0.05] = 0.0
        self.m, self.k, self.n = m, k, n
        self.x = x
        self.x_bf16 = x.to(torch.bfloat16)
        self.a = pack_bits(x)
        self.b = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        d = int(k ** 0.5)
        self.thresh = torch.randint(-d, d + 1, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)
        self.flip = torch.randint(0, 2, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)

    def call(self, kernel, lhs, plain=False):
        from repro_torch.kernels import binary_gemm as bg
        a = {"float": self.x, "packed": self.a}.get(lhs)
        if lhs == "bf16":            # the LM's activations
            a = self.x_bf16
        if kernel == "binary_gemm_fused":
            fn = bg.binary_gemm_fused_plain if plain else bg.binary_gemm_fused
            return fn(a, self.b, self.thresh, self.flip, self.k)
        if kernel == "binary_gemm_packed_rhs":
            fn = bg.binary_gemm_packed_rhs_plain if plain \
                else bg.binary_gemm_packed_rhs
        else:
            fn = bg.binary_gemm_packed_plain if plain else bg.binary_gemm_packed
        return fn(a, self.b, self.k)


def max_abs_diff(got, want, words: bool) -> int:
    if words:   # compare the 32-bit words as unsigned values
        got, want = got.long() & 0xFFFFFFFF, want.long() & 0xFFFFFFFF
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def cuda_ms(fn, *, warmup=3, budget_s=0.05, max_iters=500) -> float:
    """Mean device time of fn() in ms, by CUDA events over many calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    iters = int(max(3, min(max_iters, budget_s / max(once, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, wrapper: str | None = None) -> float:
    """Device time of one fn() call in ms, host dispatch hidden: CUDA events
    around `iters` calls queued behind a spin kernel, so the card runs them
    back to back after the spin. The spin must outlast the host's enqueuing
    (the start event still pending when the last call returns), else it is
    made longer and the calls run again. With `wrapper` given, its launch
    count must grow by exactly one per call. (The profiler's trace is not
    used: it misses launches now and then, once all 20 of a kernel's.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        before = all_launches()[wrapper] if wrapper else 0
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
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
        raise AssertionError(f"{wrapper or 'library call'}: {iters} calls "
                             f"took longer to enqueue than a {spin_s:.3f} s spin")
    if wrapper and all_launches()[wrapper] - before != iters:
        raise AssertionError(f"{wrapper}: not one launch per call")
    return start.elapsed_time(end) / iters


def trace(fn, top=6):
    """One profiled call of fn: host wall ms (synchronised), device busy ms
    (the sum of its kernels' device times), kernel launches, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "busy_ms": busy,
            "launches": sum(e.count for e in kernels),
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:top]]}


def library_call(op: Operands):
    """One PyTorch call computing the same +-1 dots (the port never calls
    it): torch._int_mm on +-1 int8 where its shape rules allow, else a
    float32 matmul of +-1 operands. Operands are prepared outside the
    timing."""
    from repro_torch.core.bitpack import unpack_bits
    xs = unpack_bits(op.a, op.k)                     # (M, K) +-1
    ws = unpack_bits(op.b, op.k)                     # (N, K) +-1
    if op.m > 16 and op.k % 8 == 0 and op.n % 8 == 0:
        xi, wi = xs.to(torch.int8), ws.to(torch.int8).t()
        return "torch._int_mm", (lambda: torch._int_mm(xi, wi))
    wt = ws.t().contiguous()
    return "torch.matmul fp32", (lambda: torch.matmul(xs, wt))


def bound(kernel, lhs, m, k, n, popc_per_s):
    """Least time for the work: bytes each read or written once over HBM
    rate, popc words over the card's popc rate; plus the int8 tensor-core
    time of the same dots (2*M*N*K ops), printed beside it."""
    kw = (k + 31) // 32
    a_bytes = m * k * 4 if lhs == "float" else m * kw * 4
    out_bytes = m * ((n + 31) // 32) * 4 if kernel == "binary_gemm_fused" \
        else m * n * 4
    extra = 2 * n * 4 if kernel == "binary_gemm_fused" else 0
    nbytes = a_bytes + n * kw * 4 + extra + out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = m * n * kw / popc_per_s * 1e3
    return {"bytes": nbytes, "popc": m * n * kw, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "int8_tc_ms": 2 * m * n * k / INT8_TC_OPS_PER_S * 1e3}


def random_bn(gen, n, fan_in, spread, dev):
    """BN params and running stats in the range a trained net has: var near
    fan_in * spread (the variance of a +-1 dot), some negative gammas."""
    from repro_torch.core.shift_bn import BNParams, BNState
    var = fan_in * spread * (0.5 + torch.rand(n, generator=gen))
    return (BNParams(torch.randn(n, generator=gen).to(dev),
                     (0.1 * torch.randn(n, generator=gen)).to(dev)),
            BNState((0.2 * var.sqrt() * torch.randn(n, generator=gen)).to(dev),
                    var.to(dev), torch.zeros((), dtype=torch.int32).to(dev)))


def to_device(tree, dev):
    from repro_torch.core.packed import PackedWeight, map_tree
    return map_tree(lambda _, p: p.to(dev)
                    if isinstance(p, (torch.Tensor, PackedWeight)) else p, tree)


def check_equal(what, got, want):
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: results differ")


# ---------------------------------------------------------------------------
# The LM serving path: kernels A (pack), B (decode attention), C (prefill
# attention) and the engine
# ---------------------------------------------------------------------------
def lm_modules():
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import pack as pk
    from repro_torch.kernels import prefill_attention as pa
    return bg, pk, da, pa


def reset_all_launches() -> None:
    for mod in lm_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in lm_modules():
        out.update(mod.launches)
    return out


def pack_check_shapes(cfg):
    """(M, K) of every sign-pack on the LM path, per layer: the normed
    residual of a decode step and of a chunk (for Q/K/V, then gate/up) and
    the new K/V rows, (rows * Hkv, hd); the (M, d_ff) lhs too."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return [(LM_SLOTS, cfg.d_model, "decode x2"),
            (LM_SLOTS * hkv, hd, "decode kv x2"),
            (LM_CHUNK, cfg.d_model, "chunk x2"),
            (LM_CHUNK * hkv, hd, "chunk kv x2"),
            (LM_SLOTS, cfg.d_ff, "check"), (LM_CHUNK, cfg.d_ff, "check")]


def attention_case(gen, b, s, t, hkv, g, hd, dtype, dev):
    """Integer-valued queries (rope'd popcount dots are such values), packed
    sign K/V and V scales, on the card."""
    from repro_torch.core.bitpack import pack_bits
    q = torch.randint(-6, 7, (b, s, hkv * g, hd), generator=gen,
                      device=dev).to(dtype)
    k, v = (pack_bits(torch.randn(b, t, hkv, hd, generator=gen, device=dev))
            for _ in range(2))
    vs = 0.5 + 0.5 * torch.rand(b, hkv, generator=gen, device=dev)
    return q, k, v, vs


def attention_bound(valid, s, hq, hkv, hd, elt, popc_per_s):
    """Least time of one packed-attention call: the bytes it must move
    (q, out, the K/V rows up to each row's last valid position, v_scale)
    over HBM rate, and its operations over their peaks: hd/32 popcs and hd
    V adds per valid (query head, position) pair."""
    b, _, t = valid.shape
    hdw = (hd + 31) // 32
    pairs = int(valid.sum()) * hq
    last = valid.any(dim=1).int() * torch.arange(1, t + 1, device=valid.device)
    kv_rows = int(last.amax(dim=1).sum())
    nbytes = 2 * b * s * hq * hd * elt + 2 * kv_rows * hkv * hdw * 4 + b * hkv * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(pairs * hdw / popc_per_s, pairs * hd / FP32_OPS_PER_S) * 1e3
    return {"bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops)}


def sdpa_call(q, k, v, vs, valid):
    """One PyTorch call computing the same function (the port never calls
    it): scaled_dot_product_attention over sign(q) and the unpacked +-1 K/V
    with the same mask, times v_scale. Operands are prepared outside the
    timing."""
    import torch.nn.functional as F
    from repro_torch.core.bitpack import unpack_bits
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qs = torch.where(q >= 0, 1.0, -1.0).to(q.dtype).transpose(1, 2)
    ks, vv = (unpack_bits(x, hd, dtype=q.dtype).transpose(1, 2)
              .repeat_interleave(g, dim=1).contiguous() for x in (k, v))
    mask = valid[:, None]
    scale = vs.repeat_interleave(g, dim=1)[:, :, None, None].to(q.dtype)

    def call():
        out = F.scaled_dot_product_attention(qs, ks, vv, attn_mask=mask,
                                             scale=1.0 / hd ** 0.5)
        return out * scale
    return lambda: call().transpose(1, 2)


# attention outputs, kernel against plain version: the sums are exact in
# both, exp may differ by an ulp between the CUDA math library and torch's
ATTN_TOL = {torch.bfloat16: 2.0 ** -7,     # one bf16 ulp at 1
            torch.float32: 1e-6}           # 8 float32 ulps at 1


def check_close(what, got, want, dtype):
    """Attention outputs: within ATTN_TOL of their type (rtol = atol), and
    the same sign everywhere (all that the next projection reads)."""
    eps = ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=eps, atol=eps,
                               msg=lambda m: f"{what}: {m}")
    if not torch.equal(got >= 0, want >= 0):
        raise AssertionError(f"{what}: output signs differ")
    return err


def lm_kernel_checks(cfg, dev_gen, dev):
    """Kernels A, B, C against their plain versions on the card at the LM's
    main-path shapes and at ragged ones. Words and integer dots: tolerance
    0. Attention outputs: ATTN_TOL, signs equal."""
    _, pk, da, pa = lm_modules()
    err = {"pack_bits": 0, "decode_attention_packed": 0.0,
           "prefill_attention_packed": 0.0}
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    for m, k, where in pack_check_shapes(cfg) + [(3, 31, "ragged"),
                                                 (5, 33, "ragged"),
                                                 (7, 1000, "ragged")]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(m, k, generator=dev_gen, device=dev).to(dtype)
            x.view(-1)[::13] = -0.0
            x.view(-1)[5::17] = float("nan")
            got = pk.pack_bits_kernel(x)
            torch.cuda.synchronize()
            d = max_abs_diff(got, pk.pack_bits_plain(x), words=True)
            err["pack_bits"] = max(err["pack_bits"], d)
            print(f"check pack_bits {str(dtype)[6:]:8s} M={m:5d} K={k:5d} "
                  f"{where:12s} max_abs_err={d}")
            if d:
                raise AssertionError(f"pack_bits ({m},{k}) differs from its "
                                     f"plain version by {d}")
    decode_cases = [(LM_SLOTS, LM_MAX_LEN, hkv, g, hd, 0, "main"),
                    (3, 37, 2, 1, 33, 0, "ragged"), (2, 70, 1, 8, 64, 9, "ragged"),
                    (5, 33, 3, 2, 128, 0, "ragged")]
    for b, t, nkv, gg, d_h, window, where in decode_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs = attention_case(dev_gen, b, 1, t, nkv, gg, d_h,
                                         dtype, dev)
            lens = torch.randint(1, t + 1, (b,), generator=dev_gen, device=dev,
                                 dtype=torch.int32)
            lens[0] = 1
            got, dots = da.decode_attention_packed(q, k, v, vs, lens,
                                                   window=window,
                                                   return_dots=True)
            torch.cuda.synchronize()
            want, wdots = da.decode_attention_packed_plain(
                q, k, v, vs, lens, window=window, return_dots=True)
            if not torch.equal(dots, wdots):
                raise AssertionError(f"decode dots ({b},{t},{nkv},{gg},{d_h})")
            e = check_close(f"decode ({b},{t},{nkv},{gg},{d_h},{window})",
                            got, want, dtype)
            err["decode_attention_packed"] = max(err["decode_attention_packed"], e)
            print(f"check decode_attention_packed {str(dtype)[6:]:8s} B={b} "
                  f"T={t} Hkv={nkv} G={gg} hd={d_h} window={window} {where} "
                  f"dots equal, max_abs_err={e:.3g}")
    prefill_cases = [(1, LM_CHUNK, LM_MAX_LEN, hkv, g, hd, 96, 0, True, "main"),
                     (1, LM_CHUNK, LM_MAX_LEN, hkv, g, hd, 0, 0, True, "main"),
                     (2, 7, 45, 2, 1, 33, 11, 5, True, "ragged"),
                     (1, 16, 70, 1, 8, 64, 40, 0, False, "ragged"),
                     (3, 5, 40, 2, 2, 16, 0, 0, True, "ragged")]
    for b, s, t, nkv, gg, d_h, qp, window, causal, where in prefill_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, vs = attention_case(dev_gen, b, s, t, nkv, gg, d_h,
                                         dtype, dev)
            got, dots = pa.prefill_attention_packed(
                q, k, v, vs, qp + s, qp, window=window, causal=causal,
                return_dots=True)
            torch.cuda.synchronize()
            want, wdots = pa.prefill_attention_packed_plain(
                q, k, v, vs, qp + s, qp, window=window, causal=causal,
                return_dots=True)
            if not torch.equal(dots, wdots):
                raise AssertionError(f"prefill dots ({b},{s},{t})")
            e = check_close(f"prefill ({b},{s},{t},{nkv},{gg},{d_h})", got,
                            want, dtype)
            err["prefill_attention_packed"] = max(
                err["prefill_attention_packed"], e)
            print(f"check prefill_attention_packed {str(dtype)[6:]:8s} B={b} "
                  f"S={s} T={t} Hkv={nkv} G={gg} hd={d_h} q_pos={qp} "
                  f"window={window} causal={causal} {where} dots equal, "
                  f"max_abs_err={e:.3g}")
    # a one-row chunk at q_pos = kv_len - 1 is a decode step
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, LM_MAX_LEN, hkv, g, hd,
                                 torch.bfloat16, dev)
    lens = torch.tensor([1, 100, 333, 512], dtype=torch.int32, device=dev)
    check_equal("prefill S=1 vs decode",
                pa.prefill_attention_packed(q, k, v, vs, lens, lens - 1),
                da.decode_attention_packed(q, k, v, vs, lens))
    zero = da.decode_attention_packed(q, k, v, vs, 0)
    if not (zero == 0).all():
        raise AssertionError("cache_len 0 must give 0")
    print("check prefill S=1 equals decode; cache_len 0 gives 0")
    return err


def lm_traffic(seed, vocab):
    """LM_REQUESTS prompts with lengths drawn from the seed in LM_PROMPT."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def lm_engine(cfg, params, **kw):
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, kv_bits=1, prefill_chunk=LM_CHUNK,
                         slots=LM_SLOTS, max_len=LM_MAX_LEN, **kw)


def first_sign_difference(cfg, frozen, prompt, tokens, dev):
    """Replay one request alone through the kernels and the plain versions
    (its chunks, then decode steps fed the kernel path's tokens) and return
    the first (step, layer, position, KV head, bit) whose cache sign bit
    differs, or None."""
    from repro_torch.models import transformer as T
    caches = {p: T.init_cache(cfg, 1, LM_MAX_LEN, device=dev)
              for p in ("auto", "ref")}

    def diff(step):
        for name in ("k", "v"):
            x = caches["auto"][name] ^ caches["ref"][name]
            if x.any():
                layer, _, pos, head, word = (int(i) for i in x.nonzero()[0])
                w = int(x[layer, 0, pos, head, word]) & 0xFFFFFFFF
                bit = 32 * word + (w & -w).bit_length() - 1
                return (step, layer, f"{name} position {pos}", head, bit)
        return None

    for lo in range(0, len(prompt), LM_CHUNK):
        nv = min(LM_CHUNK, len(prompt) - lo)
        ch = torch.zeros((1, LM_CHUNK), dtype=torch.int64, device=dev)
        ch[0, :nv] = torch.from_numpy(prompt[lo:lo + nv].astype(np.int64))
        for path in caches:
            T.transformer_prefill_chunk(frozen, cfg, ch, caches[path], 0, lo,
                                        nv, path=path)
        found = diff(f"chunk at {lo}")
        if found:
            return found
    for i, tok in enumerate(tokens[:-1]):
        token = torch.tensor([int(tok)], device=dev)
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        for path in caches:
            T.transformer_decode(frozen, cfg, token, caches[path], pos,
                                 path=path)
        found = diff(f"decode step {i + 1}")
        if found:
            return found
    return None


def lm_engine_check(base_cfg, seed, dev):
    """Full width, depth LM_CHECK_DEPTH: the engine's greedy tokens through
    the kernels equal its tokens through the plain versions, on the card.
    Returns the launch counts of the kernel run (the main path)."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    cfg = base_cfg.scaled(n_layers=LM_CHECK_DEPTH, kv_bits=1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    masters = get_model(cfg).init(gen, device=dev)
    eng = lm_engine(cfg, masters, freeze=True, seed=seed)
    frozen = eng.params
    del masters
    torch.cuda.empty_cache()
    plain = lm_engine(cfg, frozen, kernel_path="ref", seed=seed)
    prompts = lm_traffic(seed, cfg.vocab)
    alone = eng.generate([Request(prompts[5], max_new_tokens=LM_NEW)])[0]
    eos = int(alone[7])          # request 5 stops at its own 8th token
    reqs = [Request(p, max_new_tokens=LM_NEW, eos_id=eos if i == 5 else None)
            for i, p in enumerate(prompts)]
    reset_all_launches()
    got = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = all_launches()
    want = plain.generate(reqs)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            where = first_sign_difference(cfg, frozen, prompts[i], a, dev)
            raise AssertionError(
                f"LM request {i}: kernel tokens {a.tolist()} != plain "
                f"{b.tolist()}; first differing sign bit (step, layer, "
                f"position, head, bit): {where}")
    if got[5][-1] != eos or len(got[5]) > 8:
        raise AssertionError(f"request 5 did not stop at eos {eos}: {got[5]}")
    if any(len(t) != LM_NEW for i, t in enumerate(got) if i != 5):
        raise AssertionError("a request did not get its budget")
    n_chunks = sum(-(-len(p) // LM_CHUNK) for p in prompts)
    if launches["prefill_attention_packed"] != n_chunks * LM_CHECK_DEPTH:
        raise AssertionError(f"prefill launches {launches} != "
                             f"{n_chunks} chunks x {LM_CHECK_DEPTH} layers")
    for kn in ("pack_bits", "decode_attention_packed", "binary_gemm_packed",
               "binary_gemm_packed_rhs"):
        if not launches[kn]:
            raise AssertionError(f"the LM path launched no {kn}")
    if launches["binary_gemm_fused"]:
        raise AssertionError("the LM path has no fused-epilogue GEMM")
    print(f"lm engine check: {LM_ARCH} full width, depth {LM_CHECK_DEPTH} "
          f"(cut from {base_cfg.n_layers}), {LM_REQUESTS} requests, prompts "
          f"{sorted(len(p) for p in prompts)}, {LM_NEW} new tokens, request 5 "
          f"stops at eos {eos} after {len(got[5])}: tokens equal the plain "
          f"path's; launches {launches}")
    del eng, plain, frozen
    torch.cuda.empty_cache()
    return launches, n_chunks


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def lm_timed_run(base_cfg, seed, dev, card):
    """Full width and depth: the same engine and traffic, timed, the
    weights drawn and frozen one layer at a time (`Model.init_frozen`).
    Returns the report and the frozen engine (for the profiled decode
    step)."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request
    cfg = base_cfg.scaled(kv_bits=1)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frozen = get_model(cfg).init_frozen(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d, hd = cfg.d_model, cfg.head_dim
    master_layer = 4 * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                        + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    eng = lm_engine(cfg, frozen, freeze=True, seed=seed)
    del frozen
    prompts = lm_traffic(seed, cfg.vocab)
    eng.generate([Request(prompts[0][:40], max_new_tokens=4)])     # warm-up
    reqs = [Request(p, max_new_tokens=LM_NEW) for p in prompts]
    sched = eng.scheduler()
    before = dict(sched.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = eng.serve(reqs)
    wall = time.perf_counter() - t0
    st = {k: sched.stats[k] - before[k] for k in ("decode_s", "prefill_s",
                                                 "decode_steps", "bursts",
                                                 "tokens_out")}
    decode_tokens = sum(len(c.tokens) - 1 for c in comps)
    itl = np.concatenate([c.itl for c in comps])
    w = eng.resident_weight_bytes()
    c = eng.resident_cache_bytes()
    bf16_cache = 2 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.n_kv_heads * \
        cfg.head_dim * 2
    rep = {
        "depth": cfg.n_layers, "init_frozen_s": init_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "wall_s": wall, "decode_s": st["decode_s"], "prefill_s": st["prefill_s"],
        "decode_steps": st["decode_steps"], "bursts": st["bursts"],
        "decode_tokens": decode_tokens,
        "decode_tok_per_s": decode_tokens / st["decode_s"],
        "prefill_tok_per_s": sum(map(len, prompts)) / st["prefill_s"],
        "ttft_ms_p50": percentile([c.ttft for c in comps], 50) * 1e3,
        "ttft_ms_p99": percentile([c.ttft for c in comps], 99) * 1e3,
        "ttft_wall_ms_p50": percentile([c.ttft_wall for c in comps], 50) * 1e3,
        "itl_ms_p50": percentile(itl, 50) * 1e3,
        "itl_ms_p99": percentile(itl, 99) * 1e3,
        "binary_bytes_per_layer": w["binary"] // cfg.n_layers,
        "master_bytes_per_layer": master_layer,
        "cache_packed_bytes": c["packed"], "cache_float_bytes": c["float"],
        "cache_bf16_bytes": bf16_cache}
    print(f"lm timed run on {card}: {LM_ARCH} full width and depth "
          f"({cfg.n_layers} layers, not cut; drawn and frozen layer by layer "
          f"in {init_s:.1f} s), {LM_REQUESTS} requests, {LM_SLOTS} slots, "
          f"chunk {LM_CHUNK}, max_len {LM_MAX_LEN}; peak device memory "
          f"{rep['peak_device_bytes'] / 1e9:.2f} GB")
    print(f"  wall {wall:.4f} s; decode {decode_tokens} tokens in "
          f"{st['decode_s']:.4f} s over {st['decode_steps']} steps / "
          f"{st['bursts']} bursts = {rep['decode_tok_per_s']:.2f} tok/s; "
          f"prefill {rep['prefill_tok_per_s']:.1f} tok/s")
    print(f"  TTFT (own admission) p50 {rep['ttft_ms_p50']:.3f} ms, p99 "
          f"{rep['ttft_ms_p99']:.3f} ms; TTFT wall p50 "
          f"{rep['ttft_wall_ms_p50']:.3f} ms; ITL p50 {rep['itl_ms_p50']:.3f} "
          f"ms, p99 {rep['itl_ms_p99']:.3f} ms")
    print(f"  resident weights per layer: {rep['binary_bytes_per_layer'] / 1e6:.1f}"
          f" MB packed vs {master_layer / 1e9:.3f} GB fp32 "
          f"({master_layer / rep['binary_bytes_per_layer']:.1f}x); cache "
          f"{c['packed'] / 1e6:.2f} MB packed + {c['float']} B V scales vs "
          f"{bf16_cache / 1e6:.2f} MB bf16 ({bf16_cache / c['packed']:.1f}x)")
    return rep, eng


def shape_times(call, kn, plain, library=None):
    """The times of kernel `kn` at one shape: `ms` its device time
    (`device_ms`), `wrapper_ms` the CUDA-event time of back-to-back wrapper
    calls (host checks and the ctypes call included), `plain_ms` the
    CUDA-event time of its plain version, `library_ms` the device time of
    the library call and `library_wall_ms` its CUDA-event time."""
    out = {"ms": device_ms(call, wrapper=kn),
           "wrapper_ms": cuda_ms(call),
           "plain_ms": cuda_ms(plain, warmup=1, budget_s=0.2, max_iters=10),
           "library_ms": None, "library_wall_ms": None}
    if library is not None:
        out["library_ms"] = device_ms(library)
        out["library_wall_ms"] = cuda_ms(library)
    return out


def lm_kernel_times(cfg, dev_gen, dev, popc_per_s):
    """Times of kernels A, B, C at the LM's main-path shapes (bf16
    activations, see `shape_times`) beside their bounds, plain versions and, for
    B and C, one PyTorch call (SDPA) computing the same function. Returns
    the rows and the per-kernel sums over one layer's launches in one
    decode step and one prefill chunk."""
    from repro_torch.kernels import ref
    _, pk, da, pa = lm_modules()
    hkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    rows = []
    for m, k, where in pack_check_shapes(cfg)[:4]:
        x = torch.randn(m, k, generator=dev_gen, device=dev).to(torch.bfloat16)
        nbytes = m * k * 2 + m * ((k + 31) // 32) * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = m * k / FP32_OPS_PER_S * 1e3
        rows.append({"kernel": "pack_bits", "where": where, "shape": (m, k),
                     "per_layer": 2, "library": None,
                     **shape_times(lambda: pk.pack_bits_kernel(x),
                                   "pack_bits",
                                   lambda: pk.pack_bits_plain(x)),
                     "bytes_ms": t_bytes, "ops_ms": t_ops,
                     "bound_ms": max(t_bytes, t_ops)})
    lens = torch.tensor([LM_MAX_LEN, 300, 100, 17], dtype=torch.int32,
                        device=dev)
    q, k, v, vs = attention_case(dev_gen, LM_SLOTS, 1, LM_MAX_LEN, hkv, g, hd,
                                 torch.bfloat16, dev)
    valid = ref.chunk_valid_mask(LM_SLOTS, 1, LM_MAX_LEN, lens, lens - 1, 0,
                                 True, device=dev)
    lib = sdpa_call(q, k, v, vs, valid)
    check_close_loose("SDPA vs decode kernel", lib(),
                      da.decode_attention_packed(q, k, v, vs, lens))
    rows.append({"kernel": "decode_attention_packed",
                 "where": f"decode B={LM_SLOTS} T={LM_MAX_LEN} lens "
                          f"{lens.tolist()}", "shape": tuple(q.shape),
                 "per_layer": 1, "library": "F.scaled_dot_product_attention",
                 **shape_times(
                     lambda: da.decode_attention_packed(q, k, v, vs, lens),
                     "decode_attention_packed",
                     lambda: da.decode_attention_packed_plain(
                         q, k, v, vs, lens), lib),
                 **attention_bound(valid, 1, cfg.n_heads, hkv, hd, 2, popc_per_s)})
    for qp in (0, 96):
        q, k, v, vs = attention_case(dev_gen, 1, LM_CHUNK, LM_MAX_LEN, hkv, g,
                                     hd, torch.bfloat16, dev)
        kv = qp + LM_CHUNK
        valid = ref.chunk_valid_mask(1, LM_CHUNK, LM_MAX_LEN, kv, qp, 0, True,
                                     device=dev)
        lib = sdpa_call(q, k, v, vs, valid)
        check_close_loose("SDPA vs prefill kernel", lib(),
                          pa.prefill_attention_packed(q, k, v, vs, kv, qp))
        rows.append({"kernel": "prefill_attention_packed",
                     "where": f"chunk S={LM_CHUNK} q_pos={qp} T={LM_MAX_LEN}",
                     "shape": tuple(q.shape), "per_layer": 0.5,
                     "library": "F.scaled_dot_product_attention",
                     **shape_times(
                         lambda: pa.prefill_attention_packed(
                             q, k, v, vs, kv, qp),
                         "prefill_attention_packed",
                         lambda: pa.prefill_attention_packed_plain(
                             q, k, v, vs, kv, qp), lib),
                     **attention_bound(valid, LM_CHUNK, cfg.n_heads, hkv, hd,
                                       2, popc_per_s)})
    totals = {}
    for r in rows:
        t = totals.setdefault(r["kernel"], {
            "ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None,
            "library_wall_ms": None})
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bytes_ms",
                    "ops_ms"):
            t[key] += r[key] * r["per_layer"]
        for key in ("library_ms", "library_wall_ms"):
            if r[key] is not None:
                t[key] = (t[key] or 0.0) + r[key] * r["per_layer"]
    return rows, totals


def check_close_loose(what, lib, kern):
    """The library call computes the same function: within bf16 rounding of
    the kernel (atol 2e-2 on outputs of size <= 1)."""
    err = float((lib.float() - kern.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"{what}: differs by {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from repro_torch.configs.bnn_paper import BNN_CIFAR10, BNN_MNIST
    from repro_torch.kernels import _build
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.models import paper_nets as pn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    popc_per_s = sms * POPC_PER_CLOCK_PER_SM * max_mhz * 1e6
    print(f"device: {name}, count {count}, {sms} SMs, max SM clock "
          f"{max_mhz:.0f} MHz, popc peak {popc_per_s / 1e12:.3f} T/s")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    report = {"card": card, "device": name, "kernels": {}, "forwards": {}}

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = _build.build_all()
    nvcc_ver = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                              capture_output=True, text=True).stdout
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{nvcc_ver.strip().splitlines()[-1]}")
    for b in built.values():
        print(f"  {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"    {line.strip()}")

    # --------------------------------------------- kernels vs plain on card
    gen = torch.Generator().manual_seed(args.seed)
    shapes = main_path_shapes(BNN_MNIST, BNN_CIFAR10)
    checks = [(kn, lhs, m, k, n, where) for kn, lhs, m, k, n, where in shapes]
    for m, k, n in RAGGED:
        checks += [("binary_gemm_packed", "packed", m, k, n, "ragged"),
                   ("binary_gemm_packed_rhs", "float", m, k, n, "ragged"),
                   ("binary_gemm_fused", "float", m, k, n, "ragged"),
                   ("binary_gemm_fused", "packed", m, k, n, "ragged")]
    # the LM's GEMMs at chunk and decode rows: Q|K|V and gate|up read the
    # shared packed lhs, wo and w_down a bf16 one
    for m, where in ((LM_CHUNK, "lm.chunk"), (LM_SLOTS, "lm.decode")):
        checks += [("binary_gemm_packed", "packed", m, 5120, 1280, where),
                   ("binary_gemm_packed", "packed", m, 5120, 17920, where),
                   ("binary_gemm_packed_rhs", "bf16", m, 5120, 5120, where),
                   ("binary_gemm_packed_rhs", "bf16", m, 17920, 5120, where),
                   ("binary_gemm_fused", "bf16", m, 300, 77, "ragged")]
    err = {kn: 0 for kn in REPLACES}
    dev_gen = torch.Generator(device=dev).manual_seed(args.seed)
    operands = {}
    for kn, lhs, m, k, n, where in checks:
        if (m, k, n) not in operands:
            operands[(m, k, n)] = Operands(dev_gen, m, k, n)
        op = operands[(m, k, n)]
        got = op.call(kn, lhs)
        torch.cuda.synchronize()
        want = op.call(kn, lhs, plain=True)
        torch.cuda.synchronize()
        d = max_abs_diff(got, want, words=kn == "binary_gemm_fused")
        err[kn] = max(err[kn], d)
        print(f"check {kn:24s} {lhs:6s} M={m:6d} K={k:5d} N={n:5d} "
              f"{where:9s} max_abs_err={d}")
        if d:
            raise AssertionError(f"{kn} {lhs} ({m},{k},{n}) differs from "
                                 f"its plain version by {d}")
    for key in [key for key in operands if key[1] in (5120, 17920)]:
        del operands[key]                  # the LM's GEMM operands
    from repro_torch.configs.base import get_config
    lm_cfg = get_config(LM_ARCH)
    err.update(lm_kernel_checks(lm_cfg, dev_gen, dev))

    # ------------------------------------------------------------------ mlp
    cfg = BNN_MNIST
    params = pn.init_mlp(gen, cfg.in_dim, cfg.hidden, cfg.n_hidden,
                         cfg.n_classes, device=dev)
    frozen = pn.freeze_mlp(params)
    n_batches = 3
    xs = [(torch.round((torch.rand(cfg.batch, cfg.in_dim, generator=gen)
                        * 2 - 1) * 128) / 128).to(dev)
          for _ in range(n_batches)]
    bg.reset_launches()
    outs = []
    for x in xs:
        hidden = []
        outs.append((pn.mlp_forward(frozen, x, hidden=hidden), hidden))
    torch.cuda.synchronize()
    mlp_launches = dict(bg.launches)
    want = {"binary_gemm_fused": 2 * n_batches,
            "binary_gemm_packed": n_batches, "binary_gemm_packed_rhs": 0}
    if mlp_launches != want:
        raise AssertionError(f"mlp launches {mlp_launches} != {want}")
    for x, (scores, hidden) in zip(xs, outs):
        if scores.shape != (cfg.batch, cfg.n_classes) \
                or not torch.isfinite(scores).all():
            raise AssertionError("mlp scores are not finite (B, 10)")
        plain_hidden = []
        check_equal("mlp scores vs plain path", scores,
                    pn.mlp_forward(frozen, x, kernel_path="ref",
                                   hidden=plain_hidden))
        for h, p in zip(hidden, plain_hidden, strict=True):
            check_equal("mlp hidden words vs plain path", h.packed, p.packed)
        check_equal("mlp scores vs fp32 masters", scores,
                    pn.mlp_forward(params, x))
    check_equal("mlp scores vs CPU", outs[0][0][:8],
                pn.mlp_forward(to_device(frozen, "cpu"), xs[0][:8].cpu()))
    print(f"mlp: {n_batches} batches of {cfg.batch}, launches {mlp_launches}, "
          f"scores and {len(outs[0][1])} hidden words per batch equal the "
          f"plain path's and the masters'")

    # ------------------------------------------------------------------ cnn
    cfg = BNN_CIFAR10
    params, bn = pn.init_cnn(gen, cfg.in_ch, cfg.widths, cfg.fc,
                             cfg.n_classes, cfg.img, device=dev)
    fan_in = [9 * cfg.in_ch] + [9 * w for w in cfg.widths[:-1]]
    for i, cp in enumerate(params["convs"]):
        spread = 1 / 3 if i == 0 else 1.0   # float pixels vs +-1 inputs
        cp["bn"], bn["convs"][i] = random_bn(gen, cfg.widths[i], fan_in[i],
                                             spread, dev)
    flat = (cfg.img // 8) ** 2 * cfg.widths[-1]
    params["fc1"]["bn"], bn["fc1"] = random_bn(gen, cfg.fc, flat, 1.0, dev)
    params["fc2"]["bn"], bn["fc2"] = random_bn(gen, cfg.fc, cfg.fc, 1.0, dev)
    frozen = pn.freeze_cnn(params, bn, bn_kind=cfg.bn_kind)
    n_batches = 2
    xs = [(torch.round((torch.rand(cfg.batch, cfg.img, cfg.img, cfg.in_ch,
                                   generator=gen) * 2 - 1) * 128) / 128).to(dev)
          for _ in range(n_batches)]
    bg.reset_launches()
    outs = []
    for x in xs:
        hidden = []
        outs.append((pn.cnn_forward(frozen, bn, x, bn_kind=cfg.bn_kind,
                                    hidden=hidden)[0], hidden))
    torch.cuda.synchronize()
    cnn_launches = dict(bg.launches)
    n_binary_convs = len(cfg.widths) - 1
    want = {"binary_gemm_packed_rhs": n_binary_convs * n_batches,
            "binary_gemm_fused": 2 * n_batches,
            "binary_gemm_packed": n_batches}
    if cnn_launches != want:
        raise AssertionError(f"cnn launches {cnn_launches} != {want}")
    for x, (scores, hidden) in zip(xs, outs):
        if scores.shape != (cfg.batch, cfg.n_classes) \
                or not torch.isfinite(scores).all():
            raise AssertionError("cnn scores are not finite (B, 10)")
        plain_hidden = []
        check_equal("cnn scores vs plain path", scores, pn.cnn_forward(
            frozen, bn, x, bn_kind=cfg.bn_kind, kernel_path="ref",
            hidden=plain_hidden)[0])
        for h, p in zip(hidden, plain_hidden, strict=True):
            check_equal("cnn hidden words vs plain path", h.packed, p.packed)
        check_equal("cnn scores vs fp32 masters", scores,
                    pn.cnn_forward(params, bn, x, bn_kind=cfg.bn_kind)[0])
    check_equal("cnn scores vs CPU", outs[0][0][:2], pn.cnn_forward(
        to_device(frozen, "cpu"), to_device(bn, "cpu"), xs[0][:2].cpu(),
        bn_kind=cfg.bn_kind)[0])
    bits = [h.unpack() for h in outs[0][1]]
    print(f"cnn: {n_batches} batches of {cfg.batch}, launches {cnn_launches}, "
          f"scores and {len(outs[0][1])} hidden words per batch equal the "
          f"plain path; share of +1 bits in fc1/fc2: "
          + ", ".join(f"{float((b > 0).float().mean()):.3f}" for b in bits))

    # ------------------------------------------------ lm: tokens vs plain
    lm_launches, lm_chunks = lm_engine_check(lm_cfg, args.seed, dev)
    path_launches = {kn: mlp_launches.get(kn, 0) + cnn_launches.get(kn, 0)
                     + lm_launches[kn] for kn in REPLACES}

    # ---------------------------------------------------------------- times
    print(f"times on {card} (ms; kernel and library: device time, CUDA "
          f"events over calls queued behind a spin kernel; wrapper, plain "
          f"and library wall: CUDA events over back-to-back calls; bound = max(bytes / 3.35 TB/s, popc / "
          f"{popc_per_s / 1e12:.3f} T/s); int8 TC = 2MNK / 1979 TOP/s)")
    totals = {kn: {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": 0.0, "library_wall_ms": 0.0}
              for kn in REPLACES}
    rows = []
    for kn, lhs, m, k, n, where in shapes:
        op = operands[(m, k, n)]
        lib_name, lib_fn = library_call(op)
        got = lib_fn()
        ref_dots = op.call("binary_gemm_packed", "packed")
        check_equal(f"{lib_name} vs kernel dots {where}", got.to(torch.int32),
                    ref_dots)
        row = {"kernel": kn, "lhs": lhs, "M": m, "K": k, "N": n,
               "where": where, "library": lib_name,
               **shape_times(lambda: op.call(kn, lhs), kn,
                             lambda: op.call(kn, lhs, plain=True), lib_fn),
               **bound(kn, lhs, m, k, n, popc_per_s)}
        rows.append(row)
        for key in totals[kn]:
            totals[kn][key] += row[key]
        print(f"  {where:9s} {kn:24s} {lhs:6s} M={m:6d} K={k:5d} N={n:5d} "
              f"kernel {row['ms']:.4f} (wrapper {row['wrapper_ms']:.4f})  "
              f"plain {row['plain_ms']:.3f}  {lib_name} "
              f"{row['library_ms']:.4f} (wall {row['library_wall_ms']:.4f})"
              f"  bound "
              f"{row['bound_ms']:.4f} ({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'popc'})"
              f"  int8 TC {row['int8_tc_ms']:.4f}")
    operands.clear()
    report["shapes"] = rows

    fwd = {}
    cfg_m, cfg_c = BNN_MNIST, BNN_CIFAR10
    mlp_params = pn.init_mlp(gen, cfg_m.in_dim, cfg_m.hidden, cfg_m.n_hidden,
                             cfg_m.n_classes, device=dev)
    mlp_frozen = pn.freeze_mlp(mlp_params)
    xm = (torch.round((torch.rand(cfg_m.batch, cfg_m.in_dim, generator=gen)
                       * 2 - 1) * 128) / 128).to(dev)
    xc = xs[0]
    fwd["mlp frozen (kernels)"] = cuda_ms(lambda: pn.mlp_forward(mlp_frozen, xm))
    fwd["mlp frozen (plain)"] = cuda_ms(
        lambda: pn.mlp_forward(mlp_frozen, xm, kernel_path="ref"), warmup=1)
    fwd["mlp fp32 masters"] = cuda_ms(lambda: pn.mlp_forward(mlp_params, xm))
    fwd["cnn frozen (kernels)"] = cuda_ms(
        lambda: pn.cnn_forward(frozen, bn, xc, bn_kind=cfg_c.bn_kind), warmup=2)
    fwd["cnn frozen (plain)"] = cuda_ms(
        lambda: pn.cnn_forward(frozen, bn, xc, bn_kind=cfg_c.bn_kind,
                               kernel_path="ref"), warmup=1, max_iters=5)
    fwd["cnn fp32 masters"] = cuda_ms(
        lambda: pn.cnn_forward(params, bn, xc, bn_kind=cfg_c.bn_kind), warmup=2)
    print(f"forward per batch on {card} (ms; mlp batch {cfg_m.batch}, "
          f"cnn batch {cfg_c.batch}):")
    for key, ms in fwd.items():
        print(f"  {key:22s} {ms:.4f}")
    report["forwards"] = fwd

    # where a frozen forward's time goes: one profiled call each
    traces = {
        "mlp": trace(lambda: pn.mlp_forward(mlp_frozen, xm)),
        "cnn": trace(lambda: pn.cnn_forward(frozen, bn, xc,
                                            bn_kind=cfg_c.bn_kind))}
    for key, t in traces.items():
        share = t["busy_ms"] / t["wall_ms"] if t["wall_ms"] else 0.0
        print(f"trace {key} frozen on {card}: wall {t['wall_ms']:.4f} ms "
              f"(profiled), device busy {t['busy_ms']:.4f} ms ({share:.3f} "
              f"of wall), {t['launches']} kernel launches; top kernels:")
        for kname, cnt, ms in t["top"]:
            print(f"    {ms:9.4f} ms  x{cnt:<3d} {kname}")
    report["traces"] = traces

    # ------------------------------------------- lm: kernel times, timed run
    lm_rows, lm_totals = lm_kernel_times(lm_cfg, dev_gen, dev, popc_per_s)
    print(f"lm kernel times on {card} (ms per launch, as above; bound = max(bytes / "
          f"3.35 TB/s, popc / {popc_per_s / 1e12:.3f} T/s, V adds / 67 "
          f"TFLOP/s); pack_bits has no single PyTorch call computing it):")
    for r in lm_rows:
        lib = "—" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} (wall {r['library_wall_ms']:.4f})"
        print(f"  {r['kernel']:24s} {r['where']:40s} kernel {r['ms']:.4f} "
              f"(wrapper {r['wrapper_ms']:.4f})  plain {r['plain_ms']:.3f}  "
              f"library {lib}  bound "
              f"{r['bound_ms']:.5f} ({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'ops'})")
    totals.update(lm_totals)
    report["lm_shapes"] = lm_rows
    timed, eng = lm_timed_run(lm_cfg, args.seed, dev, card)
    sched = eng.scheduler()
    pos = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device=dev)
    step = trace(lambda: sched.model.decode(sched.params, sched._state["cur"],
                                            sched._cache, pos))
    share = step["busy_ms"] / step["wall_ms"] if step["wall_ms"] else 0.0
    print(f"trace lm decode step (depth {lm_cfg.n_layers}, {LM_SLOTS} slots at "
          f"position 300) on {card}: wall {step['wall_ms']:.4f} ms (profiled),"
          f" device busy {step['busy_ms']:.4f} ms ({share:.3f} of wall), "
          f"{step['launches']} kernel launches; top kernels:")
    for kname, cnt, ms in step["top"]:
        print(f"    {ms:9.4f} ms  x{cnt:<3d} {kname}")
    timed["decode_step_trace"] = step
    report["lm_timed"] = timed
    del eng, sched
    torch.cuda.empty_cache()

    kernels = []
    for kn in REPLACES:
        t = totals[kn]
        kernels.append({
            "name": kn, "route": "cuda", "source": SOURCES[kn],
            "replaces": REPLACES[kn], "launches": path_launches[kn],
            "max_abs_err": err[kn], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"]})
    report["kernels"] = kernels
    report["kernel_totals"] = totals
    for kn, t in totals.items():
        lib = "—" if t["library_ms"] is None else \
            f"{t['library_ms']:.4f} (wall {t['library_wall_ms']:.4f})"
        print(f"total {kn:24s} kernel {t['ms']:.4f} (wrapper "
              f"{t['wrapper_ms']:.4f})  plain {t['plain_ms']:.3f}  library "
              f"{lib}  bound {t['bound_ms']:.6f}")
    report["launches"] = {"mlp": mlp_launches, "cnn": cnn_launches,
                          "lm": lm_launches, "lm_chunks": lm_chunks}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print("kernels line: ms and library_ms are device times (device_ms), "
          "plain_ms CUDA-event time; GEMM times are summed over one mlp and "
          "one cnn forward's launches of each kernel; pack_bits, decode and "
          "prefill attention times over one LM layer's launches in one "
          "decode step and one prefill chunk (the two chunk shapes weighted "
          "1/2); launches count the mlp, cnn and depth-2 LM runs")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
