#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases, each of which raises on failure (nothing is caught):
  1. device  - the card's name, count, and name + power limit from nvidia-smi
  2. build   - nvcc builds every kernel from the sources in this checkout
  3. kernels - each Hopper kernel against its plain PyTorch version on the
               card, at the shapes the main path gives it and at ragged ones:
               int32 dots and packed words must be equal (tolerance 0)
  4. mlp     - bnn-mnist (784-1024x3-10) frozen, batches of 200 through the
               kernels; hidden words and scores equal the plain path's, the
               fp32-master path's, and the CPU's on a small batch
  5. cnn     - bnn-cifar10 (128,128,256,256,512,512 convs, 1024 FC, 32x32x3)
               frozen with shift-BN, batches of 100; the same checks
  6. times   - per kernel and shape: CUDA-event time, the plain version's,
               one PyTorch library call computing the same dots, and the
               card's bound; then each forward per batch, and one profiled
               frozen forward each (device busy share, top kernels)
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Weights, BN statistics and inputs are random
from the seed; inputs are multiples of 1/128 in [-1, 1], like 8-bit pixels.
Exits non-zero, printing no result, without a card or without the repo.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores
POPC_PER_CLOCK_PER_SM = 16         # 32-bit popc issue rate, compute 9.0
SOURCE = "src/repro_torch/kernels/csrc/binary_gemm.cu"
REPLACES = {"binary_gemm_packed": "src/repro/kernels/binary_gemm.py:107",
            "binary_gemm_packed_rhs": "src/repro/kernels/binary_gemm.py:166",
            "binary_gemm_fused": "src/repro/kernels/binary_gemm.py:242"}
RAGGED = [(9, 100, 48), (17, 64, 10), (3, 37, 33), (130, 257, 129)]


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
        self.a = pack_bits(x)
        self.b = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        d = int(k ** 0.5)
        self.thresh = torch.randint(-d, d + 1, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)
        self.flip = torch.randint(0, 2, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)

    def call(self, kernel, lhs, plain=False):
        from repro_torch.kernels import binary_gemm as bg
        a = self.x if lhs == "float" else self.a
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
    path_launches = {kn: mlp_launches[kn] + cnn_launches[kn] for kn in REPLACES}

    # ---------------------------------------------------------------- times
    print(f"times on {card} (ms; bound = max(bytes / 3.35 TB/s, popc / "
          f"{popc_per_s / 1e12:.3f} T/s); int8 TC = 2MNK / 1979 TOP/s)")
    totals = {kn: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0}
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
               "where": where,
               "ms": cuda_ms(lambda: op.call(kn, lhs)),
               "plain_ms": cuda_ms(lambda: op.call(kn, lhs, plain=True),
                                   warmup=1, budget_s=0.2, max_iters=5),
               "library": lib_name, "library_ms": cuda_ms(lib_fn),
               **bound(kn, lhs, m, k, n, popc_per_s)}
        rows.append(row)
        for key in totals[kn]:
            totals[kn][key] += row[key]
        print(f"  {where:9s} {kn:24s} {lhs:6s} M={m:6d} K={k:5d} N={n:5d} "
              f"kernel {row['ms']:.4f}  plain {row['plain_ms']:.3f}  "
              f"{lib_name} {row['library_ms']:.4f}  bound "
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

    kernels = []
    for kn in REPLACES:
        t = totals[kn]
        kernels.append({
            "name": kn, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kn], "launches": path_launches[kn],
            "max_abs_err": err[kn], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"]})
    report["kernels"] = kernels
    report["launches"] = {"mlp": mlp_launches, "cnn": cnn_launches}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print("kernel times above are summed over one mlp and one cnn forward's "
          "launches of each kernel")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
