"""Roofline report: dryrun_results.jsonl -> per-cell three-term roofline
(port of `repro.roofline.report`, priced with the H100's peaks).

    compute term    = counted FLOPs / 989.4 TF/s      (dense bf16)
    memory term     = counted bytes / 3.35 TB/s       (HBM3)
    collective term = collective bytes / 450 GB/s     (NVLink 4, one way)

The counted numbers are the dry run's per-device ones (`roofline.count`:
each aten op of the eager step, unfused, and each hand-written kernel's
own formula), so each is divided by one card's peak. The peaks are the H100
SXM 80GB datasheet's (`launch.mesh`), not measurements: every time printed
here is a bound computed from them, never a reading. `roofline_row` takes
other peaks by keyword (the JAX package's v5e constants give its row).

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training;
2*N*D for single forward (prefill); 2*N_active*B per decoded token.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

PRICED = ("priced with the H100 SXM 80GB datasheet peaks (989.4 TFLOP/s "
          "dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink 4 one way): bounds, "
          "not measurements")


def model_flops(arch: str, shape_name: str) -> float:
    """Total useful model FLOPs for the step, per device."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
    return total


def roofline_row(rec: dict, *, peak_flops: float = PEAK_FLOPS_BF16,
                 hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> dict:
    chips = rec["n_devices"]
    flops_dev = rec["flops"]
    bytes_dev = rec["bytes_accessed"]
    coll_dev = rec["collectives"]["total_bytes"]
    t_comp = flops_dev / peak_flops
    t_mem = bytes_dev / hbm_bw
    t_coll = coll_dev / link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf_total = model_flops(rec["arch"], rec["shape"])
    mf_dev = mf_total / chips
    useful = mf_dev / flops_dev if flops_dev else 0.0
    # roofline fraction: useful work at peak vs the dominant-term bound
    t_bound = max(terms.values())
    frac = (mf_dev / peak_flops) / t_bound if t_bound else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "accum": rec.get("accum", 1),
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops_per_dev": mf_dev,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "temp_gb": rec["memory"].get("temp_size_in_bytes", 0) / 1e9,
        "args_gb": rec["memory"].get("argument_size_in_bytes", 0) / 1e9,
    }


def load_results(path: str | Path) -> list[dict]:
    recs = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            recs.append(json.loads(line))
    return recs


def make_table(path: str | Path, *, multi_pod: bool | None = False) -> str:
    """Markdown roofline table, under a line that says how it was priced.
    The columns are the JAX package's; 'useful/counted' stands where it
    has 'useful/HLO'."""
    rows, skips = [], []
    for rec in load_results(path):
        if multi_pod is not None and rec.get("multi_pod") != multi_pod:
            continue
        if rec["status"] == "SKIP":
            skips.append(rec)
            continue
        if rec["status"] != "OK":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "error": rec.get("error", "?")})
            continue
        rows.append(roofline_row(rec))

    lines = [
        f"Per-device times {PRICED}.",
        "",
        "| arch | shape | compute s | memory s | collective s | bottleneck "
        "| useful/counted | roofline frac | temp GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL: {r['error'][:40]} |||||||")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f} | "
            f"{r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} | "
            f"**{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['temp_gb']:.1f} |")
    for rec in skips:
        lines.append(f"| {rec['arch']} | {rec['shape']} | SKIP — "
                     f"{rec['reason'][:60]} |||||||")
    return "\n".join(lines)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="dryrun_results.jsonl")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    print(make_table(args.results, multi_pod=args.multi_pod))


if __name__ == "__main__":
    main()
