"""Dry run: every (arch x shape x mesh) cell's step traced on the production
mesh of fake devices, with the per-device memory / FLOP / collective
numbers the roofline analysis reads (port of `repro.launch.dryrun`).

The JAX package lowers and compiles each cell's jitted step for 256 (512)
forced host devices and reads XLA's analyses. The port has no compiler: a
cell's step is the port's own (`train.step.make_train_step`,
`make_prefill_step`, `make_decode_step` over a mesh, params placed by
`launch.shardings.param_specs`, the S-AdaMax state by
`train.step.init_placed_state`, a decode cache by
`launch.shardings.cache_shardings`), run under `roofline.count` on
`make_production_mesh(devices=roofline.count.fake_devices(256, 16))`: one
fake device per position, nothing allocated, nothing run on a card. Runs
on any machine, no GPU needed. The multi-pod mesh's 512 positions are more
than fake devices can name apart (torch keeps a device index in 8 bits):
its cells FAIL with that error. JAX's `XLA_FLAGS` preamble has no
counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every cell, single-pod
Results are appended as JSON lines to --out (default dryrun_results.jsonl),
with the JAX package's keys; `trace_s` stands where it has `lower_s` and
`compile_s`. `flops`, `bytes_accessed`, `collectives` and `memory` are the
busiest device's (each the largest over the devices; the step ends when
its slowest device does); `per_device` holds every position's.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import cache_shardings, param_specs, place
from repro_torch.models.api import get_model
from repro_torch.optim.base import tree_map
from repro_torch.roofline.count import (
    busiest, count, fake_devices, fake_mode,
)
from repro_torch.train.step import (
    default_optimizer, init_placed_state, make_decode_step,
    make_prefill_step, make_train_step,
)

SKIP_REASON = ("long_500k needs sub-quadratic attention "
               "(DESIGN.md §Arch-applicability)")


def pick_accum(cfg, shape) -> int:
    """Gradient-accumulation factor for train cells, the JAX package's rule
    (sized so activations fit a 16 GB v5e): large models halve/quarter the
    microbatch. Kept as it is, so the cells are the reference's; on the
    H100's 80 GB the same microbatches leave more room."""
    n = cfg.n_params()
    if n > 3e10:
        return 4
    if n > 8e9:
        return 2
    return 1


def _inputs(cfg, model, shape, mesh):
    """The cell's placed params and specs, and its batch (or token, cache
    and positions), made on the fake devices. The whole params and cache
    are made on the (fake) host and placed from there, so that each
    position holds its pieces' storage only, as JAX's abstract inputs
    place them."""
    dev0, host = mesh.devices.flat[0], torch.device("cpu")
    params = model.init(torch.Generator(), device=host)
    specs = param_specs(params)
    placed = tree_map(lambda x, sp: place(x, mesh, sp), params, specs)
    del params
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device=dev0)}
        if cfg.family == "vlm":
            batch["img_emb"] = torch.zeros(
                (b, cfg.n_img_tokens, cfg.d_vision),
                dtype=cfg.activation_dtype, device=dev0)
        return placed, specs, (batch,)
    whole = model.init_cache(b, s, device=host)
    sh = cache_shardings(mesh, whole, cfg.family, b)
    cache = {k: place(v, mesh, sh[k].spec) for k, v in whole.items()}
    del whole
    token = torch.zeros((b,), dtype=torch.int32, device=dev0)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev0)
    return placed, specs, (token, cache, pos)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: dict | None = None, accum: int | None = None,
             seq_shard: bool = True, verbose: bool = True) -> dict:
    """Trace and count one (arch x shape) cell on the production mesh.

    `seq_shard` is accepted and recorded, as the JAX package's: there it
    shards the residual stream's sequence axis (a `shardctx` hint), which
    the port does not place yet, so it does not change the trace. Batch
    shards and devices' updates of one shape are replayed
    (`roofline.count`)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    if shape_name not in cfg.shapes:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP", "reason": SKIP_REASON}
    model = get_model(cfg)
    shape = SHAPES[shape_name]
    if accum is None:
        accum = pick_accum(cfg, shape) if shape.kind == "train" else 1
    t0 = time.time()
    with fake_mode():
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=fake_devices(n, 16))
        placed, specs, rest = _inputs(cfg, model, shape, mesh)
        if shape.kind == "train":
            opt = default_optimizer(cfg)
            state = init_placed_state(opt, placed, mesh)
            step = make_train_step(model, opt, accum=accum, mesh=mesh,
                                   specs=specs)
            args = (placed, state) + rest
        elif shape.kind == "prefill":
            step = make_prefill_step(model, max_len=shape.seq_len,
                                     mesh=mesh, specs=specs)
            args = (placed,) + rest
        else:
            step = make_decode_step(model, mesh=mesh, specs=specs)
            args = (placed,) + rest
        rep = count(step, *args, mesh=mesh)
        del rep["result"], args, placed, rest
    t_trace = time.time() - t0
    top = busiest(rep)
    devs = list(rep["devices"].values())
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "OK",
        "accum": accum, "seq_shard": seq_shard,
        "n_devices": int(mesh.devices.size),
        "flops": float(top["flops"]),
        "bytes_accessed": float(top["hbm_bytes"]),
        "collectives": top["collectives"],
        "memory": top["memory"],
        "per_device": {
            "flops": [d["flops"] for d in devs],
            "hbm_bytes": [d["hbm_bytes"] for d in devs],
            "collective_bytes": [d["collectives"]["total_bytes"]
                                 for d in devs],
            **{k: [d["memory"][k] for d in devs] for k in devs[0]["memory"]},
        },
        "kernels": {k: sum(d["kernels"].get(k, 0) for d in devs)
                    for k in {k for d in devs for k in d["kernels"]}},
        "host_ops": rep["host"]["ops"],
        "trace_s": round(t_trace, 1),
    }
    if verbose:
        mem = result["memory"]
        print(f"[dryrun] {arch} x {shape_name} mesh="
              f"{'2x16x16' if multi_pod else '16x16'} OK "
              f"flops/dev={result['flops']:.3e} "
              f"coll={result['collectives']['total_bytes'] / 1e6:.1f}MB "
              f"temp={mem.get('temp_size_in_bytes', 0) / 1e9:.2f}GB "
              f"args={mem.get('argument_size_in_bytes', 0) / 1e9:.2f}GB "
              f"(trace {t_trace:.0f}s)")
        print(f"  memory: {mem}")
        print(f"  counted: flops={result['flops']:.4e} "
              f"bytes={result['bytes_accessed']:.4e}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args()

    cells: list[tuple[str, str]] = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shape_names = [args.shape] if args.shape else list(SHAPES)
        for s in shape_names:
            cells.append((a, s))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    out = Path(args.out)
    n_fail = 0
    for mp in meshes:
        for arch, shape in cells:
            try:
                res = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:  # a failed cell is a bug: surface it
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
            with out.open("a") as f:
                f.write(json.dumps(res) + "\n")
    print(f"done; {n_fail} failures -> {out}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
