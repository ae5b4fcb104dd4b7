"""Train an LM of the registry with Algorithm 1 (the `train.trainer`
loop: S-AdaMax through the STE, clip(W), checkpoints, resume).

    python -m repro_torch.launch.train --arch phi3-medium-14b --smoke \\
        --steps 20 --batch 8 --seq 64 --device cpu --ckpt-dir DIR

--smoke takes the reduced same-family config (small enough for the CPU);
without it the arch trains at its full size. Without --device the run is
on the CUDA card (and raises if there is none). A checkpoint directory
that holds steps resumes from the latest, whatever mesh wrote it. Prints
the run's summary as JSON.

--mesh, the JAX launcher's choices: `none` (one device), `host` (a
'data' x 'model' mesh over every visible card, --model of them on the
'model' axis; with --device, --model shards of that device), `production`
(16 x 16 'data' x 'model') and `multipod` (2 x 16 x 16 'pod' x 'data' x
'model'), which raise ValueError on a machine with fewer cards. The
Trainer places the params and the optimizer state by the JAX package's
specs (`launch.shardings.param_specs`) and the summary adds each
position's resident bytes (`resident_bytes_per_device`):

    python -m repro_torch.launch.train --arch phi3-medium-14b --smoke \
        --steps 4 --batch 8 --seq 64 --mesh host --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--quant", default=None,
                    help="override the quant mode: none|bc|bbp|bbp_det")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "production", "multipod"])
    ap.add_argument("--model", type=int, default=1,
                    help="the 'model' axis of --mesh host")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ...; default: the CUDA card")
    args = ap.parse_args(argv)
    if args.device is not None and args.mesh in ("production", "multipod"):
        ap.error(f"--mesh {args.mesh} spans the visible cards; --device "
                 "goes with --mesh none or host")

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.quant:
        cfg = cfg.scaled(quant=args.quant)
    mesh, device = None, args.device
    if args.model != 1 and args.mesh != "host":
        ap.error("--model sizes the 'model' axis of --mesh host")
    if args.mesh == "host":
        mesh = make_host_mesh(args.model, devices=None if device is None
                              else [device] * args.model)
        device = None
    elif args.mesh in ("production", "multipod"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, lr=args.lr, accum=args.accum,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tc, mesh=mesh, device=device)
    out = trainer.run()
    if mesh is not None:
        out["resident_bytes_per_device"] = trainer.resident_bytes_per_device()
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
