"""Train an LM of the registry with Algorithm 1 (the `train.trainer`
loop: S-AdaMax through the STE, clip(W), checkpoints, resume).

    python -m repro_torch.launch.train --arch phi3-medium-14b --smoke \\
        --steps 20 --batch 8 --seq 64 --device cpu --ckpt-dir DIR

--smoke takes the reduced same-family config (small enough for the CPU);
without it the arch trains at its full size. Without --device the run is
on the CUDA card (and raises if there is none). A checkpoint directory
that holds steps resumes from the latest. Prints the run's summary as JSON.
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
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ...; default: the CUDA card")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: sharded training "
                                  "waits for ROADMAP Queue A item 6")

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.quant:
        cfg = cfg.scaled(quant=args.quant)
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, lr=args.lr, accum=args.accum,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    out = Trainer(cfg, tc, device=args.device).run()
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
