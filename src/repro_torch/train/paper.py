"""Train the paper's networks with Algorithm 1 (port of the train step the
JAX package writes in examples/train_bnn_cifar10.py and
benchmarks/bench_accuracy.py).

One step: the train forward (stochastic binarization from `gen` in mode
'bbp', BN on batch moments), the L2-SVM square hinge loss, the gradient of
every fp32 master leaf through the STE (`torch.autograd.grad`), the
optimizer's update (S-AdaMax with the right-shift LR schedule by default),
`apply_updates`, then `clip_all_weights`.

    python -m repro_torch.train.paper --config bnn-cifar10 --steps 30
    python -m repro_torch.train.paper --config bnn-cifar10 --steps 2 \\
        --device cpu --batch 8 --widths 8,8,16,16,32,32 --fc 32

Without --device it runs on the CUDA card (and raises if there is none),
the binary convs through the tensor-core kernel `binary_gemm_mxu`; --batch,
--widths and --fc cut the config down for a run on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.bnn_paper import PAPER_CONFIGS, PaperNetConfig
from repro_torch.data.synthetic import ImageDataConfig, SyntheticImages
from repro_torch.models import paper_nets as pn
from repro_torch.optim.base import (
    Optimizer, apply_updates, tree_leaves, tree_unflatten_like,
)
from repro_torch.optim.shift_adamax import shift_adamax, shift_lr_schedule

DATA_NOISE = 0.35           # the JAX package's training examples use 0.35


def make_optimizer(cfg: PaperNetConfig) -> Optimizer:
    """S-AdaMax with the config's right-shift LR schedule (paper §5)."""
    return shift_adamax(shift_lr_schedule(cfg.base_lr, cfg.lr_halve_every))


def init_params(cfg: PaperNetConfig, gen: torch.Generator, device=None):
    """(params, bn_state) of the config's net: uniform(-1, 1) weights from
    `gen` (a CPU generator), BN at its init; the MLP has no BN state."""
    if cfg.kind == "mlp":
        return pn.init_mlp(gen, cfg.in_dim, cfg.hidden, cfg.n_hidden,
                           cfg.n_classes, device=device), None
    return pn.init_cnn(gen, cfg.in_ch, cfg.widths, cfg.fc, cfg.n_classes,
                       cfg.img, device=device)


def synthetic_data(cfg: PaperNetConfig, seed: int = 0) -> SyntheticImages:
    """The synthetic stand-in of the config's dataset: flat 28x28x1 images
    for the MLP (784 inputs), img x img x in_ch for the CNN."""
    if cfg.kind == "mlp":
        side = math.isqrt(cfg.in_dim)
        if side * side != cfg.in_dim:
            raise ValueError(f"in_dim {cfg.in_dim} is not a square image")
        return SyntheticImages(ImageDataConfig(
            n_classes=cfg.n_classes, img=side, channels=1, noise=DATA_NOISE,
            seed=seed), flat=True)
    return SyntheticImages(ImageDataConfig(
        n_classes=cfg.n_classes, img=cfg.img, channels=cfg.in_ch,
        noise=DATA_NOISE, seed=seed))


def make_train_step(cfg: PaperNetConfig, opt: Optimizer, *,
                    mode: str | None = None, bn_kind: str | None = None,
                    kernel_path: str = "auto") -> Callable:
    """step(params, bn_state, opt_state, x, y, gen, noise=None) ->
    (params, bn_state, opt_state, loss). `gen` None (and no `noise`) means
    deterministic binarization; `noise` feeds the forward's draws by site
    (`models.paper_nets`). The MLP's bn_state passes through untouched."""
    mode = mode or cfg.mode
    bn_kind = bn_kind or cfg.bn_kind

    def step(params, bn_state, opt_state, x, y, gen, noise=None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        masters = tree_unflatten_like(params, leaves)
        if cfg.kind == "mlp":
            scores = pn.mlp_forward(masters, x, mode=mode, train=True,
                                    gen=gen, noise=noise,
                                    kernel_path=kernel_path)
            new_bn = bn_state
        else:
            scores, new_bn = pn.cnn_forward(
                masters, bn_state, x, mode=mode, train=True, gen=gen,
                noise=noise, bn_kind=bn_kind, kernel_path=kernel_path)
        loss = pn.square_hinge_loss(scores, y, cfg.n_classes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten_like(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = pn.clip_all_weights(apply_updates(params, updates))
        return params, new_bn, opt_state, loss.detach()

    return step


def train(cfg: PaperNetConfig, steps: int, *, seed: int = 0, device=None,
          kernel_path: str = "auto", log: Callable | None = None
          ) -> list[float]:
    """Train `cfg` for `steps` steps on its synthetic data, batches of
    cfg.batch, from weights and binarization noise made from `seed`.
    Returns the loss of every step. device None means the CUDA card."""
    dev = resolve_device(device)
    params, bn_state = init_params(cfg, torch.Generator().manual_seed(seed),
                                   dev)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, kernel_path=kernel_path)
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = synthetic_data(cfg, seed)
    losses = []
    for i in range(steps):
        xb, yb = data.batch(i, cfg.batch)
        x = torch.from_numpy(xb).to(dev)
        y = torch.from_numpy(yb).to(dev)
        params, bn_state, opt_state, loss = step(params, bn_state, opt_state,
                                                 x, y, gen)
        losses.append(loss)
        if log is not None:
            log(i, float(loss))
    return [float(v) for v in losses]


def _config(args) -> PaperNetConfig:
    cfg = PAPER_CONFIGS[args.config]
    over = {}
    if args.batch:
        over["batch"] = args.batch
    if args.widths:
        over["widths"] = tuple(int(v) for v in args.widths.split(","))
    if args.fc:
        over["fc"] = args.fc
    return dataclasses.replace(cfg, **over)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="bnn-cifar10",
                    choices=sorted(PAPER_CONFIGS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ...; default: the CUDA card")
    ap.add_argument("--batch", type=int, default=0, help="override the batch")
    ap.add_argument("--widths", default="",
                    help="override the CNN's conv widths, e.g. 8,8,16,16,32,32")
    ap.add_argument("--fc", type=int, default=0, help="override the CNN's FC")
    args = ap.parse_args(argv)
    cfg = _config(args)
    dev = resolve_device(args.device)
    print(f"training {cfg.name} ({cfg.kind}, mode {cfg.mode}, batch "
          f"{cfg.batch}) on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    t0 = time.perf_counter()
    losses = train(cfg, args.steps, device=dev,
                   log=lambda i, v: print(f"step {i:4d}  hinge loss {v:.4f}"))
    print(f"{args.steps} steps in {time.perf_counter() - t0:.2f} s; mean "
          f"loss of the first / last 5: {sum(losses[:5]) / len(losses[:5]):.4f}"
          f" / {sum(losses[-5:]) / len(losses[-5:]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
