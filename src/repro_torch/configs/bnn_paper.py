"""The paper's own experiment configs (§5): MNIST MLP, CIFAR-10 / SVHN CNN.

These are not LM architectures; they parameterize repro_torch.models.paper_nets
and are read by train/paper.py and chip_smoke.py. A copy of
repro.configs.bnn_paper, kept here so the port imports nothing of the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperNetConfig:
    name: str
    kind: str                 # "mlp" | "cnn"
    n_classes: int = 10
    # mlp
    in_dim: int = 784
    hidden: int = 1024
    n_hidden: int = 3
    # cnn
    img: int = 32
    in_ch: int = 3
    widths: tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    fc: int = 1024
    # training (paper §5)
    batch: int = 100
    base_lr: float = 2 ** -6       # Glorot-derived, AP2-rounded
    lr_halve_every: int = 50       # right-shift every 50 epochs
    mode: str = "bbp"              # bbp | bc | float
    bn_kind: str = "shift"


BNN_MNIST = PaperNetConfig(name="bnn-mnist", kind="mlp", batch=200)
BNN_CIFAR10 = PaperNetConfig(name="bnn-cifar10", kind="cnn", batch=100)
BNN_SVHN = PaperNetConfig(name="bnn-svhn", kind="cnn", batch=100)

PAPER_CONFIGS = {c.name: c for c in (BNN_MNIST, BNN_CIFAR10, BNN_SVHN)}
