"""Deterministic synthetic image data (a numpy-only copy of the image half of
`repro.data.synthetic`, kept here so the port imports nothing of the JAX
package; `SyntheticLM` waits for the LM training slice).

Batches are a pure function of (seed, step): the same seed and step give
the same batch here and in the JAX package, so a run restarts exactly and
both packages train on the same images.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataConfig:
    n_classes: int = 10
    img: int = 32
    channels: int = 3
    noise: float = 0.4
    seed: int = 0


class SyntheticImages:
    """Class-prototype images in [-1, 1] (MNIST/CIFAR/SVHN stand-ins)."""

    def __init__(self, cfg: ImageDataConfig, flat: bool = False):
        self.cfg = cfg
        self.flat = flat
        rng = np.random.default_rng(cfg.seed)
        shape = (cfg.n_classes, cfg.img * cfg.img * cfg.channels) if flat \
            else (cfg.n_classes, cfg.img, cfg.img, cfg.channels)
        self._proto = rng.standard_normal(shape).astype(np.float32)

    def batch(self, step: int, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 7 + step + 1)
        labels = rng.integers(0, cfg.n_classes, batch_size).astype(np.int32)
        x = self._proto[labels] + cfg.noise * rng.standard_normal(
            self._proto[labels].shape).astype(np.float32)
        return np.clip(x, -1.0, 1.0), labels
