"""Deterministic synthetic data (a numpy-only copy of
`repro.data.synthetic`, kept here so the port imports nothing of the JAX
package): Markov-chain token streams for the LMs and class-prototype
images for the paper's nets.

Batches are a pure function of (seed, step) (and, for tokens, of the host's
slice): the same arguments give the same batch here and in the JAX package,
so a run restarts exactly and both packages train on the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # out-degree of the Markov chain (predictability)


class SyntheticLM:
    """Markov-chain token stream: a fixed random chain over the vocab, each
    state with `branching` successors, so a model can learn it.
    batch(step) -> {"tokens": (B, S) int32 numpy}."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab,
                                  size=(cfg.vocab, cfg.branching),
                                  dtype=np.int32)

    def batch(self, step: int, *, host_id: int = 0, n_hosts: int = 1
              ) -> dict:
        """This host's rows of the global batch of `step`."""
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        local_b = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + host_id)
        toks = np.empty((local_b, cfg.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, local_b)
        choices = rng.integers(0, cfg.branching,
                               size=(local_b, cfg.seq_len - 1))
        for t in range(1, cfg.seq_len):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t - 1]]
        return {"tokens": toks}


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
