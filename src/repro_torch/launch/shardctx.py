"""Activation-sharding hints (port of `repro.launch.shardctx`).

In the JAX package the models call `hint_residual(x)` and its five
siblings at layer boundaries, and inside `activation_sharding(mesh)` each
becomes a `with_sharding_constraint` that GSPMD lays the activations out
by (Megatron sequence parallelism over 'model', the batch over the batch
axes). The port has no GSPMD: one process drives every shard
(`launch.mesh`), and each shard's forward sees only its own rows, so each
hint returns its tensor unchanged. The context still knows what each hint
would name: `current().residual(shape)` and its siblings give the spec
tuple (`launch.shardings`' form) by the JAX package's rules, or None where
the hint names none.

Where the placed train step (`train.step`, masters placed by
`launch.shardings.param_specs`) computes matches two of the hints: an
FFN's hidden is computed in column parts over 'model' (`ffn_hidden`'s F
over 'model'), and a MoE buffer's experts run on their 'model' devices
(`expert_buf`'s E over 'model'); in both the parts are joined on the data
row's device after each product (`core.layers`). The others do not:
`residual`'s sequence sharding over 'model' (Megatron-SP) and `attn_q`'s
heads over 'model' name layouts the port does not compute (the residual
stream and the attention run whole on the row's device; ROADMAP), and
`gathered` and `batch_only` name the batch split that every shard's own
rows already are.

    with activation_sharding(mesh, global_batch=8) as hints:
        hints.residual((8, 128, 512))      # ('data', 'model', None)
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.launch.shardings import _entry, div_batch_axes


@dataclass(frozen=True)
class ShardHints:
    """The specs the hints name inside one `activation_sharding` context:
    `ba` the batch axes, `model_size` the 'model' axis' size, `seq`
    whether the residual stream is sequence-sharded."""
    ba: tuple[str, ...]
    model_size: int
    seq: bool

    def residual(self, shape) -> tuple | None:
        """x (B, S, D), the residual stream at a layer boundary."""
        if len(shape) != 3:
            return None
        seq_ok = self.seq and shape[1] % self.model_size == 0 \
            and shape[1] > 1
        return (_entry(self.ba), "model" if seq_ok else None, None)

    def gathered(self, shape) -> tuple | None:
        """A matmul input (B, S, D): sequence gathered, batch sharded."""
        return (_entry(self.ba), None, None) if len(shape) == 3 else None

    def ffn_hidden(self, shape) -> tuple | None:
        """FFN hidden / attention heads (B, S, F): F over 'model'."""
        if len(shape) != 3 or shape[-1] % self.model_size:
            return None
        return (_entry(self.ba), None, "model")

    def expert_buf(self, shape) -> tuple | None:
        """MoE dispatch buffers (E, C, D): experts over 'model'."""
        if len(shape) != 3 or shape[0] % self.model_size:
            return None
        return ("model", None, None)

    def attn_q(self, shape) -> tuple | None:
        """Attention queries (B, S, H, d): heads over 'model' where the
        head count divides it."""
        if len(shape) != 4 or shape[2] % self.model_size:
            return None
        return (_entry(self.ba), None, "model", None)

    def batch_only(self, shape) -> tuple | None:
        """The leading batch dim only (decode-path activations)."""
        if len(shape) < 1:
            return None
        return (_entry(self.ba),) + (None,) * (len(shape) - 1)


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shard_hints", default=None)


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, *, global_batch: int | None = None,
                        seq_shard: bool = True):
    """The hints' context on `mesh` (the batch axes that divide
    `global_batch`, when given); yields its `ShardHints`."""
    ba = batch_axes(mesh) if global_batch is None \
        else div_batch_axes(mesh, global_batch)
    hints = ShardHints(ba, mesh.shape.get("model", 1), seq_shard)
    token = _CTX.set(hints)
    try:
        yield hints
    finally:
        _CTX.reset(token)


def current() -> ShardHints | None:
    """The innermost context's hints, None outside any."""
    return _CTX.get()


def hint_residual(x: torch.Tensor) -> torch.Tensor:
    return x


def hint_gathered(x: torch.Tensor) -> torch.Tensor:
    return x


def hint_ffn_hidden(x: torch.Tensor) -> torch.Tensor:
    return x


def hint_expert_buf(x: torch.Tensor) -> torch.Tensor:
    return x


def hint_attn_q(x: torch.Tensor) -> torch.Tensor:
    return x


def hint_batch_only(x: torch.Tensor) -> torch.Tensor:
    return x
