"""Abstract stand-ins for every model input (port of `repro.launch.specs`).

`input_specs(cfg, model, shape_name)` gives the inputs of the shape cell's
step function (train / prefill / decode), and `abstract_params` /
`abstract_opt_state` the params and the optimizer state, as tensors on the
meta device: shapes and dtypes only, nothing drawn or allocated (the JAX
package's are ShapeDtypeStructs from jax.eval_shape). Packed words are
int32 here and uint32 there (the same bits).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.api import Model

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _img_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return _spec((batch, cfg.n_img_tokens, cfg.d_vision),
                 torch.bfloat16 if cfg.dtype == "bfloat16"
                 else torch.float32)


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["img_emb"] = _img_spec(cfg, b)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return train_batch_specs(cfg, shape)


def cache_specs(cfg: ModelConfig, model: Model, batch: int,
                max_len: int) -> dict:
    return model.init_cache(batch, max_len, device=META)


def decode_specs(cfg: ModelConfig, model: Model, shape: ShapeSpec) -> dict:
    """One decode step: a token and a position per slot, and the cache of
    seq_len positions (the ssm and hybrid states are O(1) in seq_len)."""
    b = shape.global_batch
    return {"token": _spec((b,), torch.int32),
            "cache": cache_specs(cfg, model, b, shape.seq_len),
            "pos": _spec((b,), torch.int32)}


def input_specs(cfg: ModelConfig, model: Model, shape_name: str) -> dict:
    """All abstract inputs of one (arch x shape) cell."""
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return decode_specs(cfg, model, shape)
    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig, model: Model):
    return model.init(torch.Generator(), device=META)


def abstract_opt_state(opt, params):
    return opt.init(params)
