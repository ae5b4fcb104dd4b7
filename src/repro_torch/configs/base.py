"""Config system: a jax-free copy of `repro.configs.base` (ModelConfig and
the arch registry).

The fields, their defaults and their meaning are the JAX package's, so a
config compares field by field across the two packages; only
`activation_dtype` differs in kind (a torch dtype). The registry holds only
what the port can serve: other archs raise KeyError.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

import torch

# modules whose import registers an arch the port serves; the rest of the
# JAX package's archs wait in ROADMAP Queue A
_ARCH_MODULES = ("repro_torch.configs.phi3_medium_14b",)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | audio | hybrid | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    mlp: str = "swiglu"       # swiglu | geglu | sq_relu | gelu
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    pos: str = "rope"         # rope | sinusoidal
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # VLM cross-attention
    xattn_group: int = 0
    n_img_tokens: int = 0
    d_vision: int = 0
    # hybrid (recurrentgemma)
    block_pattern: tuple[str, ...] = ()
    local_window: int = 0
    lru_width: int = 0
    # ssm (falcon-mamba)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # quantization: the paper's technique on all projections
    quant: str = "bbp_det"    # none | bc | bbp | bbp_det
    # KV-cache residency: 0 = float cache, 1 = sign bitplanes + V scale
    kv_bits: int = 0
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    attn_chunk: int = 512
    source: str = ""

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


_REGISTRY: dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(mod)


def get_config(name: str) -> ModelConfig:
    _load()
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue A); "
                       f"the port serves {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load()
    return sorted(_REGISTRY)
