"""Config system: a jax-free copy of `repro.configs.base` (ModelConfig, the
input-shape cells and the arch registry).

The fields, their defaults and their meaning are the JAX package's, so a
config compares field by field across the two packages; only
`activation_dtype` differs in kind (a torch dtype). The registry holds
every arch of the JAX package's.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

import torch

# modules whose import registers an arch the port serves
_ARCH_MODULES = ("repro_torch.configs.phi3_medium_14b",
                 "repro_torch.configs.deepseek_67b",
                 "repro_torch.configs.qwen2_72b",
                 "repro_torch.configs.nemotron_4_15b",
                 "repro_torch.configs.musicgen_large",
                 "repro_torch.configs.dbrx_132b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.falcon_mamba_7b",
                 "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.configs.llama_3_2_vision_11b")


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                 # train_4k / prefill_32k / decode_32k / long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


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

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), the JAX
        package's formula."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.expand * d
            dtr = self.dt_rank or max(1, d // 16)
            per = (d * 2 * di + self.d_conv * di + di * (dtr + 2 * self.ssm_state)
                   + dtr * di + di * self.ssm_state + di + di * d)
            return emb + l * per
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        ffn_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.n_experts:
            ff = self.n_experts * ffn_mult * d * f + d * self.n_experts
        else:
            ff = ffn_mult * d * f
        per = attn + ff
        if self.family == "hybrid":
            # crude split: attn layers vs recurrent layers
            pat = self.block_pattern or ("rec", "rec", "attn")
            n_attn = sum(1 for i in range(l) if pat[i % len(pat)] == "attn")
            n_rec = l - n_attn
            w = self.lru_width or d
            rec_per = 2 * d * w + 4 * w + w * d + ffn_mult * d * f
            return emb + n_attn * per + n_rec * rec_per
        return emb + l * per

    def n_active_params(self) -> int:
        """Per-token active params (MoE counts top_k experts only)."""
        if not self.n_experts:
            return self.n_params()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        ffn_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        inactive = l * (self.n_experts - self.top_k) * ffn_mult * d * f
        return self.n_params() - inactive


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
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load()
    return sorted(_REGISTRY)
