"""Reduced same-family configs for CPU tests (a copy of
`repro.configs.smoke` for the families the port serves)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, get_config


def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    if cfg.family != "dense":
        raise KeyError(f"{cfg.family} family is not ported yet "
                       "(ROADMAP Queue A)")
    return dataclasses.replace(
        cfg, d_model=64, d_ff=128, vocab=128, head_dim=16, dtype="float32",
        attn_chunk=16, remat=True, n_layers=2, n_heads=4, n_kv_heads=2)
