"""Reduced same-family configs for CPU tests (a copy of
`repro.configs.smoke`)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, get_config


def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    over: dict = dict(
        d_model=64, d_ff=128, vocab=128, head_dim=16, dtype="float32",
        attn_chunk=16, remat=True,
    )
    if cfg.family == "ssm":
        over.update(n_layers=3, ssm_state=4, dt_rank=8, expand=2,
                    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0)
    elif cfg.family == "hybrid":
        over.update(n_layers=8, n_heads=4, n_kv_heads=1, lru_width=64,
                    local_window=8)
    elif cfg.family == "vlm":
        over.update(n_layers=10, xattn_group=5, n_heads=4, n_kv_heads=2,
                    n_img_tokens=8, d_vision=32)
    elif cfg.family == "audio":
        over.update(n_layers=2, n_heads=4, n_kv_heads=4, vocab=128)
    elif cfg.family == "moe":
        over.update(n_layers=2, n_heads=4, n_kv_heads=2, n_experts=4,
                    top_k=min(cfg.top_k, 2), capacity_factor=8.0)
    else:
        over.update(n_layers=2, n_heads=4, n_kv_heads=2)
    return dataclasses.replace(cfg, **over)
