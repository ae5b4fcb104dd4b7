"""nemotron-4-15b [dense]: GQA + squared-ReLU FFN, LayerNorm (a copy of
`repro.configs.nemotron_4_15b`). [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("nemotron-4-15b")
def nemotron_4_15b() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=256000, mlp="sq_relu", norm="layernorm",
        pos="rope", source="arXiv:2402.16819",
    )
