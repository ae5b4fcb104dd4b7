"""phi3-medium-14b [dense]: RoPE SwiGLU GQA (a copy of
`repro.configs.phi3_medium_14b`). [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("phi3-medium-14b")
def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab=100352, mlp="swiglu", source="arXiv:2404.14219",
    )
