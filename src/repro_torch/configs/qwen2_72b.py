"""qwen2-72b [dense]: GQA with QKV bias (a copy of
`repro.configs.qwen2_72b`). [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-72b")
def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, mlp="swiglu", qkv_bias=True,
        rope_theta=1e6, source="arXiv:2407.10671",
    )
