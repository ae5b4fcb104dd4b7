"""llama4-scout-17b-a16e [moe]: 16 experts, top-1 routing (a copy of
`repro.configs.llama4_scout_17b_a16e`: no shared expert, as there).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048, mlp="swiglu", n_experts=16, top_k=1,
        rope_theta=5e5, source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
