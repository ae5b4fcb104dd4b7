"""dbrx-132b [moe]: 16 experts top-4, fine-grained (a copy of
`repro.configs.dbrx_132b`). [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab=100352, mlp="swiglu", n_experts=16, top_k=4,
        rope_theta=5e5, source="hf:databricks/dbrx-base",
    )
