"""llama-3.2-vision-11b [vlm]: a group of one gated cross-attention block
and four self-attention blocks, eight times over; the vision frontend is a
stub, each request brings its precomputed patch embeddings (a copy of
`repro.configs.llama_3_2_vision_11b`).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-11b")
def llama_32_vision() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256, mlp="swiglu", xattn_group=5,
        n_img_tokens=1600, d_vision=1280, rope_theta=5e5,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
