"""musicgen-large [audio]: decoder-only over EnCodec tokens, sinusoidal
positions, GELU FFN, LayerNorm, MHA at head_dim 64 (a copy of
`repro.configs.musicgen_large`; the EnCodec frontend is not part of either
package: the model takes token ids). [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=2048, mlp="gelu", norm="layernorm",
        pos="sinusoidal", source="arXiv:2306.05284",
    )
