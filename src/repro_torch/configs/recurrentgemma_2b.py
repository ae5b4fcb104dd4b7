"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern (rec, rec,
attn), window 2048, tied embeddings (a copy of
`repro.configs.recurrentgemma_2b`). [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, mlp="geglu",
        block_pattern=("rec", "rec", "attn"), local_window=2048,
        lru_width=2560, d_conv=4, tie_embeddings=True,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source="arXiv:2402.19427",
    )
