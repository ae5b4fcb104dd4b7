"""falcon-mamba-7b [ssm]: attention-free Mamba-1 stack, ssm_state=16 (a copy
of `repro.configs.falcon_mamba_7b`). [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=65024, ssm_state=16, d_conv=4, expand=2, dt_rank=256,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source="arXiv:2410.05355",
    )
