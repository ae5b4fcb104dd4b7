"""Attention entry points the model code imports (port of the packed part
of `repro.models.attention`): attention over a bit-resident KV cache and its
V scale. The float-cache `flash_attention`, `chunk_attention` and
`decode_attention` come with the float-cache slice (ROADMAP Queue A)."""
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, v_cache_scale,
)
from repro_torch.kernels.prefill_attention import prefill_attention_packed

__all__ = ["decode_attention_packed", "prefill_attention_packed",
           "v_cache_scale"]
