"""Attention entry points the model code imports (port of the packed part
of `repro.models.attention`): attention over a bit-resident KV cache, in the
contiguous and the paged layout, and its V scale. The float-cache
`flash_attention`, `chunk_attention` and `decode_attention` (and their paged
twins) come with the float-cache slice (ROADMAP Queue A)."""
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, decode_attention_packed_paged, v_cache_scale,
)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_packed, prefill_attention_packed_paged,
)

__all__ = ["decode_attention_packed", "decode_attention_packed_paged",
           "prefill_attention_packed", "prefill_attention_packed_paged",
           "v_cache_scale"]
