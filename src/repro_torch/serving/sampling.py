"""Token selection for the serving runtime (port of
`repro.serving.sampling`). Everything stays on the device.

JAX draws sampling noise from per-request PRNG keys; torch's generators give
other numbers, so here the Gumbel noise is an argument: drawn from an
explicit `torch.Generator`, or passed in, so a test can hand both packages
the same noise. `sample_tokens` then equals the JAX package's
`jax.random.categorical` draw, argmax(logits / temperature + gumbel).
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32, the first index of the largest logit."""
    return logits.to(torch.float32).argmax(dim=-1).to(torch.int32)


def gumbel_noise(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    `jax.random.gumbel` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor, *,
                  gumbel: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """One token per row. logits: (B, V); temperature: (B,), 0 = greedy for
    that row. Rows with temperature > 0 add Gumbel noise: `gumbel` (B, V)
    if given, else drawn from `generator`; with neither, every row is
    greedy (the caller knows no row samples). Returns (B,) int32."""
    logits = logits.to(torch.float32)
    best = greedy(logits)
    if gumbel is None:
        if generator is None:
            return best
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    temp = temperature.to(torch.float32).clamp_min(1e-4)[:, None]
    sampled = (logits / temp + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, best)
