"""Shared model components: RMSNorm, LayerNorm, RoPE, sinusoidal positions
and the dense FFNs (port of the dense part of `repro.models.common`).

Projections route through `core.layers.qmatmul`, so the paper's
quantization is a config switch. `path` ('auto' | 'ref') picks the kernels
or their plain versions for frozen weights, as in `kernels.ops`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.layers import (
    QuantMode, packed_qmatmul, packed_qmatmul_fused, qmatmul, shared_pack,
)
from repro_torch.core.packed import PackedWeight


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype. The callers pass the
    gain as 1 + scale, as the JAX package's do."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, d) with even d; positions: (S,) or (B, S). The rotation
    runs in float32 and rounds back to x.dtype, as in the JAX package."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs      # (S|B,S, half)
    ang = ang[None, :, None, :] if positions.ndim == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """MusicGen-style sinusoidal position embedding, float32 (S, d) for
    positions (S,), sin then cos halves, as the JAX package computes it."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def ffn(params: dict, x: torch.Tensor, kind: str, mode: QuantMode, *,
        path: str = "auto") -> torch.Tensor:
    """kind 'swiglu' | 'geglu' (params {w_gate (D,F), w_up (D,F), w_down
    (F,D)}) or 'sq_relu' | 'gelu' (params {w_up, w_down}).

    Frozen weights: the GLU kinds sign-pack x once for both gate and up
    projections. A frozen sq_relu FFN whose w_up carries the 'act:sq_relu'
    fold (`core.packed.attach_ffn_act_thresholds`) runs bit-resident: the
    up-projection's fused epilogue (kernel 3) emits the hidden bits, which
    the down-projection reads as packed words (kernel 1). The fold is the
    constant +1 bit that binarize(relu(z)^2) gives unfused, so the block's
    output does not depend on x; the JAX package keeps the live chain and
    so does the port. gelu's sign is not a threshold of the integer dot
    (tanh-gelu saturates to -0.0), so it stays unfused."""
    w_up = params["w_up"]
    if (kind == "sq_relu" and isinstance(w_up, PackedWeight)
            and w_up.fold == "act:sq_relu"
            and mode in (QuantMode.BBP, QuantMode.BBP_DET)):
        h = packed_qmatmul_fused(x, w_up, mode, path=path)
        return packed_qmatmul(h, params["w_down"], mode, path=path)
    if kind in ("swiglu", "geglu"):
        xs = shared_pack(x, (params["w_gate"], w_up), mode, path=path)
        g = qmatmul(xs, params["w_gate"], mode, path=path)
        u = qmatmul(xs, w_up, mode, path=path)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    elif kind == "sq_relu":
        h = torch.relu(qmatmul(x, w_up, mode, path=path)).square()
    elif kind == "gelu":
        h = F.gelu(qmatmul(x, w_up, mode, path=path), approximate="tanh")
    else:
        raise ValueError(kind)
    return qmatmul(h, params["w_down"], mode, path=path)


def ffn_param_shapes(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}


def moe_ffn(*args, **kwargs):
    raise NotImplementedError("the MoE FFN is not ported yet (ROADMAP "
                              "Queue A, models/common.py)")
