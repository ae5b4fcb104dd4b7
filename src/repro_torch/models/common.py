"""Shared model components: RMSNorm, RoPE and the dense FFN (port of the
dense part of `repro.models.common`).

Projections route through `core.layers.qmatmul`, so the paper's
quantization is a config switch. `path` ('auto' | 'ref') picks the kernels
or their plain versions for frozen weights, as in `kernels.ops`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.layers import QuantMode, qmatmul, shared_pack


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


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


def ffn(params: dict, x: torch.Tensor, kind: str, mode: QuantMode, *,
        path: str = "auto") -> torch.Tensor:
    """Gated FFN, kind 'swiglu' | 'geglu', params {w_gate (D,F), w_up (D,F),
    w_down (F,D)}. Frozen weights: x is sign-packed once for both gate and
    up projections. ('sq_relu' and 'gelu', with the bit-resident sq_relu
    chain, come with the families that use them.)"""
    if kind not in ("swiglu", "geglu"):
        raise NotImplementedError(f"{kind!r} FFN is not ported yet (ROADMAP "
                                  "Queue A, models/common.py)")
    xs = shared_pack(x, (params["w_gate"], params["w_up"]), mode, path=path)
    g = qmatmul(xs, params["w_gate"], mode, path=path)
    u = qmatmul(xs, params["w_up"], mode, path=path)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
    return qmatmul(act * u, params["w_down"], mode, path=path)


def ffn_param_shapes(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}


def moe_ffn(*args, **kwargs):
    raise NotImplementedError("the MoE FFN is not ported yet (ROADMAP "
                              "Queue A, models/common.py)")
