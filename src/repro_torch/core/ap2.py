"""AP2: approximate power-of-2 proxy (paper Eq. 9-10; port of `repro.core.ap2`).

AP2(z) rounds |z| to the nearest power of two and keeps the sign, so
multiplications become binary shifts. Here, as in the JAX package, the
numerics are realized (values constrained to +-2^k) as exact multiplies;
the energy win of shift-vs-multiply is modeled in `core.energy`.
"""
from __future__ import annotations

import torch


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for int32 e, built from the exponent bits where e
    is a normal exponent (torch.ldexp multiplies by pow(2, e), which is not
    promised to be exact on every device)."""
    normal = (e >= -126) & (e <= 127)
    bits = ((e.clamp(-126, 127) + 127) << 23).to(torch.int32)
    return torch.where(normal, bits.view(torch.float32),
                       torch.ldexp(torch.ones_like(e, dtype=torch.float32), e))


def ap2_exponent(z: torch.Tensor) -> torch.Tensor:
    """Integer shift amount: round(log2 |z|) (half to even, as jnp.round).
    Defined as 0 where z == 0."""
    mag = z.abs()
    return torch.round(torch.log2(torch.where(mag > 0, mag, 1.0))
                       ).to(torch.int32)


def ap2(z: torch.Tensor) -> torch.Tensor:
    """Round each element of z to sign(z) * 2^round(log2 |z|). ap2(0) = 0."""
    mag = z.abs()
    out = torch.sign(z) * pow2(ap2_exponent(z))
    return torch.where(mag > 0, out, 0.0).to(z.dtype)


def shift_mul(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x <<>> AP2(z): multiply x by the exact power-of-2 proxy of z."""
    return x * ap2(z)


def is_power_of_two(z: torch.Tensor) -> torch.Tensor:
    """True where |z| is an exact power of two (or zero): a float is a
    power of two iff its frexp mantissa is exactly 0.5."""
    mag = z.abs()
    mant, _ = torch.frexp(torch.where(mag > 0, mag, 0.5))
    return mant == 0.5
