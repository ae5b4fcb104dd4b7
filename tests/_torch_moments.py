"""Params after one S-AdaMax step, held through the moments (imports no
jax: the CUDA tests use it too).

S-AdaMax moves a param by -s * m * AP2(1 / (u + eps)): on the first step
by about s / 10 however small its gradient. Two evaluations of one step
whose gradients agree to float32 rounding (the JAX package and the port,
or the card and the CPU) then agree on a param at the moments' tolerance,
or the element is one of: (a) a noise-floor gradient, its first moment
within the tolerance of 0 on both sides (its sign is rounding); (b) an AP2
boundary, AP2(1 / (u + eps)) rounding to another power of two on the two
sides from second moments that agree at the tolerance; (c) the moments'
difference carried through a shared AP2 factor A: |dp| <= s |dm| A. No
other element may differ (tests/test_torch_train.py's module doc).
"""
import numpy as np


def held_through_moments(got_p, want_p, got_m, want_m, e_got, e_want, rel,
                         scale) -> dict:
    """Lists of numpy leaves (params, first moments, each side's AP2
    exponent of 1 / (u + eps) as its optimizer took it). Returns the counts
    of elements off by more than rel * max|param| explained by (a), (b)
    and (c); raises AssertionError on any other."""
    counts = {"noise_floor": 0, "ap2": 0, "carried": 0}
    for i, (b, a, mb, ma, eb, ea) in enumerate(zip(
            got_p, want_p, got_m, want_m, e_got, e_want, strict=True)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        ma, mb = np.asarray(ma, np.float64), np.asarray(mb, np.float64)
        top = np.abs(a).max() if a.size else 0.0
        diff = np.abs(b - a)
        off = diff > rel * top
        if not off.any():
            continue
        floor = rel * np.abs(ma).max()
        noise = (np.abs(ma) <= floor) & (np.abs(mb) <= floor)
        ap2 = ~noise & (eb != ea)
        carried = ~noise & (eb == ea) & (
            diff <= scale * np.abs(mb - ma) * 2.0 ** ea * (1 + 1e-6)
            + rel * top)
        bad = off & ~(noise | ap2 | carried)
        assert not bad.any(), (f"param leaf {i}: {int(bad.sum())} elements "
                               f"differ beyond {rel} and are none of (a)-(c)")
        counts["noise_floor"] += int((off & noise).sum())
        counts["ap2"] += int((off & ap2).sum())
        counts["carried"] += int((off & carried).sum())
    return counts


def first_step_scale(lr: float, b1: float = 0.9) -> float:
    """S-AdaMax's first-step scale s = AP2(lr / (1 - b1)) in float32."""
    return float(2.0 ** np.round(np.log2(np.float32(lr)
                                         / (1 - np.float32(b1)))))
