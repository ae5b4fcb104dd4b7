"""Quantized linear layers (port of `repro.core.layers`).

`QuantMode` selects the arithmetic of every MAC-dominated projection:

  NONE    — full-precision baseline
  BC      — BinaryConnect: binary weights, fp activations
  BBP     — the paper: binary weights AND binary activations
  BBP_DET — BBP with deterministic binarization at train time as well

At inference every binary mode binarizes deterministically (sign(0) := +1).
At train time (`train=True` with a generator or noise) BC and BBP binarize
stochastically (Eq. 2), BBP_DET deterministically; every binarizer carries
the STE. Where JAX splits one key into a weight key and an activation key,
`qmatmul` takes two independent draws from `gen`, the activation's first and
the weight's second, or reads them from `noise["act"]` and `noise["w"]`.
"""
from __future__ import annotations

import enum

import torch

from repro_torch.core.binarize import binarize, binary_act
from repro_torch.core.packed import PackedActivation, PackedWeight


class QuantMode(str, enum.Enum):
    NONE = "none"
    BC = "bc"
    BBP = "bbp"
    BBP_DET = "bbp_det"


def _stochastic(train: bool, gen, noise) -> bool:
    return train and (gen is not None or noise is not None)


def quant_weights(w: torch.Tensor, mode: QuantMode, *, train: bool = False,
                  gen: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    if mode == QuantMode.NONE:
        return w
    if mode in (QuantMode.BC, QuantMode.BBP):
        # stochastic at train (Eq. 2), deterministic sign at test (Eq. 5)
        return binarize(w, stochastic=_stochastic(train, gen, noise),
                        gen=gen, noise=noise)
    if mode == QuantMode.BBP_DET:
        return binarize(w)
    raise ValueError(mode)


def quant_acts(x: torch.Tensor, mode: QuantMode, *, train: bool = False,
               gen: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    if mode in (QuantMode.NONE, QuantMode.BC):
        return x
    if mode == QuantMode.BBP:
        return binary_act(x, stochastic=_stochastic(train, gen, noise),
                          gen=gen, noise=noise)
    if mode == QuantMode.BBP_DET:
        return binary_act(x)
    raise ValueError(mode)


def packed_qmatmul(x: torch.Tensor | PackedActivation, w: PackedWeight,
                   mode: QuantMode, *, path: str = "auto") -> torch.Tensor:
    """x @ w for a weight frozen to 1-bit at load time.

    BBP/BBP_DET: XNOR+popcount against the pre-packed words (x may be a
    PackedActivation, consumed without a re-pack). BC: unpack to +-1 and
    run the fp matmul. `path` as in `kernels.ops`.
    """
    if mode == QuantMode.NONE:
        raise ValueError("params are frozen to 1-bit but quant mode is "
                         "'none'; packed weights require a binary mode")
    if mode == QuantMode.BC:
        if isinstance(x, PackedActivation):
            raise ValueError("BC consumes full-precision activations — a "
                             "PackedActivation lhs only carries sign bits")
        return torch.matmul(x, w.unpack(x.dtype))
    from repro_torch.kernels.ops import packed_matmul  # avoids import cycle
    return packed_matmul(x, w, path=path).to(x.dtype)


def packed_qmatmul_fused(x: torch.Tensor | PackedActivation, w: PackedWeight,
                         mode: QuantMode, *,
                         thresh: torch.Tensor | None = None,
                         flip: torch.Tensor | None = None,
                         path: str = "auto") -> PackedActivation:
    """One bit-resident layer step: popcount GEMM whose epilogue applies the
    folded threshold (w's, or an explicit re-folded pair) and emits the
    next layer's PackedActivation."""
    if mode not in (QuantMode.BBP, QuantMode.BBP_DET):
        raise ValueError("the fused epilogue binarizes its output; it "
                         "requires a binary-activation mode")
    from repro_torch.kernels.ops import packed_matmul_fused
    return packed_matmul_fused(x, w, thresh=thresh, flip=flip, path=path)


def qmatmul(x: torch.Tensor | PackedActivation, w: torch.Tensor | PackedWeight,
            mode: QuantMode, *, train: bool = False,
            gen: torch.Generator | None = None, noise: dict | None = None,
            path: str = "auto") -> torch.Tensor:
    """Quantized x @ w with the mode's weight/activation treatment.

    w: (K, N) fp32 master, or a PackedWeight (the packed serving path,
    inference only). At train time the activation's noise is drawn from
    `gen` before the weight's (or read from noise["act"], noise["w"])."""
    if isinstance(w, PackedWeight):
        if train:
            raise ValueError("packed params are frozen sign bits, inference "
                             "only; keep the fp32 masters for training "
                             "(paper Alg. 1)")
        return packed_qmatmul(x, w, mode, path=path)
    if isinstance(x, PackedActivation):
        raise ValueError("PackedActivation lhs requires a frozen "
                         "PackedWeight rhs")
    noise = noise or {}
    xq = quant_acts(x, mode, train=train, gen=gen, noise=noise.get("act"))
    # the master is cast to the compute dtype before it is binarized
    wq = quant_weights(w.to(xq.dtype), mode, train=train, gen=gen,
                       noise=noise.get("w"))
    return torch.matmul(xq, wq)


def shared_pack(x: torch.Tensor, weights, mode: QuantMode, *,
                path: str = "auto") -> torch.Tensor | PackedActivation:
    """Sign-pack a float activation once when every consumer is a frozen
    binary weight; fall through to the float tensor otherwise. `path` as in
    `PackedActivation.pack`."""
    if (mode in (QuantMode.BBP, QuantMode.BBP_DET)
            and all(isinstance(w, PackedWeight) for w in weights)):
        return PackedActivation.pack(x, path=path)
    return x
