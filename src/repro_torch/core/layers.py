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
the weight's second, or reads them from `noise["act"]` and `noise["w"]`;
`Draws` hands out a forward's noise by site name. A forward of one shard's
rows of a global batch (`BatchShard`, the data-parallel train step) draws
what the global batch's forward draws and takes its rows.

At train time the binarized weight is one autograd node with the matmul
(`_BinaryWeightMatmul`): the master is cast to the activation dtype and
binarized in the forward, and the backward recomputes both from the master
instead of keeping the cast and the +-1 copy of every weight alive until
then (the same gradient: the STE through the cast, as JAX differentiates
it).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.core.binarize import (
    binarize, binary_act, hard_sigmoid, ste_mask, uniform_noise,
)
from repro_torch.core.packed import PackedActivation, PackedWeight


class QuantMode(str, enum.Enum):
    NONE = "none"
    BC = "bc"
    BBP = "bbp"
    BBP_DET = "bbp_det"


def _stochastic(train: bool, gen, noise) -> bool:
    return train and (gen is not None or noise is not None)


@dataclass
class BatchShard:
    """A train forward over rows [lo, hi) of a global batch of `rows` rows
    (one shard of the data-parallel step). Its `Draws` draw each batch-major
    site at the global batch's shape and hand out these rows, so that the
    shards together draw what one forward of the global batch draws. Its
    MoE sublayers take the global batch's routes from `routes` by site
    (`models.common.moe_ffn`): a forward of the whole global batch with
    `record` fills them (the capacity and the drops count every row)."""
    lo: int
    hi: int
    rows: int
    routes: dict = field(default_factory=dict)
    record: bool = False


class Draws:
    """The noise of each stochastic site of a train forward: noise[site]
    when a dict is given, else a fresh U[0, 1) draw from `gen` of the
    input's shape and dtype (with a `shard`, of the global batch's shape
    at a batch-major site, of which the shard's rows are handed out). Off
    (no draws) at inference, or with neither a generator nor a dict
    (deterministic binarization, JAX's key=None)."""

    def __init__(self, train: bool, gen: torch.Generator | None,
                 noise: dict | None, shard: BatchShard | None = None):
        self.gen, self.noise, self.shard = gen, noise, shard
        self.on = train and (gen is not None or noise is not None)

    def __call__(self, site: str, like: torch.Tensor,
                 per_row: bool = False) -> torch.Tensor:
        """`per_row`: like's leading axis is the batch's rows."""
        if self.noise is not None:
            return self.noise[site]
        sh = self.shard
        if sh is None or not per_row or (sh.lo, sh.hi) == (0, sh.rows):
            return uniform_noise(like, self.gen)
        u = torch.rand((sh.rows,) + tuple(like.shape[1:]),
                       generator=self.gen, dtype=like.dtype,
                       device=like.device)
        return u[sh.lo:sh.hi]

    def act(self, x: torch.Tensor, site: str, stochastic: bool):
        """binary_act(x), stochastic from this site's draw where asked."""
        return binary_act(x, stochastic=stochastic,
                          noise=self(site, x, True) if stochastic else None)

    def qmatmul(self, site: str, x: torch.Tensor, w: torch.Tensor,
                qm: "QuantMode", per_row: bool = True) -> dict | None:
        """qmatmul's noise at train time: its input's draw (site.qact; x
        batch-major unless `per_row` is False), then its weight's (site.w,
        in the activation dtype, the weight's cast), where the mode
        binarizes them stochastically."""
        if not self.on:
            return None
        noise = {}
        if qm == QuantMode.BBP:
            noise["act"] = self(f"{site}.qact", x, per_row)
        if qm in (QuantMode.BC, QuantMode.BBP):
            noise["w"] = self(f"{site}.w", w.to(x.dtype) if self.noise is None
                              else w)
        return noise


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
    if mode == QuantMode.NONE:
        return torch.matmul(xq, w.to(xq.dtype))
    if not (train and torch.is_grad_enabled() and w.requires_grad):
        wq = quant_weights(w.to(xq.dtype), mode, train=train, gen=gen,
                           noise=noise.get("w"))
        return torch.matmul(xq, wq)
    u = None
    if mode != QuantMode.BBP_DET and _stochastic(train, gen, noise.get("w")):
        u = noise.get("w")
        if u is None:
            u = uniform_noise(w.to(xq.dtype), gen)
    return _BinaryWeightMatmul.apply(xq, w, u)


def _binary_weight(w: torch.Tensor, dtype: torch.dtype,
                   u: torch.Tensor | None):
    """(the master cast to `dtype`, its +-1 binarization): deterministic
    sign, or +1 where u < hard_sigmoid (Eq. 2)."""
    wc = w.to(dtype)
    if u is None:
        minus = wc < 0
    elif u.shape != wc.shape:
        raise ValueError(f"noise of shape {tuple(u.shape)} for a weight of "
                         f"shape {tuple(wc.shape)}")
    else:
        minus = u >= hard_sigmoid(wc)
    return wc, torch.ones_like(wc).masked_fill_(minus, -1.0)


class _BinaryWeightMatmul(torch.autograd.Function):
    """xq @ binarize(w.to(xq.dtype)) for an fp32 master w (K, N), or (E, K,
    N) batched over experts; the backward recomputes the cast and the
    binarization from w (and the draws u) and passes the STE: dw = ((xq^T
    @ g) * 1[|w_cast| <= 1]) cast to w's dtype, dx = g @ w_b^T."""

    @staticmethod
    def forward(ctx, xq, w, u):
        ctx.save_for_backward(xq, w, u)
        return torch.matmul(xq, _binary_weight(w, xq.dtype, u)[1])

    @staticmethod
    def backward(ctx, g):
        xq, w, u = ctx.saved_tensors
        wc, wb = _binary_weight(w, xq.dtype, u)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, wb.transpose(-1, -2))
        del wb
        if ctx.needs_input_grad[1]:
            if w.ndim == 2:
                gw = torch.matmul(xq.reshape(-1, xq.shape[-1]).T,
                                  g.reshape(-1, g.shape[-1]))
            else:
                gw = torch.matmul(xq.transpose(-1, -2), g)
            gw = gw.mul_(ste_mask(wc)).to(w.dtype)
        return gx, gw, None


class DenseParams(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor | None


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = True, dtype: torch.dtype = torch.float32,
               binary_init: bool = False, device=None) -> DenseParams:
    """Paper init: uniform(-1, 1) for binary nets; scaled Glorot
    (N(0, 2 / (in + out))) otherwise. Draws come from `gen`, on its
    device, and land on `device` (default: the generator's)."""
    dev = gen.device if device is None else torch.device(device)
    if binary_init:
        w = torch.rand((in_dim, out_dim), generator=gen, dtype=dtype,
                       device=gen.device) * 2.0 - 1.0
    else:
        scale = torch.sqrt(torch.tensor(2.0 / (in_dim + out_dim))).to(dtype)
        w = torch.randn((in_dim, out_dim), generator=gen, dtype=dtype,
                        device=gen.device) * scale.to(gen.device)
    b = torch.zeros((out_dim,), dtype=dtype, device=dev) if bias else None
    return DenseParams(w=w.to(dev), b=b)


def dense(params: DenseParams, x: torch.Tensor, mode: QuantMode, *,
          train: bool = False, gen: torch.Generator | None = None,
          noise: dict | None = None, path: str = "auto") -> torch.Tensor:
    y = qmatmul(x, params.w, mode, train=train, gen=gen, noise=noise,
                path=path)
    if params.b is not None:
        y = y + params.b
    return y


def shared_pack(x: torch.Tensor, weights, mode: QuantMode, *,
                path: str = "auto") -> torch.Tensor | PackedActivation:
    """Sign-pack a float activation once when every consumer is a frozen
    binary weight; fall through to the float tensor otherwise. `path` as in
    `PackedActivation.pack`."""
    if (mode in (QuantMode.BBP, QuantMode.BBP_DET)
            and all(isinstance(w, PackedWeight) for w in weights)):
        return PackedActivation.pack(x, path=path)
    return x
