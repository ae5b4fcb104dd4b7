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

A master placed over a mesh (`core.placed.Placed`, the train step's
handle on its pieces) runs through `_PlacedMatmul`, which keeps only the
pieces for the backward: the forward gathers the weight over its FSDP axes
('data', 'pod') and the backward gathers it again (ZeRO-3's reshard after
forward), so no gathered weight lives from a layer's forward to its
backward. Where the spec splits a dim over 'model', each 'model' device
computes its part: columns (`(..., 'data', 'model')`) give `x @ w_m`,
concatenated on the row's device; rows (`('model', 'data')`: wo, w_down,
out_proj, w_out, x_proj) take x's K-slice, and the partial products are
summed in float32 in 'model' order and cast once; experts (`('model',
...)` on the leading E of a batched weight) take their slice of the
buffer. The backward is the transpose (the columns' dx summed in float32
in 'model' order). A weight's draws are taken at its whole shape and each
part takes its slice, so a mesh draws what one device draws.
`embedding_rows` and `float_matmul` (the head) take a placed table too.
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
from repro_torch.core.placed import Placed, join_pieces, split_grad


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
            like = w
            if self.noise is None:
                like = _Like(w.shape, x.dtype, x.device) \
                    if isinstance(w, Placed) else w.to(x.dtype)
            noise["w"] = self(f"{site}.w", like)
        return noise


class _Like(NamedTuple):
    """What a draw reads of the tensor it is shaped like."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


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
    if isinstance(w, Placed):
        return _placed_matmul(xq, w, mode, train, gen, noise.get("w"))
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
            gw = _masked_weight_grad(xq, g, wc, True).to(w.dtype)
        return gx, gw, None


def _placed_matmul(xq, w: Placed, mode: QuantMode, train: bool, gen,
                   u: torch.Tensor | None) -> torch.Tensor:
    """qmatmul's product for a placed master: `_PlacedMatmul` when the
    gradient flows, and at inference (no piece requires a gradient: the
    prefill and decode steps over a mesh), where its forward computes the
    'model' parts as in training; else (a forward without gradient of
    pieces that train, the MoE step's routing forward) the whole master
    gathered and the unplaced path."""
    infer = not any(p.requires_grad for p in w.tensors())
    if infer and w.model_dim() is not None:
        with torch.no_grad():
            return _PlacedMatmul.apply(xq, None, w, mode != QuantMode.NONE,
                                       *w.tensors())
    if not (train and torch.is_grad_enabled() and not infer):
        with torch.no_grad():
            wg = w.gather().to(xq.dtype)
        if mode == QuantMode.NONE:
            return torch.matmul(xq, wg)
        return torch.matmul(xq, quant_weights(wg, mode, train=train, gen=gen,
                                              noise=u))
    binary = mode != QuantMode.NONE
    if (u is None and binary and mode != QuantMode.BBP_DET
            and _stochastic(train, gen, None)):
        u = uniform_noise(_Like(w.shape, xq.dtype, xq.device), gen)
    return _PlacedMatmul.apply(xq, u, w, binary, *w.tensors())


def float_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.to(x.dtype), a float product (the LM head); w may be a placed
    master (its 'model' parts are vocabulary columns)."""
    if isinstance(w, Placed):
        return _placed_matmul(x, w, QuantMode.NONE, True, None, None)
    return torch.matmul(x, w.to(x.dtype))


def embedding_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """table[ids]. A placed table (spec `('model', 'data')`: vocabulary
    rows over 'model') is gathered over 'data'; with 'model' > 1 each
    'model' device looks up the ids in its rows, masked, and the parts are
    summed on the row's device (exact: one of them is non-zero)."""
    if not isinstance(table, Placed):
        return table[ids]
    if table.model_dim() != 0:
        return table.gather()[ids]
    out = None
    for m in range(table.mesh.shape["model"]):
        part = table.gather(m)
        lo, n = m * part.shape[0], part.shape[0]
        local = ids.to(part.device) - lo
        hit = (local >= 0) & (local < n)
        rows = part[local.clamp(0, n - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        rows = rows.to(table.device)
        out = rows if out is None else out + rows
    return out


class _PlacedMatmul(torch.autograd.Function):
    """xq @ q(w) for a placed master w (`core.placed.Placed`), q the
    +-1 binarization (`binary`, with the STE) or the cast to xq's dtype:
    the module doc's columns / rows / experts over 'model', or, where the
    spec splits no dim over 'model', the whole weight on the row's
    device. Saves xq, the pieces and the draws cut as the pieces are
    (`_spread`); the weight and its draws are gathered again in the
    backward. dw goes to each piece, on its device."""

    @staticmethod
    def forward(ctx, xq, u, w: Placed, binary: bool, *pieces):
        ctx.w, ctx.binary, ctx.drawn = w, binary, u is not None
        ctx.save_for_backward(xq, *pieces,
                              *([] if u is None else _spread(u, w, pieces)))
        md, row = w.model_dim(), w.device
        if md is None:
            wq = _operand(join_pieces(w.layout(), pieces), w, xq.dtype, u,
                          binary)[1]
            return torch.matmul(xq, wq)
        kind = _kind(w, md)
        wd, xd, _ = _CUTS[kind]
        outs = []
        for m in range(w.mesh.shape["model"]):
            lay = w.layout(m)
            wm = join_pieces(lay, pieces)
            um = None if u is None else _cut(u, wd, m, w).to(lay.device)
            wq = _operand(wm, w, xq.dtype, um, binary)[1]
            xm = _cut(xq, xd, m, w).to(lay.device)
            if kind == "rows":
                outs.append(torch.matmul(xm.float(), wq.float()).to(row))
            else:
                outs.append(torch.matmul(xm, wq).to(row))
        if kind == "rows":
            return _sum_f32(outs).to(xq.dtype)
        return torch.cat(outs, dim=-1 if kind == "cols" else 0)

    @staticmethod
    def backward(ctx, g):
        w, binary = ctx.w, ctx.binary
        xq, *rest = ctx.saved_tensors
        n = len(w.tensors())
        pieces, drawn = rest[:n], rest[n:] if ctx.drawn else None
        need_x = ctx.needs_input_grad[0]
        grads = [None] * len(pieces)
        md, row = w.model_dim(), w.device
        if md is None:
            lay = w.layout()
            wm = join_pieces(lay, pieces)
            u = _gathered_draws(drawn, lay, w)
            if not binary:
                gx, gw = _float_grads(xq, wm, w, g, need_x)
                _to_pieces(grads, lay, gw, pieces, wm.dtype)
                return (gx, None, None, None, *grads)
            wc, wq = _operand(wm, w, xq.dtype, u, True)
            gx = torch.matmul(g, wq.transpose(-1, -2)) if need_x else None
            del wq
            gw = _masked_weight_grad(xq, g, wc, True)
            _to_pieces(grads, lay, _stored(gw, w), pieces, wm.dtype)
            return (gx, None, None, None, *grads)
        kind = _kind(w, md)
        wd, xd, gd = _CUTS[kind]
        gxs = []
        for m in range(w.mesh.shape["model"]):
            lay = w.layout(m)
            wm = join_pieces(lay, pieces)
            um = _gathered_draws(drawn, lay, w)
            wc, wq = _operand(wm, w, xq.dtype, um, binary)
            gm = _cut(g, gd, m, w).to(lay.device)
            if need_x:
                if kind == "cols":
                    gxs.append(torch.matmul(gm.float(), wq.float()
                                            .transpose(-1, -2)).to(row))
                else:
                    gxs.append(torch.matmul(gm, wq.transpose(-1, -2))
                               .to(row))
            del wq
            xm = _cut(xq, xd, m, w).to(lay.device)
            gw = _masked_weight_grad(xm, gm, wc, binary)
            _to_pieces(grads, lay, _stored(gw, w), pieces, wm.dtype)
        gx = None
        if need_x:
            gx = _sum_f32(gxs).to(xq.dtype) if kind == "cols" else \
                torch.cat(gxs, dim=-1 if kind == "rows" else 0)
        return (gx, None, None, None, *grads)


# per kind, the dim of (a weight-shaped tensor, the lhs, the output) that
# 'model' part m takes its slice of (None: the whole tensor)
_CUTS = {"cols": (-1, None, -1), "rows": (-2, -1, None),
         "experts": (0, 0, 0)}


def _kind(w: Placed, md: int) -> str:
    """Which dim 'model' splits: 'cols' (N), 'rows' (K) or 'experts' (the
    leading E of a batched weight)."""
    if md == w.ndim - 1:
        return "cols"
    if md == w.ndim - 2:
        return "rows"
    if w.ndim == 3 and md == 0:
        return "experts"
    raise ValueError(f"no tensor-parallel matmul splits dim {md} of a "
                     f"{w.ndim}-D weight (spec {w.view_spec})")


def _cut(t: torch.Tensor, dim: int | None, m: int, w: Placed) -> torch.Tensor:
    """'model' part m of t along `dim` (t itself where dim is None)."""
    if dim is None:
        return t
    n, parts = t.shape[dim], w.mesh.shape["model"]
    return t.narrow(dim, m * n // parts, n // parts)


def _spread(u: torch.Tensor, w: Placed, pieces) -> list[torch.Tensor]:
    """A weight's draws u (its whole shape, the consumer's orientation)
    cut as the master is: each piece's slice, a copy on the piece's
    device, so that no whole-shape draw is kept for the backward."""
    st, lay = _stored(u, w), w.layout()
    parts = {k: st[cut].clone(memory_format=torch.contiguous_format)
             .to(pieces[k].device) for k, cut in zip(lay.take, lay.cuts)}
    return [parts[k] for k in range(len(pieces))]


def _gathered_draws(drawn, lay, w: Placed) -> torch.Tensor | None:
    """The draws of `lay`'s gather (the consumer's orientation), joined
    from `_spread`'s slices; None where nothing was drawn."""
    return None if drawn is None else _stored(join_pieces(lay, drawn), w)


def _sum_f32(parts: list[torch.Tensor]) -> torch.Tensor:
    """The parts summed in float32 in order."""
    out = parts[0].to(torch.float32)
    for p in parts[1:]:
        out = out + p.to(torch.float32)
    return out


def _operand(wm: torch.Tensor, w: Placed, dtype: torch.dtype,
             u: torch.Tensor | None, binary: bool):
    """(the gathered weight cast to `dtype`, the matmul's operand: its
    +-1 binarization, or the cast), in the consumer's orientation."""
    if w.transposed:
        wm = wm.transpose(-1, -2)
    if binary:
        return _binary_weight(wm, dtype, u)
    wc = wm.to(dtype)
    return wc, wc


def _masked_weight_grad(x: torch.Tensor, g: torch.Tensor, wc: torch.Tensor,
                        binary: bool) -> torch.Tensor:
    """dw = x^T g over every row, times the STE mask where binary."""
    if wc.ndim == 2:
        gw = torch.matmul(x.reshape(-1, x.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
    else:
        gw = torch.matmul(x.transpose(-1, -2), g)
    return gw.mul_(ste_mask(wc)) if binary else gw


def _float_grads(xq, wm, w: Placed, g, need_x: bool):
    """(dx, dw) of torch.matmul(xq, w.to(xq.dtype)) for the whole gathered
    weight, by autograd on a recomputed product: the gradients of the
    unplaced float product bit for bit."""
    with torch.enable_grad():
        x = xq.detach().requires_grad_(need_x)
        leaf = wm.detach().requires_grad_(True)
        wv = leaf.transpose(-1, -2) if w.transposed else leaf
        y = torch.matmul(x, wv.to(x.dtype))
        ins = (x, leaf) if need_x else (leaf,)
        out = torch.autograd.grad(y, ins, g)
    return (out[0], out[1]) if need_x else (None, out[0])


def _stored(t: torch.Tensor, w: Placed) -> torch.Tensor:
    """t of the consumer's orientation in the stored one."""
    return t.transpose(-1, -2) if w.transposed else t


def _to_pieces(grads: list, lay, gw: torch.Tensor, pieces,
               dtype: torch.dtype) -> None:
    """Hand each piece of `lay` its slice of gw (stored orientation), cast
    to the master's dtype."""
    for k, t in split_grad(lay, gw.to(dtype),
                           [p.device for p in pieces]).items():
        grads[k] = t


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
