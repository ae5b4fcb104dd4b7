"""Packed parameter representation: freeze fp32 masters to 1-bit weights
(port of `repro.core.packed`).

`PackedWeight` holds sign bits in the kernel wire format (`core.bitpack`,
int32 words) plus what is needed to recover the logical tensor:

  dense  — logical (..., K, N): packed along K of w^T -> (..., N, KW), the
           rhs operand of the binary GEMM kernels.
  conv   — logical (kh, kw, cin, cout): packed along the im2col axis
           k = cin*kh*kw -> (cout, KW), the weight matrix of `packed_conv2d`.

`PackedActivation` is the value between binary layers of a bit-resident
chain: the sign bits of an activation in the same wire format.

`fold_*_sign_threshold` fold what sits between a binary GEMM and the next
sign() into a per-channel integer threshold on the popcount dot: every
inference epilogue here is y = s*(dot - mean) + beta per channel, and
sign(y) over an integer dot collapses to (dot >= t) XOR flip.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.core.ap2 import ap2
from repro_torch.core.bitpack import pack_bits, unpack_bits

# threshold value that makes (dot >= t) true for every reachable dot
# (|dot| <= K < 2^31): used for constant-bit channels and N-padding.
ALWAYS_THRESH = -(2**31) + 1

# dict keys of weights that are binarized in the forward pass (the same set
# as the JAX package's).
BINARY_WEIGHT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "in_proj", "out_proj", "x_proj", "w_x", "w_out", "w",
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PackedWeight:
    """A frozen 1-bit weight: packed sign words + logical metadata.

    Optionally carries the fused-epilogue threshold of the layer's output:
    `thresh`/`flip` (..., N) int32 such that the next layer's input bit for
    channel n is (dot_n >= thresh_n) XOR flip_n. `fold` names what was
    folded ("exact-bn" | "shift-bn" | "bias" | an act tag).
    """

    def __init__(self, packed: torch.Tensor, k: int, kind: str = "dense",
                 conv_shape: tuple[int, ...] | None = None,
                 orig_dtype: torch.dtype = torch.float32,
                 thresh: torch.Tensor | None = None,
                 flip: torch.Tensor | None = None, fold: str | None = None):
        self.packed = packed          # (..., N, KW) int32 wire-format words
        self.k = int(k)               # true contraction length (pre-padding)
        self.kind = kind              # "dense" | "conv"
        self.conv_shape = tuple(conv_shape) if conv_shape else None
        self.orig_dtype = orig_dtype
        self.thresh = thresh          # (..., N) int32 | None
        self.flip = flip              # (..., N) int32 (0/1) | None
        self.fold = fold              # what the threshold folds, or None

    @property
    def has_threshold(self) -> bool:
        return self.thresh is not None

    def with_threshold(self, thresh: torch.Tensor, flip: torch.Tensor,
                       fold: str) -> "PackedWeight":
        """Attach a freeze-time folded output threshold."""
        n = tuple(self.packed.shape[:-1])     # (..., N)
        if tuple(thresh.shape) != n or tuple(flip.shape) != n:
            raise ValueError(f"threshold shape {tuple(thresh.shape)} / "
                             f"{tuple(flip.shape)} != {n}")
        return PackedWeight(self.packed, self.k, self.kind, self.conv_shape,
                            self.orig_dtype, thresh=thresh.to(torch.int32),
                            flip=flip.to(torch.int32), fold=fold)

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (unpacked) shape."""
        if self.kind == "conv":
            return self.conv_shape
        return tuple(self.packed.shape[:-2]) + (self.k, self.packed.shape[-2])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        nb = _nbytes(self.packed)
        if self.thresh is not None:   # folded epilogue rides with the weight
            nb += _nbytes(self.thresh) + _nbytes(self.flip)
        return nb

    def to(self, device) -> "PackedWeight":
        move = (lambda t: None if t is None else t.to(device))
        return PackedWeight(move(self.packed), self.k, self.kind,
                            self.conv_shape, self.orig_dtype,
                            thresh=move(self.thresh), flip=move(self.flip),
                            fold=self.fold)

    def __repr__(self):
        tag = f", fold={self.fold!r}" if self.fold else ""
        return (f"PackedWeight(kind={self.kind!r}, shape={self.shape}, "
                f"packed={tuple(self.packed.shape)} int32{tag})")

    def unpack(self, dtype=None) -> torch.Tensor:
        """Materialize the logical +-1 tensor."""
        flat = unpack_bits(self.packed, self.k,
                           dtype=dtype or self.orig_dtype)   # (..., N, K)
        if self.kind == "conv":
            kh, kw, cin, cout = self.conv_shape
            return flat.reshape(cout, cin, kh, kw).permute(2, 3, 1, 0)
        return flat.transpose(-1, -2)


class PackedActivation:
    """Sign bits of an activation tensor in the kernel wire format.

    `packed` is (..., KW) int32 with pad bits 1 (+1), `k` the true feature
    dim. Made by `pack()` or by the fused GEMM epilogue, and consumed as the
    lhs of the next popcount GEMM.
    """

    def __init__(self, packed: torch.Tensor, k: int,
                 dtype: torch.dtype = torch.float32):
        self.packed = packed          # (..., KW) int32 wire-format words
        self.k = int(k)               # true feature dim (pre-padding)
        self.dtype = dtype            # dtype dense results are cast back to

    @classmethod
    def pack(cls, x: torch.Tensor, *, path: str = "auto"
             ) -> "PackedActivation":
        """Sign-pack a float activation once, for every GEMM that reads it:
        path 'auto' through `kernels.pack.pack_bits_kernel` (the Hopper
        kernel on a CUDA tensor, its plain version on a CPU one), 'ref'
        through the plain version on any device."""
        if path == "auto":
            from repro_torch.kernels.pack import pack_bits_kernel
            words = pack_bits_kernel(x)
        elif path == "ref":
            words = pack_bits(x)
        else:
            raise ValueError(path)
        return cls(words, k=x.shape[-1], dtype=x.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical (unpacked) shape."""
        return tuple(self.packed.shape[:-1]) + (self.k,)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.packed)

    def unpack(self, dtype=None) -> torch.Tensor:
        """Materialize the logical +-1 tensor."""
        return unpack_bits(self.packed, self.k, dtype=dtype or self.dtype)

    def __repr__(self):
        return (f"PackedActivation(shape={self.shape}, "
                f"packed={tuple(self.packed.shape)} int32)")


# ---------------------------------------------------------------------------
# Freeze-time threshold folding. With y = s*(dot - mean) + beta per channel:
#     s > 0:  y >= 0  <=>  dot >= mean - beta/s  <=>  dot >= ceil(c)
#     s < 0:  y >= 0  <=>  dot <= c              <=>  NOT(dot >= floor(c)+1)
#     s == 0: y = beta — a constant bit.
# ---------------------------------------------------------------------------
def _affine_sign_threshold(s: torch.Tensor, mean: torch.Tensor,
                           beta: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    c = mean - beta / torch.where(s == 0, 1.0, s)
    c = c.clamp(float(-(2**31) + 2), float(2**31 - 2))
    t = torch.where(s > 0, torch.ceil(c), torch.floor(c) + 1)
    # float32 rounds the clamp bound up to 2^31: saturate the way XLA's
    # float->int32 conversion does instead of overflowing
    t = t.to(torch.float64).clamp(-(2**31), 2**31 - 1).to(torch.int32)
    flip = (s < 0).to(torch.int32)
    t = torch.where(s == 0, ALWAYS_THRESH, t)
    flip = torch.where(s == 0, (beta < 0).to(torch.int32), flip)
    return t, flip


def fold_bn_sign_threshold(gamma: torch.Tensor, beta: torch.Tensor,
                           mean: torch.Tensor, var: torch.Tensor, *,
                           kind: str = "shift", eps: float = 1e-4
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold inference-time (shift-)BN + sign into (thresh, flip).

    kind='exact':  y = (dot - mean) * rsqrt(var+eps) * gamma + beta
    kind='shift':  y = (dot - mean) * AP2(rsqrt(var+eps)) * AP2(gamma) + beta
    Returns per-channel int32 (thresh, flip): next-layer input bit is
    (dot >= thresh) XOR flip == (sign(y) == +1), with sign(0) := +1.
    """
    inv = torch.rsqrt(var + eps)
    if kind == "shift":
        s = ap2(inv) * ap2(gamma)
    elif kind == "exact":
        s = inv * gamma
    else:
        raise ValueError(kind)
    return _affine_sign_threshold(s, mean, beta)


def fold_bias_sign_threshold(b: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (dot + b) * positive_scale >= 0 into (thresh, flip): the paper
    MLP's epilogue. Exact for integer dots: dot + b >= 0 <=> dot >= ceil(-b)."""
    t = torch.ceil(-b).to(torch.int32)
    return t, torch.zeros_like(t)


def fold_act_sign_threshold(n_or_shape, act: str, *, device=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold sign(act(dot)) for activations whose sign is a pure threshold of
    the integer dot. 'sq_relu': relu(dot)^2 >= 0 always, a constant +1 bit."""
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else tuple(n_or_shape)
    dev = resolve_device(device)
    if act == "sq_relu":
        return (torch.full(shape, ALWAYS_THRESH, dtype=torch.int32, device=dev),
                torch.zeros(shape, dtype=torch.int32, device=dev))
    raise ValueError(f"activation {act!r} has no exact integer-threshold "
                     "fold (e.g. fp32 tanh-gelu saturates to -0.0)")


def _pack_dense(w: torch.Tensor) -> PackedWeight:
    """(..., K, N) float -> wire-format PackedWeight."""
    return PackedWeight(pack_bits(w.transpose(-1, -2)), k=w.shape[-2],
                        kind="dense", orig_dtype=w.dtype)


def _pack_conv(w: torch.Tensor) -> PackedWeight:
    """(kh, kw, cin, cout) float -> im2col wire-format PackedWeight."""
    kh, kw, cin, cout = w.shape
    wmat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return PackedWeight(pack_bits(wmat.T), k=cin * kh * kw, kind="conv",
                        conv_shape=tuple(w.shape), orig_dtype=w.dtype)


def map_tree(fn: Callable[[str | None, Any], Any], node, name=None):
    """Apply fn(dict_key, leaf) to every leaf of a tree of dicts, lists,
    tuples and NamedTuples. A leaf's key is its own dict key, or None under
    a list, tuple or NamedTuple (as jax.tree_util paths name them)."""
    if isinstance(node, dict):
        return {k: map_tree(fn, v, k) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(map_tree(fn, v) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(map_tree(fn, v) for v in node)
    return fn(name, node)


def freeze_params(params, keys: frozenset[str] | set[str] = BINARY_WEIGHT_KEYS):
    """Replace every binary-weight leaf with its 1-bit PackedWeight.

    A leaf is frozen when its own dict key is in `keys` and it is a weight
    matrix (ndim >= 2). 4-D conv kernels under key 'w' pack in im2col
    layout; everything else packs over the last two (K, N) dims.
    """
    def leaf(name, p):
        if not isinstance(p, torch.Tensor) or name not in keys or p.ndim < 2:
            return p
        if name == "w" and p.ndim == 4:
            return _pack_conv(p)
        return _pack_dense(p)

    return map_tree(leaf, params)


def unfreeze_params(params, dtype=None):
    """Inverse of freeze_params (up to sign): PackedWeight -> +-1 floats."""
    return map_tree(lambda _, p: p.unpack(dtype)
                    if isinstance(p, PackedWeight) else p, params)


def params_frozen(params) -> bool:
    """True if the tree contains any PackedWeight leaf."""
    found = []
    map_tree(lambda _, p: found.append(isinstance(p, PackedWeight)), params)
    return any(found)


def resident_weight_bytes(params, keys: frozenset[str] | set[str]
                          = BINARY_WEIGHT_KEYS) -> dict[str, int]:
    """Resident bytes split into binary-layer weights vs everything else:
    packed words for PackedWeight leaves, full tensor bytes otherwise."""
    out = {"binary": 0, "other": 0}

    def leaf(name, p):
        if isinstance(p, PackedWeight):
            out["binary"] += p.nbytes
        elif isinstance(p, torch.Tensor):
            binary = name in keys and p.ndim >= 2
            out["binary" if binary else "other"] += _nbytes(p)
        return p

    map_tree(leaf, params)
    return out
