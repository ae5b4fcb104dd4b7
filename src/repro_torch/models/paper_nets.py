"""The paper's experiment networks (§5) at inference (port of
`repro.models.paper_nets`).

  * MNIST MLP: 3 binary hidden layers x 1024, L2-SVM output, no batch norm
    (a fixed AP2 shift of 1/sqrt(fan_in) instead), uniform(-1,1) init.
  * CIFAR-10 / SVHN CNN: 2x(128C3)-MP2-2x(256C3)-MP2-2x(512C3)-MP2-
    1024FC-1024FC-L2SVM with (shift-)BN.

Both forwards take fp32 masters or frozen trees (`freeze_mlp`/`freeze_cnn`).
Frozen, they run bit-resident: the binary layers are XNOR+popcount GEMMs
whose activations stay packed between layers, through the Hopper kernels
on CUDA tensors. Params and BN running stats are separate trees, as in the
JAX package; layouts are NHWC images, (K, N) dense and HWIO conv weights.

`kernel_path` picks the realization of the frozen binary GEMMs ('auto':
the kernels, or their plain versions on the CPU; 'ref': the plain oracles
on any device). `hidden`, when a list, collects the PackedActivations the
bit-resident chain passes between layers.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.ap2 import ap2
from repro_torch.core.binarize import binarize, binary_act
from repro_torch.core.layers import (
    QuantMode, packed_qmatmul, packed_qmatmul_fused, qmatmul,
)
from repro_torch.core.packed import (
    PackedActivation, PackedWeight, fold_bias_sign_threshold,
    fold_bn_sign_threshold, freeze_params,
)
from repro_torch.core.shift_bn import batch_norm, init_bn, shift_batch_norm
from repro_torch.kernels.ops import binary_conv2d, im2col

_MODES = {"bbp": QuantMode.BBP, "bc": QuantMode.BC, "float": QuantMode.NONE}


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uniform(-1, 1) drawn on the CPU from `gen`, then moved: the same seed
    gives the same weights on every device."""
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1
            ).to(device)


def _fan_in_shift(fan_in: int) -> float:
    """AP2(1/sqrt(fan_in)), computed in float32 as the JAX package computes
    it, on the CPU: an exact power of two, so multiplying a float32 tensor
    by it as a Python float gives the same bits and no host-device copy."""
    f = torch.tensor(float(fan_in), dtype=torch.float32)
    return float(ap2(1.0 / torch.sqrt(f)))


# ---------------------------------------------------------------------------
# MNIST MLP (permutation-invariant)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, in_dim: int = 784, hidden: int = 1024,
             n_hidden: int = 3, n_classes: int = 10, *, device=None) -> dict:
    """Paper init: uniform(-1, 1) for weights and biases."""
    dev = resolve_device(device)
    dims = [in_dim] + [hidden] * n_hidden + [n_classes]
    return {"layers": [{"w": _uniform(gen, (din, dout), dev),
                        "b": _uniform(gen, (dout,), dev)}
                       for din, dout in zip(dims[:-1], dims[1:])]}


def freeze_mlp(params: dict) -> dict:
    """Freeze the paper MLP for bit-resident serving: weights pack to the
    wire format and each hidden layer 1..n-2 folds its epilogue
    ((dot + b) * AP2-shift, then sign) into the threshold dot >= ceil(-b).
    The input layer (real-valued pixels) and the L2-SVM output stay dense.
    """
    frozen = freeze_params(params)
    layers = frozen["layers"]
    for i in range(1, len(layers) - 1):
        t, f = fold_bias_sign_threshold(params["layers"][i]["b"])
        layers[i]["w"] = layers[i]["w"].with_threshold(t, f, "bias")
    return frozen


def _mlp_bit_resident_ok(params: dict) -> bool:
    layers = params["layers"]
    return (all(isinstance(lp["w"], PackedWeight) for lp in layers)
            and all(lp["w"].fold == "bias" for lp in layers[1:-1]))


def _mlp_forward_bit_resident(params: dict, x: torch.Tensor, path: str,
                              hidden: list | None) -> torch.Tensor:
    """Frozen BBP inference: bits flow between hidden layers, never floats.
    Bit-exact with the master path: hidden bit_i = ((dot + b) * s >= 0) with
    s an exact positive power of two, i.e. (dot >= ceil(-b))."""
    layers = params["layers"]
    l0 = layers[0]
    # input layer: real-valued pixels at full precision, the one dense GEMM
    h: torch.Tensor | PackedActivation = \
        torch.matmul(x, l0["w"].unpack(x.dtype)) + l0["b"]
    h = h * _fan_in_shift(l0["w"].shape[0])
    for lp in layers[1:-1]:
        # the first fused step packs the float entry inside the kernel; the
        # next ones consume the previous step's PackedActivation
        h = packed_qmatmul_fused(h, lp["w"], QuantMode.BBP, path=path)
        if hidden is not None:
            hidden.append(h)
    ll = layers[-1]
    scores = packed_qmatmul(h, ll["w"], QuantMode.BBP, path=path) + ll["b"]
    return scores * _fan_in_shift(ll["w"].shape[0])


def mlp_forward(params: dict, x: torch.Tensor, *, mode: str = "bbp",
                kernel_path: str = "auto",
                hidden: list | None = None) -> torch.Tensor:
    """x: (B, 784) in [-1, 1]. Returns L2-SVM scores (B, 10).

    mode: 'bbp' (paper), 'bc' (BinaryConnect baseline), 'float'."""
    qm = _MODES[mode]
    if qm == QuantMode.BBP and _mlp_bit_resident_ok(params):
        return _mlp_forward_bit_resident(params, x, kernel_path, hidden)
    n = len(params["layers"])
    h = x
    for i, lp in enumerate(params["layers"]):
        # the input layer consumes real-valued pixels (the paper binarizes
        # hidden neurons only)
        qm_i = QuantMode.BC if (qm == QuantMode.BBP and i == 0) else qm
        pre = qmatmul(h, lp["w"], qm_i, path=kernel_path) + lp["b"]
        if qm != QuantMode.NONE:
            # fixed shift normalization: AP2 proxy of 1/sqrt(fan_in)
            pre = pre * _fan_in_shift(lp["w"].shape[0])
        if i < n - 1:
            h = binary_act(pre) if mode == "bbp" else pre.clamp(-1.0, 1.0)
        else:
            h = pre  # L2-SVM scores
    return h


# ---------------------------------------------------------------------------
# CIFAR-10 / SVHN CNN
# ---------------------------------------------------------------------------
CNN_WIDTHS = (128, 128, 256, 256, 512, 512)


def init_cnn(gen: torch.Generator, in_ch: int = 3, widths=CNN_WIDTHS,
             fc: int = 1024, n_classes: int = 10, img: int = 32, *,
             device=None) -> tuple[dict, dict]:
    """Returns (params, bn_state): learnables vs running statistics."""
    dev = resolve_device(device)
    convs, conv_bns = [], []
    ch = in_ch
    for w in widths:
        bnp, bns = init_bn(w, device=dev)
        convs.append({"w": _uniform(gen, (3, 3, ch, w), dev), "bn": bnp})
        conv_bns.append(bns)
        ch = w
    flat = (img // 8) * (img // 8) * widths[-1]
    p1, s1 = init_bn(fc, device=dev)
    p2, s2 = init_bn(fc, device=dev)
    params = {
        "convs": convs,
        "fc1": {"w": _uniform(gen, (flat, fc), dev), "bn": p1},
        "fc2": {"w": _uniform(gen, (fc, fc), dev), "bn": p2},
        "out": {"w": _uniform(gen, (fc, n_classes), dev),
                "b": torch.zeros(n_classes, dtype=torch.float32, device=dev)},
    }
    bn_state = {"convs": conv_bns, "fc1": s1, "fc2": s2}
    return params, bn_state


def freeze_cnn(params: dict, bn_state: dict, *, bn_kind: str = "shift",
               eps: float = 1e-4) -> dict:
    """Freeze the paper CNN for bit-resident serving of its FC tail.

    Conv/FC weights pack to the wire format; fc1/fc2 also fold their
    inference epilogue ((shift-)BN from `bn_state` + clip + sign) into
    per-channel thresholds riding on the PackedWeight. cnn_forward itself
    re-folds from the bn params/state it is passed.
    """
    if bn_kind not in ("shift", "exact"):
        raise ValueError(bn_kind)
    frozen = freeze_params(params)
    for name in ("fc1", "fc2"):
        bnp, bns = params[name]["bn"], bn_state[name]
        t, f = fold_bn_sign_threshold(bnp.gamma, bnp.beta, bns.mean, bns.var,
                                      kind=bn_kind, eps=eps)
        frozen[name]["w"] = frozen[name]["w"].with_threshold(
            t, f, f"{bn_kind}-bn")
    return frozen


def _conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float conv, NHWC x HWIO -> NHWC, SAME padding, stride 1, as im2col and
    one float32 matmul. Not cuDNN: its heuristics may pick a Winograd or FFT
    algorithm, which round where a GEMM's sums of 8-bit pixels against +-1
    weights are exact in any order."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    wmat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return torch.matmul(im2col(x, kh, kw), wmat).reshape(b, h, wd, cout)


def _max_pool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID, on NHWC."""
    b, hh, ww, c = h.shape
    h = h[:, :hh // 2 * 2, :ww // 2 * 2]
    return h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def cnn_forward(params: dict, bn_state: dict, x: torch.Tensor, *,
                mode: str = "bbp", bn_kind: str = "shift",
                kernel_path: str = "auto", hidden: list | None = None
                ) -> tuple[torch.Tensor, dict]:
    """x: (B, 32, 32, 3) NHWC. Returns (scores (B, 10), bn_state).

    bn_kind: 'shift' (paper's shift-BN) or 'exact'. Running statistics are
    only read at inference, so bn_state comes back unchanged.
    """
    qm = _MODES[mode]
    bn_fn = shift_batch_norm if bn_kind == "shift" else batch_norm
    new_bn: dict[str, Any] = {"convs": []}
    h = x
    for i, cp in enumerate(params["convs"]):
        frozen = isinstance(cp["w"], PackedWeight)
        if frozen and qm == QuantMode.NONE:
            raise ValueError("frozen packed conv weights serve binary "
                             "inference only; keep fp32 masters otherwise")
        if qm == QuantMode.NONE:
            hq, wq = h, cp["w"]
        else:
            wq = cp["w"] if frozen else binarize(cp["w"])
            hq = binary_act(h) if (qm == QuantMode.BBP and i > 0) else h
        if qm == QuantMode.BBP and i > 0:
            # fully binary conv: im2col + the packed GEMM when frozen
            pre = binary_conv2d(hq, wq, path=kernel_path)
        else:
            wmat = wq.unpack(hq.dtype) if frozen else wq.to(hq.dtype)
            pre = _conv_same(hq, wmat)
        pre, bns_new = bn_fn(cp["bn"], bn_state["convs"][i], pre)
        new_bn["convs"].append(bns_new)
        h = pre.clamp(-1.0, 1.0)
        if i % 2 == 1:  # max-pool after every second conv
            h = _max_pool2(h)

    h = h.reshape(h.shape[0], -1)

    fc1w, fc2w, outw = params["fc1"]["w"], params["fc2"]["w"], params["out"]["w"]
    if (qm == QuantMode.BBP and isinstance(outw, PackedWeight)
            and isinstance(fc1w, PackedWeight)
            and isinstance(fc2w, PackedWeight)):
        # bit-resident FC tail: fc1 signs the conv features in the kernel
        # and emits the packed bits of sign(clip(BN(dot))); fc2 reads and
        # emits packed words; only the L2-SVM scores come back dense. The
        # thresholds are folded here from the bn params/state and bn_kind of
        # this call, so recalibrated statistics are honored exactly.
        hb: torch.Tensor | PackedActivation = h
        for name, pw in (("fc1", fc1w), ("fc2", fc2w)):
            t, f = fold_bn_sign_threshold(
                params[name]["bn"].gamma, params[name]["bn"].beta,
                bn_state[name].mean, bn_state[name].var, kind=bn_kind)
            hb = packed_qmatmul_fused(hb, pw, qm, thresh=t, flip=f,
                                      path=kernel_path)
            if hidden is not None:
                hidden.append(hb)
            new_bn[name] = bn_state[name]
        scores = packed_qmatmul(hb, outw, qm, path=kernel_path) \
            + params["out"]["b"]
        return scores, new_bn

    for name in ("fc1", "fc2"):
        lp = params[name]
        if qm == QuantMode.BBP:
            h = binary_act(h)
        pre = qmatmul(h, lp["w"], qm, path=kernel_path)
        pre, bns_new = bn_fn(lp["bn"], bn_state[name], pre)
        new_bn[name] = bns_new
        h = pre.clamp(-1.0, 1.0)

    scores = qmatmul(h, params["out"]["w"], qm, path=kernel_path) \
        + params["out"]["b"]
    return scores, new_bn


# ---------------------------------------------------------------------------
# L2-SVM square hinge loss (paper §5)
# ---------------------------------------------------------------------------
def square_hinge_loss(scores: torch.Tensor, labels: torch.Tensor,
                      n_classes: int = 10) -> torch.Tensor:
    """L2-SVM multi-class square hinge: targets in {-1,+1} one-vs-all."""
    t = 2.0 * F.one_hot(labels.long(), n_classes).to(torch.float32) - 1.0
    margins = torch.clamp(1.0 - t * scores.to(torch.float32), min=0.0)
    return torch.mean(torch.sum(margins * margins, dim=-1))

