"""Selective scan (the Mamba-1 recurrence): the hand-written Hopper kernel,
its plain PyTorch version, and the wrapper (port of
`repro.kernels.selective_scan`).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xi_t) * B_t
    y_t = sum_n h_t[:, n] * C_t[n]

`selective_scan(dt, xi, bmat, cmat, a_mat, h0=None)` returns y (B, T, D) and
h_final (B, D, N), float32 (semantics: `ref.selective_scan_ref`, one fixed
order of operations, which the kernel follows bit for bit). Replaces the
TPU kernel `selective_scan` (src/repro/kernels/selective_scan.py:64) and
takes an initial state `h0` besides, as the JAX package's
`models.ssm._mamba_chunk_scan` does. On CUDA tensors it launches the kernel
of `csrc/selective_scan.cu`, or raises (N above 16 included); it runs the
plain version only because its inputs lie on the CPU.
`launches["selective_scan"]` counts kernel launches. `scan_cost` is the
kernel's own work (bytes moved, float ops and exps), which the card's
roofline and the dry run (`roofline.count`, where a meta tensor stands for
the card's) both read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = {"selective_scan": 0}
_XI_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 16          # states per channel the kernel holds in registers


def reset_launches() -> None:
    launches["selective_scan"] = 0


def scan_cost(b: int, t: int, d: int, n: int, h0: bool,
              xi_bytes: int) -> dict:
    """The work of one scan of (B, T, D) steps of N states: `bytes` it must
    move (dt, xi, B, C, A and h0 read once, y and h_final written once),
    `exps` (one per state and step) and `flops`, the other float ops per
    state and step (dt A, a h, the input term's multiply-add, y's
    multiply-add: 5)."""
    nbytes = b * t * d * (4 + xi_bytes + 4) + 2 * b * t * n * 4 + d * n * 4 \
        + (2 if h0 else 1) * b * d * n * 4
    return {"bytes": nbytes, "exps": b * t * d * n, "flops": 5 * b * t * d * n}


def selective_scan_plain(dt, xi, bmat, cmat, a_mat, h0=None):
    """The kernel's arithmetic in plain PyTorch (`ref.selective_scan_ref`)."""
    return ref.selective_scan_ref(dt, xi, bmat, cmat, a_mat, h0)


def check_operands(dt: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a_mat: torch.Tensor,
                   h0: torch.Tensor | None) -> None:
    """Raise unless dt (B, T, D) float32, xi (B, T, D) float32 | bf16, B/C
    (B, T, N) float32, A (D, N) float32 and h0 (B, D, N) float32 (or None)
    agree, lie on one device and are contiguous."""
    if dt.dtype != torch.float32 or dt.ndim != 3:
        raise TypeError(f"dt must be (B, T, D) float32, got {dt.dtype} "
                        f"{tuple(dt.shape)}")
    b, t, d = dt.shape
    if xi.dtype not in _XI_BF16 or tuple(xi.shape) != (b, t, d):
        raise TypeError(f"xi must be {(b, t, d)} float32 or bfloat16, got "
                        f"{xi.dtype} {tuple(xi.shape)}")
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    want = {"B": (bmat, (b, t, n)), "C": (cmat, (b, t, n)),
            "A": (a_mat, (d, n))}
    if h0 is not None:
        want["h0"] = (h0, (b, d, n))
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {x.dtype} "
                             f"{tuple(x.shape)}")
    tensors = [dt, xi, bmat, cmat, a_mat] + ([] if h0 is None else [h0])
    for x in tensors[1:]:
        if x.device != dt.device:
            raise ValueError(f"operands on {dt.device} and {x.device}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")


def selective_scan(dt: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a_mat: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba selective scan from state h0 (zeros when None).

    dt: (B, T, D) float32 step sizes; xi: (B, T, D) float32 | bf16 conv'd
    inputs; bmat, cmat: (B, T, N) float32; a_mat: (D, N) float32 (negative
    real A); h0: (B, D, N) float32 or None. A step with dt = 0 leaves the
    state as it was, bit for bit. Returns (y (B, T, D), h_final (B, D, N)),
    float32. The kernel takes 1 <= N <= 16. It has no backward: inputs
    that require a gradient raise (the train path takes
    `models.ssm.mamba_chunk_scan`)."""
    check_operands(dt, xi, bmat, cmat, a_mat, h0)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (dt, xi, bmat, cmat, a_mat, h0)):
        raise RuntimeError("selective_scan has no backward: an input "
                           "requires a gradient (train through "
                           "models.ssm.mamba_chunk_scan)")
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, xi, bmat, cmat, a_mat, h0)
    b, t, d = dt.shape
    n = bmat.shape[-1]
    if dt.device.type != "cuda":
        from repro_torch.roofline.count import counting, kernel_call
        if counting(dt.device):
            # the dry run's fake card: the kernel's own work, counted
            cost = scan_cost(b, t, d, n, h0 is not None, xi.element_size())
            return tuple(kernel_call(
                "selective_scan", dt.device, flops=cost["flops"],
                nbytes=cost["bytes"], outputs=[((b, t, d), torch.float32),
                                               ((b, d, n), torch.float32)]))
        raise ValueError(f"no selective-scan kernel for device {dt.device}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the selective-scan kernel holds 1..{MAX_N} states "
                         f"per channel, got N={n}")
    y = torch.empty((b, t, d), dtype=torch.float32, device=dt.device)
    h_out = torch.empty((b, d, n), dtype=torch.float32, device=dt.device)
    if b and d:
        fn = _build.library("selective_scan").selective_scan
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        _build.check("selective_scan", fn(
            dt.data_ptr(), xi.data_ptr(), _XI_BF16[xi.dtype],
            bmat.data_ptr(), cmat.data_ptr(), a_mat.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), b, t, d, n, stream), "selective_scan")
        _build.count(launches, "selective_scan")
    return y, h_out
