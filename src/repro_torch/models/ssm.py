"""The Mamba-1 block of falcon-mamba-7b (port of the Mamba part of
`repro.models.ssm`): the causal depthwise conv, the block's params and
init, and the block over one prefill chunk or one decode step from
explicit state.

The recurrence runs through `kernels.selective_scan` (kernel 10) on
`path="auto"` -- the hand-written kernel on a CUDA tensor, its plain version
on a CPU one -- and through the plain version on any device on
`path="ref"`. A prefill chunk is one launch per block (the JAX package
loops `lax.scan` over its steps); a decode step is the same kernel at
T = 1 from the slot's state (the JAX step's `a * h + bx` and its einsum,
one launch).

in_proj, x_proj and out_proj route through `core.layers.qmatmul` (the
paper's technique, 1-bit `PackedWeight`s once frozen); dt_w, A_log, D and
the conv taps stay float, as in the JAX package.

The RG-LRU block of the recurrentgemma hybrid (port of the RG-LRU part of
`repro.models.ssm`) is a diagonal linear recurrence h_t = a_t h_{t-1} + b_t
over `lru_width` channels. Its w_x, w_gate and w_out route through
`qmatmul` (kernel 2 once frozen); its two gate products stay float32
matmuls (`w_input_gate`, `w_rec_gate` are not binary weights, as in the JAX
package; TF32 stays off, PyTorch's default) and its scan is plain PyTorch:
the JAX package computes both with jnp, outside any Pallas kernel.
`_seg_scan` runs JAX's `lax.associative_scan` recursion (pairwise combine,
recurse on the odd elements, fix up the even ones) op for op, so the
float32 operations and their order are the JAX package's, not a
sequential loop's.

Training (`draws` given: a `core.layers.Draws`, the masters' STE). The
Mamba block trains through the JAX package's sequential chunk scan
(`mamba_chunk_scan`, plain PyTorch under autograd, each chunk recomputed
in the backward), never through kernel 10, which has no backward and
refuses inputs that require a gradient. The RG-LRU block trains through
`_seg_scan`'s recursion under autograd; neither package has a backward
kernel for it. Over a mesh (placed masters, `core.placed.Placed`: the
train step, and the prefill and decode steps of `train.step`) the
projections run through `qmatmul`'s tensor-parallel parts; the
per-channel leaves (conv taps and bias, dt_w / dt_b, A_log, D, the RG-LRU
gates) are gathered whole for the data row (`_gathered`) and their
gradients go back to their pieces: the scan is not split over channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch._device import draw_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import Draws, QuantMode, qmatmul
from repro_torch.kernels.selective_scan import (
    selective_scan, selective_scan_plain,
)
from repro_torch.core.placed import whole
from repro_torch.models.common import rms_norm, site_qmm


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.dt_rank or max(1, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the Mamba temporal conv)
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, F); w: (K, F) depthwise taps; state: (B, K-1, F) history.
    Returns (y (B, L, F), new_state (B, K-1, F)). Taps are summed in order
    k = 0..K-1 in x's dtype, as the JAX package sums them."""
    k, n = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:n] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + n] * w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _conv_state_at(conv_state: torch.Tensor, x_pre: torch.Tensor,
                   n_valid: int, k: int) -> torch.Tensor:
    """Conv history as of the chunk's last REAL token: rows
    [n_valid, n_valid + K-1) of concat(state, x_pre), so pad rows beyond
    `n_valid` never enter the state."""
    xp = torch.cat([conv_state.to(x_pre.dtype), x_pre], dim=1)
    return xp[:, n_valid:n_valid + k - 1].to(conv_state.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def mamba_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.ssm_state
    return {
        "ln": {"scale": (d,)},
        "in_proj": (d, 2 * di),
        "conv_w": (cfg.d_conv, di),
        "conv_b": (di,),
        "x_proj": (di, dt_rank(cfg) + 2 * n),
        "dt_w": (dt_rank(cfg), di),
        "dt_b": (di,),
        "A_log": (di, n),
        "D": (di,),
        "out_proj": (di, d),
    }


def init_mamba_blocks(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                      device: torch.device) -> dict:
    """`n_layers` stacked blocks (leading axis L) by the JAX package's rules
    (`_mamba_init_block`): A_log = log(1..N) on every channel (S4D-real
    A = -(1..N)); dt_b so that softplus(dt_b) = dt with log dt uniform in
    [log 1e-3, log 1e-1]; D ones; other matrices N(0, 0.02^2); other
    vectors zeros. Draws come from `gen`, on its device."""
    def draw(name, shp):
        full = (n_layers,) + shp
        if name == "A_log":
            a = torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)
            return torch.log(a).expand(full).contiguous().to(device)
        if name == "dt_b":
            u = torch.rand(full, generator=gen,
                           device=draw_device(gen, device))
            u = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
            dt = torch.exp(u)
            return (dt + torch.log(-torch.expm1(-dt))).to(device)
        if name == "D":
            return torch.ones(full, dtype=torch.float32, device=device)
        if len(shp) >= 2:
            return (torch.randn(full, generator=gen,
                                device=draw_device(gen, device))
                    * 0.02).to(device)
        return torch.zeros(full, dtype=torch.float32, device=device)

    def init(shapes):
        return {name: init(shp) if isinstance(shp, dict) else draw(name, shp)
                for name, shp in shapes.items()}
    return init(mamba_block_shapes(cfg))


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
def scan(dt, xi, bmat, cmat, a_mat, h0, path: str):
    """The selective scan by `path`: 'auto' kernel 10 (its plain version on
    a CPU tensor), 'ref' the plain version on any device."""
    if path == "auto":
        return selective_scan(dt, xi, bmat, cmat, a_mat, h0)
    if path == "ref":
        return selective_scan_plain(dt, xi, bmat, cmat, a_mat, h0)
    raise ValueError(path)


def _ssm_inputs(bp: dict, xi: torch.Tensor, cfg: ModelConfig,
                mode: QuantMode, path: str, draws: Draws | None = None,
                site: str = ""):
    """From the conv output xi (B, L, di): dt (B, L, di) float32 and B, C
    (B, L, N) float32, contiguous (the kernel's operands), and A (di, N).
    `draws`: a `Draws` at train time (site "{site}x_proj")."""
    dtr, n = dt_rank(cfg), cfg.ssm_state
    dbc = site_qmm(xi, bp["x_proj"], mode, path=path, draws=draws,
                   site=f"{site}x_proj")
    dt_lr, bmat, cmat = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_lr.to(torch.float32),
                                 bp["dt_w"].to(torch.float32)) + bp["dt_b"])
    a_mat = -torch.exp(bp["A_log"].to(torch.float32))
    return (dt, bmat.to(torch.float32).contiguous(),
            cmat.to(torch.float32).contiguous(), a_mat.contiguous())


def _output(bp: dict, x: torch.Tensor, y: torch.Tensor, xi: torch.Tensor,
            z: torch.Tensor, mode: QuantMode, path: str,
            draws: Draws | None = None, site: str = "") -> torch.Tensor:
    y = (y + bp["D"] * xi.to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    return x + site_qmm(y, bp["out_proj"], mode, path=path, draws=draws,
                        site=f"{site}out_proj")


def mamba_block_chunk(bp: dict, x: torch.Tensor, conv_state: torch.Tensor,
                      h0: torch.Tensor, n_valid: int, cfg: ModelConfig,
                      mode: QuantMode, *, path: str = "auto"
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mamba block over one prefill chunk from explicit state.

    x: (1, C, D) right-padded chunk; conv_state: (1, K-1, di); h0: (1, di,
    N) float32; n_valid: host count of real tokens. Pads are masked out of
    the recurrence (dt -> 0 gives a = 1 and an input term of 0, so the state
    passes through them bit for bit) and out of the conv history, so
    chained chunks give the whole prompt's recurrence step for step.
    Returns (y (1, C, D), conv_state', h')."""
    c = x.shape[1]
    bp = _gathered(bp)
    xn = rms_norm(x, bp["ln"]["scale"])
    xz = qmatmul(xn, bp["in_proj"], mode, path=path)
    xi_pre, z = xz.chunk(2, dim=-1)
    xi, _ = causal_conv1d(xi_pre, bp["conv_w"], bp["conv_b"], conv_state)
    new_conv = _conv_state_at(conv_state, xi_pre, n_valid, cfg.d_conv)
    xi = F.silu(xi)
    dt, bmat, cmat, a_mat = _ssm_inputs(bp, xi, cfg, mode, path)
    live = torch.arange(c, device=x.device) < n_valid
    dt = dt * live[None, :, None]                  # pads: a = 1, input 0
    y, h_fin = scan(dt, xi.contiguous(), bmat, cmat, a_mat, h0, path)
    return _output(bp, x, y, xi, z, mode, path), new_conv, h_fin


def mamba_block_step(bp: dict, x: torch.Tensor, conv_state: torch.Tensor,
                     h: torch.Tensor, cfg: ModelConfig, mode: QuantMode, *,
                     path: str = "auto"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step. x: (B, 1, D); conv_state: (B, K-1, di); h: (B,
    di, N) float32. The recurrence is the scan at T = 1 from h. Returns
    (y (B, 1, D), new conv_state, new h)."""
    bp = _gathered(bp)
    xn = rms_norm(x, bp["ln"]["scale"])
    xz = qmatmul(xn, bp["in_proj"], mode, path=path)
    xi, z = xz.chunk(2, dim=-1)
    xi, conv_state = causal_conv1d(xi, bp["conv_w"], bp["conv_b"], conv_state)
    xi = F.silu(xi)
    dt, bmat, cmat, a_mat = _ssm_inputs(bp, xi, cfg, mode, path)
    y, h = scan(dt, xi.contiguous(), bmat, cmat, a_mat, h, path)
    return _output(bp, x, y, xi, z, mode, path), conv_state, h


def _scan_steps(a_mat, h, dt, xi, bmat, cmat):
    """The sequential time loop of one chunk (the JAX package's `step`):
    h = exp(dt A) h + (dt xi) B, y = sum_n h C. Returns (h, y (B, Q, D))."""
    ys = []
    for t in range(dt.shape[1]):
        a = torch.exp(dt[:, t, :, None] * a_mat)
        h = a * h + (dt[:, t] * xi[:, t].to(torch.float32))[..., None] \
            * bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))
    return h, torch.stack(ys, 1)


def mamba_chunk_scan(a_log: torch.Tensor, dt: torch.Tensor, xi: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                     h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training scan (the JAX package's `_mamba_chunk_scan`): chunks of
    min(chunk, L) steps, each a sequential loop whose per-step state is (B,
    D, N) only, recomputed in the backward (`torch.utils.checkpoint`); the
    state is carried across chunks. dt (B, L, D) float32; xi (B, L, D);
    bmat, cmat (B, L, N) float32. Returns (y (B, L, D), h_final (B, D, N))
    float32."""
    b, length, d = dt.shape
    q = min(chunk, length)
    a_mat = -torch.exp(a_log.to(torch.float32))
    h = h0 if h0 is not None else torch.zeros(
        (b, d, bmat.shape[-1]), dtype=torch.float32, device=dt.device)
    ys = []
    for lo in range(0, length, q):
        sl = slice(lo, lo + q)
        h, y = torch.utils.checkpoint.checkpoint(
            _scan_steps, a_mat, h, dt[:, sl], xi[:, sl], bmat[:, sl],
            cmat[:, sl], use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, 1), h


_PROJECTIONS = {"in_proj", "x_proj", "out_proj", "w_x", "w_gate", "w_out"}


def _gathered(bp: dict) -> dict:
    """bp with every leaf but the projections whole (`launch.shardings.
    whole`: a placed one gathered once for the block)."""
    return {k: v if k in _PROJECTIONS else whole(v) for k, v in bp.items()}


def mamba_block_train(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                      mode: QuantMode, draws: Draws, *, site: str = "",
                      chunk: int = 256, path: str = "auto") -> torch.Tensor:
    """The Mamba block over whole sequences x (B, L, D) at train time (the
    JAX package's `mamba_block(train=True)`): in_proj, x_proj and out_proj
    binarized with the STE (draws at "{site}in_proj" etc.), the scan
    `mamba_chunk_scan`."""
    bp = _gathered(bp)
    xn = rms_norm(x, bp["ln"]["scale"])
    xi, z = site_qmm(xn, bp["in_proj"], mode, path=path, draws=draws,
                     site=f"{site}in_proj").chunk(2, dim=-1)
    xi, _ = causal_conv1d(xi, bp["conv_w"], bp["conv_b"])
    xi = F.silu(xi)
    dt, bmat, cmat, _ = _ssm_inputs(bp, xi, cfg, mode, path, draws, site)
    y, _ = mamba_chunk_scan(bp["A_log"], dt, xi, bmat, cmat, chunk)
    return _output(bp, x, y, xi, z, mode, path, draws, site)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma-2b, Griffin)
# ---------------------------------------------------------------------------
RG_C = 8.0


def rglru_block_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of one RG-LRU sublayer. Init (the JAX package's
    `_init_from_shapes`): matrices, the conv taps included, N(0, 0.02^2);
    vectors (norm scale, conv bias, gate biases, lam) zeros."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "ln": {"scale": (d,)},
        "w_x": (d, w), "w_gate": (d, w),
        "conv_w": (cfg.d_conv, w), "conv_b": (w,),
        "w_input_gate": (w, w), "b_input_gate": (w,),
        "w_rec_gate": (w, w), "b_rec_gate": (w,),
        "lam": (w,),
        "w_out": (w, d),
    }


def _combine(x, y):
    """The scan's operator: (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of `_combine` along dim 1 in `jax.lax.
    associative_scan`'s order: combine adjacent pairs, scan those (the odd
    outputs), combine each with the next even input (the even outputs),
    interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                   (a[:, 1::2], b[:, 1::2])))
    pa, pb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    ea, eb = _combine((pa, pb), (a[:, 2::2], b[:, 2::2]))
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2] = torch.cat([a[:, :1], ea], dim=1)
    out_b[:, 0::2] = torch.cat([b[:, :1], eb], dim=1)
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def _seg_scan(a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """Cumulative h_t = a_t h_{t-1} + b_t within one chunk. a, b: (B, Q,
    ...); h0: (B, ...). Returns h: (B, Q, ...)."""
    a_cum, b_cum = _assoc_scan(a, b)
    return b_cum + a_cum * h0[:, None]


def chunked_diag_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal recurrence over time chunks of min(chunk, L) steps, the
    state carried across chunks (the JAX package's `chunked_diag_scan` with
    the identity output, the only one the hybrid uses). The last chunk is
    padded with a = 1, b = 0, which pass the state through exactly.
    a, b: (B, L, ...); h0: (B, ...). Returns (h (B, L, ...), h_final)."""
    length = a.shape[1]
    q = min(chunk, length)
    pad = (-length) % q
    if pad:
        tail = (a.shape[0], pad) + tuple(a.shape[2:])
        a = torch.cat([a, torch.ones(tail, dtype=a.dtype, device=a.device)], 1)
        b = torch.cat([b, torch.zeros(tail, dtype=b.dtype, device=b.device)],
                      1)
    h, ys = h0, []
    for lo in range(0, length + pad, q):
        hc = _seg_scan(a[:, lo:lo + q], b[:, lo:lo + q], h)
        ys.append(hc)
        h = hc[:, -1]
    return torch.cat(ys, dim=1)[:, :length], h


def _rglru_coeffs(bp: dict, xi: torch.Tensor):
    """xi: (B, L, W) conv output -> the recurrence's (a, b), both (B, L, W)
    float32. The gate products are float32 matmuls."""
    xf = xi.to(torch.float32)
    i_gate = torch.sigmoid(
        torch.matmul(xf, bp["w_input_gate"].to(torch.float32))
        + bp["b_input_gate"])
    r_gate = torch.sigmoid(
        torch.matmul(xf, bp["w_rec_gate"].to(torch.float32))
        + bp["b_rec_gate"])
    log_a = -RG_C * F.softplus(bp["lam"]) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i_gate * xf)
    return a, b


def _rglru_in(bp: dict, x: torch.Tensor, mode: QuantMode, path: str,
              draws: Draws | None = None, site: str = ""):
    """The normed input's two projections: (x-branch, gelu gate)."""
    def qmm(x, key):
        return site_qmm(x, bp[key], mode, path=path, draws=draws,
                        site=f"{site}{key}")
    xn = rms_norm(x, bp["ln"]["scale"])
    return qmm(xn, "w_x"), F.gelu(qmm(xn, "w_gate"), approximate="tanh")


def rglru_block_chunk(bp: dict, x: torch.Tensor, conv_state: torch.Tensor,
                      h0: torch.Tensor, n_valid: int, cfg: ModelConfig,
                      mode: QuantMode, *, chunk: int = 256,
                      path: str = "auto", draws: Draws | None = None,
                      site: str = ""
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RG-LRU sublayer over one prefill chunk from explicit state. x: (B, C,
    D), right-padded past n_valid (a host int); conv_state: (B, K-1, W);
    h0: (B, W) float32. Pads are masked out of the recurrence (a = 1, b = 0)
    and out of the conv history, so chained chunks give the whole prompt's
    recurrence. `draws`: a `Draws` at train time (sites "{site}w_x" etc.).
    Returns (y (B, C, D), conv_state', h')."""
    c = x.shape[1]
    bp = _gathered(bp)
    xi_pre, gate = _rglru_in(bp, x, mode, path, draws, site)
    xi, _ = causal_conv1d(xi_pre, bp["conv_w"], bp["conv_b"], conv_state)
    new_conv = _conv_state_at(conv_state, xi_pre, n_valid, cfg.d_conv)
    a, b = _rglru_coeffs(bp, xi)
    if n_valid < c:
        msk = (torch.arange(c, device=x.device) < n_valid)[None, :, None]
        a = torch.where(msk, a, 1.0)
        b = b * msk
    y, h_fin = chunked_diag_scan(a, b, h0, chunk)
    y = y.to(x.dtype) * gate
    out = site_qmm(y, bp["w_out"], mode, path=path, draws=draws,
                   site=f"{site}w_out")
    return x + out, new_conv, h_fin


def rglru_block(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                mode: QuantMode, *, chunk: int = 256, path: str = "auto",
                draws: Draws | None = None, site: str = ""
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """RG-LRU sublayer over whole sequences x (B, L, D) from zero state (the
    chunk block with every row real: its masks are then no-ops), at train
    time too (`draws`). Returns (y, (conv_state, h_final))."""
    w = cfg.lru_width or cfg.d_model
    bp = _gathered(bp)
    conv0 = torch.zeros((x.shape[0], cfg.d_conv - 1, w), dtype=x.dtype,
                        device=x.device)
    h0 = torch.zeros((x.shape[0], w), dtype=torch.float32, device=x.device)
    y, conv, h = rglru_block_chunk(bp, x, conv0, h0, x.shape[1], cfg, mode,
                                   chunk=chunk, path=path, draws=draws,
                                   site=site)
    return y, (conv, h)


def rglru_block_step(bp: dict, x: torch.Tensor, conv_state: torch.Tensor,
                     h: torch.Tensor, cfg: ModelConfig, mode: QuantMode, *,
                     path: str = "auto"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step. x: (B, 1, D); conv_state: (B, K-1, W); h: (B, W)
    float32. Returns (y (B, 1, D), new conv_state, new h)."""
    bp = _gathered(bp)
    xi, gate = _rglru_in(bp, x, mode, path)
    xi, conv_state = causal_conv1d(xi, bp["conv_w"], bp["conv_b"], conv_state)
    a, b = _rglru_coeffs(bp, xi)
    h = a[:, 0] * h + b[:, 0]
    y = h[:, None].to(x.dtype) * gate
    return x + qmatmul(y, bp["w_out"], mode, path=path), conv_state, h
