"""Shared model components: RMSNorm, LayerNorm, RoPE, sinusoidal positions,
the dense FFNs and the MoE sublayer (port of `repro.models.common`).

Projections route through `core.layers.qmatmul`, so the paper's
quantization is a config switch. `path` ('auto' | 'ref') picks the kernels
or their plain versions for frozen weights, as in `kernels.ops`.

Training (a `core.layers.Draws` passed as `draws`, fp32 masters): every
projection binarizes with the STE (`qmatmul(train=True)`), stochastically
where the draws hand out noise, by site: "{site}.{weight key}" (`.qact`
for the input, `.w` for the weight).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.layers import (
    Draws, QuantMode, packed_qmatmul, packed_qmatmul_fused, qmatmul,
    shared_pack,
)
from repro_torch.core.packed import PackedWeight


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype. The callers pass the
    gain as 1 + scale, as the JAX package's do."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


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


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """MusicGen-style sinusoidal position embedding, float32 (S, d) for
    positions (S,), sin then cos halves, as the JAX package computes it."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def site_qmm(x: torch.Tensor, w, mode: QuantMode, *, path: str = "auto",
             draws: Draws | None = None, site: str = "",
             per_row: bool = True) -> torch.Tensor:
    """qmatmul at inference (draws None), or at train time with the draws
    of site `site` (x's leading axis the batch's rows unless `per_row` is
    False)."""
    if draws is None:
        return qmatmul(x, w, mode, path=path)
    return qmatmul(x, w, mode, train=True, path=path,
                   noise=draws.qmatmul(site, x, w, mode, per_row))


def ffn(params: dict, x: torch.Tensor, kind: str, mode: QuantMode, *,
        path: str = "auto", draws: Draws | None = None,
        site: str = "ffn") -> torch.Tensor:
    """kind 'swiglu' | 'geglu' (params {w_gate (D,F), w_up (D,F), w_down
    (F,D)}) or 'sq_relu' | 'gelu' (params {w_up, w_down}).

    Frozen weights: the GLU kinds sign-pack x once for both gate and up
    projections. A frozen sq_relu FFN whose w_up carries the 'act:sq_relu'
    fold (`core.packed.attach_ffn_act_thresholds`) runs bit-resident: the
    up-projection's fused epilogue (kernel 3) emits the hidden bits, which
    the down-projection reads as packed words (kernel 1). The fold is the
    constant +1 bit that binarize(relu(z)^2) gives unfused, so the block's
    output does not depend on x; the JAX package keeps the live chain and
    so does the port. gelu's sign is not a threshold of the integer dot
    (tanh-gelu saturates to -0.0), so it stays unfused."""
    w_up = params["w_up"]
    if (kind == "sq_relu" and isinstance(w_up, PackedWeight)
            and w_up.fold == "act:sq_relu"
            and mode in (QuantMode.BBP, QuantMode.BBP_DET)):
        h = packed_qmatmul_fused(x, w_up, mode, path=path)
        return packed_qmatmul(h, params["w_down"], mode, path=path)

    def qmm(x, key):
        return site_qmm(x, params[key], mode, path=path, draws=draws,
                        site=f"{site}.{key}")
    if kind in ("swiglu", "geglu"):
        xs = shared_pack(x, (params["w_gate"], w_up), mode, path=path)
        g, u = qmm(xs, "w_gate"), qmm(xs, "w_up")
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    elif kind == "sq_relu":
        h = torch.relu(qmm(x, "w_up")).square()
    elif kind == "gelu":
        h = F.gelu(qmm(x, "w_up"), approximate="tanh")
    else:
        raise ValueError(kind)
    return qmm(h, "w_down")


def ffn_param_shapes(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}


# ---------------------------------------------------------------------------
# MoE sublayer (capacity-based scatter dispatch, "dropping")
# ---------------------------------------------------------------------------
def top_k_lower_index(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, equal values
    in ascending index order, as `jax.lax.top_k` gives them (`torch.topk`
    promises no order among ties): the first k of a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(router_w: torch.Tensor, xt: torch.Tensor, top_k: int,
              capacity_factor: float) -> dict:
    """The dispatch of T rows xt (T, D) over E experts, as the JAX package
    computes it: router logits in float32, softmax, top-k (ties to the
    lower expert), gates renormalised over the k; capacity C = max(1,
    floor(T k cf / E)) shared by all T rows of the call; each route's
    position in its expert's buffer counted over the routes flattened
    token-major, k-minor; routes at position >= C are dropped. Returns
    probs (T, E), gate_vals / gate_idx (T, k), expert, pos, keep (T k,),
    cap, frac_tokens (E,), the share of rows whose first choice is each
    expert, and drop_frac, the share of routes dropped."""
    t = xt.shape[0]
    e = router_w.shape[-1]
    cap = int(max(1, (t * top_k * capacity_factor) // e))
    logits = torch.matmul(xt.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    expert = gate_idx.reshape(t * top_k)
    onehot = F.one_hot(expert, e).to(torch.int32)            # (T k, E)
    pos = (onehot.cumsum(dim=0) * onehot - 1).amax(dim=-1)   # (T k,)
    keep = pos < cap
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "expert": expert, "pos": pos, "keep": keep, "cap": cap,
            "frac_tokens": F.one_hot(gate_idx[:, 0], e).to(torch.float32)
            .mean(dim=0),
            "drop_frac": 1.0 - keep.to(torch.float32).mean()}


def shard_route(router_w: torch.Tensor, xt: torch.Tensor, top_k: int,
                whole: dict, t0: int) -> dict:
    """`moe_route`'s dict for tokens [t0, t0 + T) of a batch whose whole
    route is `whole` (the routes of a `core.layers.BatchShard`): the
    experts, positions, keep mask and capacity, the share of tokens per
    expert and of dropped routes are the whole batch's; probs are these
    rows' own (the router's gradient flows through them) and the gates
    their probs at the whole route's experts, renormalised over the k."""
    t = xt.shape[0]
    logits = torch.matmul(xt.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    dev = xt.device
    gate_idx = whole["gate_idx"][t0:t0 + t].to(dev)
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    routes = slice(t0 * top_k, (t0 + t) * top_k)
    return dict({k: whole[k].to(dev) for k in ("frac_tokens", "drop_frac")},
                probs=probs, gate_vals=gate_vals, gate_idx=gate_idx,
                cap=whole["cap"],
                **{k: whole[k][routes].to(dev)
                   for k in ("expert", "pos", "keep")})


def moe_ffn(params: dict, x: torch.Tensor, kind: str, mode: QuantMode, *,
            top_k: int, capacity_factor: float = 1.25,
            path: str = "auto", draws: Draws | None = None,
            site: str = "ffn") -> tuple[torch.Tensor, dict]:
    """params: {router (D, E), experts: {w_* with a leading E axis}}; x:
    (B, S, D). Returns (out (B, S, D), aux {lb_loss, drop_frac}).

    Every row of the call competes for the batch-global capacity
    (`moe_route`): a decode step's inactive rows and a padded chunk's pad
    rows count, as in the JAX package. Kept routes are scattered into an
    (E, C, D) buffer (dropped routes add 0 at slot 0), each expert's FFN
    runs on its C rows (the GLU kinds, or relu(.)^2 for every other kind,
    as there), and each row sums its kept routes' outputs weighted by their
    gates in x's dtype. Frozen binary experts: the buffer is sign-packed
    once for gate and up (kernel 5), each projection is one batched launch
    of kernel 1 over the experts, and the hidden is packed again for the
    down-projection (`_batched_qmm`). Training: lb_loss is differentiable
    through the router's probabilities, the outputs through the gates; the
    routes' copies of a row are an expand (whose backward is a sum, with
    no atomics).

    One shard of the data-parallel step (`draws.shard`, a
    `core.layers.BatchShard`) routes by the global batch's routes
    (`shard_route`): its buffer has the global capacity and holds its own
    kept routes at their global positions, so each expert's FFN runs at
    the global shape and draws; its lb_loss is E sum(frac_tokens x its
    rows' mean probs), which the step weighs by the shard's share of
    rows."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    shard = None if draws is None else draws.shard
    if shard is not None and not shard.record:
        r = shard_route(params["router"], xt, top_k, shard.routes[site],
                        shard.lo * s)
    else:
        r = moe_route(params["router"], xt, top_k, capacity_factor)
        if shard is not None:
            shard.routes[site] = {k: v.detach() if torch.is_tensor(v) else v
                                  for k, v in r.items()}
    e, cap, keep = params["router"].shape[-1], r["cap"], r["keep"]
    expert, pos_c = r["expert"], torch.where(keep, r["pos"], 0)

    src = xt[:, None].expand(t, top_k, d).reshape(t * top_k, d)   # (T k, D)
    src = torch.where(keep[:, None], src, torch.zeros_like(src))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((expert, pos_c), src, accumulate=True)

    ex = params["experts"]

    def qmm(x, key):
        return _batched_qmm(x, ex[key], mode, path, draws,
                            f"{site}.experts.{key}")
    if kind in ("swiglu", "geglu"):
        bs = shared_pack(buf, (ex["w_gate"], ex["w_up"]), mode, path=path)
        g, u = qmm(bs, "w_gate"), qmm(bs, "w_up")
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = torch.relu(qmm(buf, "w_up")).square()
    out_buf = qmm(h, "w_down")                               # (E, C, D)

    gathered = out_buf[expert, pos_c]                        # (T k, D)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    combined = (gathered.reshape(t, top_k, d)
                * r["gate_vals"][..., None].to(x.dtype)).sum(dim=1)

    # Switch-style load-balance loss and the share of routes dropped
    aux = {"lb_loss": e * (r["frac_tokens"] * r["probs"].mean(dim=0)).sum(),
           "drop_frac": r["drop_frac"]}
    return combined.reshape(b, s, d), aux


def _batched_qmm(x, w, mode: QuantMode, path: str,
                 draws: Draws | None = None, site: str = "") -> torch.Tensor:
    """Per-expert quantized matmul: x (E, C, Din) (or, for frozen binary
    experts, a PackedActivation of it), w (E, Din, Dout) masters or a
    PackedWeight of (E, Dout, KW) words -> (E, C, Dout) in x's dtype.

    Frozen BBP / BBP_DET: the popcount dots of sign(x) against the packed
    words (`ops.packed_matmul_experts`), cast to the activation dtype as
    the JAX package casts them (bf16 rounds dots above 256). Frozen BC: the
    unpacked +-1 weights in a float batched matmul. Masters: the mode's
    quantized activations and weights in a batched matmul (`qmatmul`, the
    STE at train time)."""
    if isinstance(w, PackedWeight):
        if mode in (QuantMode.BBP, QuantMode.BBP_DET):
            from repro_torch.kernels.ops import packed_matmul_experts
            return packed_matmul_experts(x, w, path=path).to(x.dtype)
        if mode == QuantMode.BC:
            return torch.matmul(x, w.unpack(x.dtype))
        raise ValueError("packed experts require a binary quant mode")
    return site_qmm(x, w, mode, path=path, draws=draws, site=site,
                    per_row=False)


def moe_param_shapes(d_model: int, d_ff: int, n_experts: int,
                     kind: str) -> dict:
    ex = {k: (n_experts,) + v
          for k, v in ffn_param_shapes(d_model, d_ff, kind).items()}
    return {"router": (d_model, n_experts), "experts": ex}
