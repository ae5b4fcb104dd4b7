"""Decoder-only transformer, dense family, served from a bit-resident KV
cache (port of the dense serving path of `repro.models.transformer`).

Params are the JAX package's tree: dicts of tensors, the blocks' leaves
stacked along a leading L axis (frozen weights are `PackedWeight`s whose
words carry that axis too), so trees carry across with `convert`. The loop
over layers is a Python loop over views of the stacked leaves.

The cache is bit-resident (`kv_bits=1`): K/V are sign bitplanes packed
along head_dim, (L, B, T, Hkv, ceil(hd/32)) int32 words, plus a float32 V
scale per (layer, row, KV head). Unlike the JAX package, which returns a new
cache, the port updates the cache tensors in place and returns the same
dict: a full-width cache is written one row at a time, never copied.

`path` ('auto' | 'ref') picks, for every kernel on the path (sign-pack,
binary GEMMs, packed attention), the hand-written kernel (which one the
device decides: a CPU tensor runs the plain version) or the plain PyTorch
version on any device. It is the caller's explicit choice; nothing falls
back on its own.

Not ported yet (ROADMAP Queue A): the float KV cache and whole-prompt
`transformer_prefill` (float flash attention), the paged layout, the VLM,
MoE and audio families, training.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitpack import packed_width
from repro_torch.core.layers import QuantMode, qmatmul, shared_pack
from repro_torch.core.packed import PackedActivation, PackedWeight, map_tree
from repro_torch.kernels.decode_attention import decode_attention_packed_plain
from repro_torch.kernels.prefill_attention import (
    prefill_attention_packed_plain,
)
from repro_torch.models.attention import (
    decode_attention_packed, prefill_attention_packed,
)
from repro_torch.models.common import ffn, ffn_param_shapes, rms_norm, rope


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} family is not ported yet "
                                  "(ROADMAP Queue A)")
    if cfg.norm != "rmsnorm" or cfg.pos != "rope" or cfg.qkv_bias:
        raise NotImplementedError("the port serves rmsnorm + rope without "
                                  "qkv bias (ROADMAP Queue A)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _block_shapes(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"ln1": {"scale": (d,)}, "ln2": {"scale": (d,)},
            "attn": {"wq": (d, h * hd), "wk": (d, kv * hd),
                     "wv": (d, kv * hd), "wo": (h * hd, d)},
            "ffn": ffn_param_shapes(d, cfg.d_ff, cfg.mlp)}


def init_transformer_params(gen: torch.Generator, cfg: ModelConfig, *,
                            device=None, freeze_layer=None) -> dict:
    """fp32 masters with the JAX package's shapes and scales: weight
    matrices N(0, 0.02^2), norm scales 0. Draws come from `gen`, on its
    device (a CPU generator gives the same weights on every device; a CUDA
    one draws a full-width model on the card in seconds).

    `freeze_layer`, when given, maps one layer's blocks (leaves with a
    leading axis of 1) to their frozen tree, and each layer is drawn and
    frozen before the next is drawn: only one layer's fp32 masters are
    ever resident (all 40 of phi3-medium-14b's are 54.5 GB). The weights
    follow the same distribution as freezing the whole tree, not the same
    draws."""
    _check_served(cfg)
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * 0.02).to(dev)

    def init(shapes, n_layers):
        if isinstance(shapes, dict):
            return {k: init(v, n_layers) for k, v in shapes.items()}
        full = (n_layers,) + shapes
        return normal(full) if len(shapes) >= 2 else \
            torch.zeros(full, dtype=torch.float32, device=dev)

    params = {"embed": normal((cfg.vocab, cfg.d_model)),
              "final_norm": {"scale": torch.zeros(cfg.d_model, device=dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab))
    if freeze_layer is None:
        params["blocks"] = init(_block_shapes(cfg), cfg.n_layers)
    else:
        params["blocks"] = _stack_layers(
            [freeze_layer(init(_block_shapes(cfg), 1))
             for _ in range(cfg.n_layers)])
    return params


def _stack_layers(layers: list):
    """Concatenate per-layer block trees (leading axis 1) along that axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lay[k] for lay in layers]) for k in first}
    if isinstance(first, PackedWeight):
        def cat(field):
            if getattr(first, field) is None:
                return None
            return torch.cat([getattr(lay, field) for lay in layers])
        return PackedWeight(cat("packed"), first.k, first.kind,
                            first.conv_shape, first.orig_dtype,
                            thresh=cat("thresh"), flip=cat("flip"),
                            fold=first.fold)
    return torch.cat(layers)


def layer_params(params: dict, layer: int) -> dict:
    """Views of layer `layer` of the stacked block leaves."""
    def pick(_, p):
        if isinstance(p, PackedWeight):
            return PackedWeight(
                p.packed[layer], p.k, p.kind, p.conv_shape, p.orig_dtype,
                thresh=None if p.thresh is None else p.thresh[layer],
                flip=None if p.flip is None else p.flip[layer], fold=p.fold)
        return p[layer]
    return map_tree(pick, params["blocks"])


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------
def _qkv(p: dict, xn: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
         path: str):
    """Q, K, V of the normed residual; frozen weights read one shared
    sign-pack of it."""
    b, s, _ = xn.shape
    xs = shared_pack(xn, (p["wq"], p["wk"], p["wv"]), mode, path=path)
    q = qmatmul(xs, p["wq"], mode, path=path)
    k = qmatmul(xs, p["wk"], mode, path=path)
    v = qmatmul(xs, p["wv"], mode, path=path)
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def ffn_sublayer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 mode: QuantMode, *, path: str = "auto") -> torch.Tensor:
    if cfg.n_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP Queue A)")
    xn = rms_norm(x, p["ln2"]["scale"])
    return x + ffn(p["ffn"], xn, cfg.mlp, mode, path=path)


def _pack(x: torch.Tensor, path: str) -> torch.Tensor:
    """Sign words of new K/V rows (kernel A, or its plain version)."""
    return PackedActivation.pack(x, path=path).packed


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    return params["embed"][tokens.long()].to(cfg.activation_dtype)


def _head(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm and the LM head, a plain matmul in the activation dtype
    (`freeze` casts the head once, so this cast is then a no-op)."""
    h = rms_norm(h, params["final_norm"]["scale"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w.to(h.dtype))


# ---------------------------------------------------------------------------
# Bit-resident KV cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               page_size: int | None = None,
               pool_pages: int | None = None) -> dict:
    """Contiguous kv_bits=1 cache: {"k", "v": (L, batch, max_len, Hkv,
    ceil(hd/32)) int32 words, "v_scale": (L, batch, Hkv) float32}."""
    _check_served(cfg)
    if cfg.kv_bits != 1:
        raise NotImplementedError("the float KV cache (kv_bits=0) comes with "
                                  "the next slice (ROADMAP Queue A)")
    if page_size is not None or pool_pages is not None:
        raise NotImplementedError("the paged cache is not ported yet "
                                  "(ROADMAP Queue A, with kernels 7 and 9)")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             packed_width(cfg.head_dim))
    return {"k": torch.zeros(shape, dtype=torch.int32, device=dev),
            "v": torch.zeros(shape, dtype=torch.int32, device=dev),
            "v_scale": torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads),
                                   dtype=torch.float32, device=dev)}


def _write_rows(cache_rows: torch.Tensor, rows: torch.Tensor,
                idx: torch.Tensor, new: torch.Tensor,
                act: torch.Tensor) -> None:
    """cache_rows[rows, idx] = new where act, unchanged elsewhere: the
    JAX package's `.set(mode="drop")` for inactive rows, without a host
    sync (an inactive row rewrites its own old words; rows are distinct,
    so no two writes land on one position)."""
    old = cache_rows[rows, idx]
    cache_rows[rows, idx] = torch.where(act[:, None, None], new, old)


# ---------------------------------------------------------------------------
# Decode: one token per row against the cache
# ---------------------------------------------------------------------------
def _decode_self_block(bp, h, kc, vc, vs, cfg, mode, pos, act, path):
    """One-token block. h: (B, 1, D); kc/vc: (B, T, Hkv, hdw) views of the
    layer's cache; pos: (B,) int32 write positions. Rows with act False
    (pos < 0: freed or mid-admission slots) compute but write nothing."""
    b, t_max = h.shape[0], kc.shape[1]
    xn = rms_norm(h, bp["ln1"]["scale"])
    q, k_new, v_new = _qkv(bp["attn"], xn, cfg, mode, path)
    positions = pos[:, None]                                   # (B, 1)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    rows = torch.arange(b, device=h.device)
    idx = pos.clamp(0, t_max - 1).long()
    _write_rows(kc, rows, idx, _pack(k_new[:, 0], path), act)
    _write_rows(vc, rows, idx, _pack(v_new[:, 0], path), act)
    attend = decode_attention_packed if path == "auto" \
        else decode_attention_packed_plain
    out = attend(q, kc, vc, vs, pos + 1, window=cfg.local_window)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    h = h + qmatmul(out, bp["attn"]["wo"], mode, path=path)
    return ffn_sublayer(bp, h, cfg, mode, path=path)


def transformer_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                       cache: dict, pos, *, path: str = "auto"
                       ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B,) int; pos: int or (B,) int32 tensor (per
    row write position = tokens already in that row's context; pos < 0
    marks a row inactive: it computes but writes nothing to the cache).
    Returns (logits (B, V), the cache, updated in place)."""
    _check_served(cfg)
    mode = QuantMode(cfg.quant)
    b = token.shape[0]
    dev = token.device
    pos = (pos.to(torch.int32) if isinstance(pos, torch.Tensor)
           else torch.full((b,), int(pos), dtype=torch.int32, device=dev))
    t_max = cache["k"].shape[2]
    act = (pos >= 0) & (pos < t_max)
    h = _embed(params, cfg, token[:, None])
    for layer in range(cfg.n_layers):
        h = _decode_self_block(layer_params(params, layer), h,
                               cache["k"][layer], cache["v"][layer],
                               cache["v_scale"][layer], cfg, mode, pos, act,
                               path)
    return _head(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# Chunked prefill: advance one slot's prompt by one fixed-shape chunk
# ---------------------------------------------------------------------------
def _chunk_self_block(bp, h, kc, vc, vs, cfg, mode, positions, pos, n_valid,
                      path):
    """One block over a prefill chunk against the slot's cache row.
    h: (1, C, D); kc/vc: (1, T, Hkv, hdw) and vs: (1, Hkv) views of the
    slot's rows. The chunk's first n_valid K/V rows are written (pad rows
    write nothing), the V scale becomes the running mean |v| over
    [0, pos + n_valid), then the chunk attends to everything written."""
    c = h.shape[1]
    kv_len = pos + n_valid
    xn = rms_norm(h, bp["ln1"]["scale"])
    q, k_new, v_new = _qkv(bp["attn"], xn, cfg, mode, path)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    kc[0, pos:kv_len] = _pack(k_new[0, :n_valid], path)
    vc[0, pos:kv_len] = _pack(v_new[0, :n_valid], path)
    # running mean |v| over (positions so far, head_dim): equals the
    # whole-prompt v_cache_scale once the last chunk lands
    absm = v_new[0].to(torch.float32).abs().mean(dim=-1)      # (C, Hkv)
    msk = (torch.arange(c, device=h.device) < n_valid)[:, None]
    vs.copy_((vs * float(pos) + (absm * msk).sum(dim=0)[None])
             / float(kv_len))
    attend = prefill_attention_packed if path == "auto" \
        else prefill_attention_packed_plain
    out = attend(q, kc, vc, vs, kv_len, pos, window=cfg.local_window)
    out = out.reshape(1, c, cfg.n_heads * cfg.head_dim)
    h = h + qmatmul(out, bp["attn"]["wo"], mode, path=path)
    return ffn_sublayer(bp, h, cfg, mode, path=path)


def transformer_prefill_chunk(params: dict, cfg: ModelConfig,
                              tokens: torch.Tensor, cache: dict, slot: int,
                              pos: int, n_valid: int, *, path: str = "auto"
                              ) -> tuple[torch.Tensor, dict]:
    """Advance one slot's prefill by one fixed-shape chunk.

    tokens: (1, C) int, right-padded (only the first n_valid are real);
    cache: the scheduler's whole slot cache; slot, pos (tokens already
    written for this slot) and n_valid are host ints. K/V rows land at
    positions [pos, pos + n_valid) of the slot's row. Returns (logits
    (1, V) at the chunk's last real token, the cache, updated in place)."""
    _check_served(cfg)
    if not 1 <= n_valid <= tokens.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside 1..{tokens.shape[1]}")
    if pos < 0 or pos + n_valid > cache["k"].shape[2]:
        raise ValueError(f"chunk rows [{pos}, {pos + n_valid}) outside the "
                         f"cache's {cache['k'].shape[2]} positions")
    mode = QuantMode(cfg.quant)
    c = tokens.shape[1]
    positions = torch.arange(c, dtype=torch.int32, device=tokens.device) + pos
    h = _embed(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        h = _chunk_self_block(
            layer_params(params, layer), h,
            cache["k"][layer, slot:slot + 1], cache["v"][layer, slot:slot + 1],
            cache["v_scale"][layer, slot:slot + 1], cfg, mode, positions, pos,
            n_valid, path)
    return _head(params, cfg, h[:, n_valid - 1:n_valid])[:, 0], cache
