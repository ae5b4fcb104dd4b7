"""Decoder-only transformer, dense, moe, audio and vlm families: inference
forward, whole-prompt and chunked prefill, and decode from a float or
bit-resident KV cache (port of the serving path of
`repro.models.transformer`).
RMSNorm or LayerNorm (`cfg.norm`), RoPE or sinusoidal positions added to
the embedding (`cfg.pos`), an optional QKV bias (`cfg.qkv_bias`) and any
of the FFN kinds of `models.common.ffn`; with `cfg.n_experts` the FFN is
the MoE sublayer `models.common.moe_ffn`, whose expert capacity every row
of a call shares (a decode step's inactive rows and a chunk's pad rows
too, as in the JAX package).

Params are the JAX package's tree: dicts of tensors, the blocks' leaves
stacked along a leading L axis (frozen weights are `PackedWeight`s whose
words carry that axis too), so trees carry across with `convert`. The loop
over layers is a Python loop over views of the stacked leaves (`pick`).

The vlm family (llama-3.2-vision) stacks its layers in g = L / xattn_group
groups: {"groups": {"cross": leaves (g, ...), "self": (g, xattn_group - 1,
...)}}. A group runs its gated cross-attention block (`cross_attn`: float
queries of the residual against K/V of the request's image tokens, x +
tanh(gate) * out, then the block's FFN), then its self-attention blocks.
The vision frontend is a stub: callers pass precomputed patch embeddings
`img_emb` (B, n_img_tokens, d_vision), sign-packed once for K and V. The
cache keeps each group's image K/V per slot, "xk" / "xv" (g, B, n_img,
Hkv, w), written at admission (whole prompt, or a request's first chunk)
and read by every later chunk and decode step over all n_img rows: kernel
8 non-causal for a chunk, kernel 6 for a decode step at kv_bits=1, with a
V scale "xv_scale" (g, B, Hkv); they stay per slot in the paged layout.

The cache is float (`kv_bits=0`, the JAX default): K/V (L, B, T, Hkv, hd)
in the activation dtype; or bit-resident (`kv_bits=1`): K/V sign bitplanes
packed along head_dim, (L, B, T, Hkv, ceil(hd/32)) int32 words, plus a
float32 V scale per (layer, row, KV head). Unlike the JAX package, which
returns a new cache, the port updates the cache tensors in place and
returns the same dict: a full-width cache is written one row at a time,
never copied. A bit-resident cache's new rows are packed and stored in one
launch of kernel 5's `pack_rows_into` (K and V together, at the rows
`_decode_rows` / `_chunk_rows` / the prompt's give).

The paged layout (`init_cache(page_size=, pool_pages=)`) keeps K/V in
(L, P, ps, Hkv, ·) pools shared by every slot (vlm: (g, xattn_group - 1,
P, ...)) and a (B, NP) int32 page table per slot (entries equal to P: unallocated); V scales stay per slot.
Paging is addressing only: the same writes and the same attention, through
the page table (kernels 7 and 9 on a bit-resident pool; the float
attention on the gathered pages). It fills through chunked prefill only,
as in the JAX package.

Whole-prompt prefill (`transformer_prefill`) runs the float flash
attention over the prompt whatever the cache, then writes the K/V rows
(packed at `kv_bits=1`, with the V scale `v_cache_scale` fixes), as JAX
does.

`path` ('auto' | 'ref') picks, for every kernel on the path (sign-pack,
binary GEMMs, packed attention), the hand-written kernel (which one the
device decides: a CPU tensor runs the plain version) or the plain PyTorch
version on any device. The float attention is plain PyTorch on both. It is
the caller's explicit choice; nothing falls back on its own.

Training (`transformer_logits(train=True)`, `transformer_loss`): the fp32
masters through the binarized forward with the STE, the float attention's
custom backward (`models.attention`), each block (vlm: each group)
recomputed in the backward under cfg.remat; the loss is the next-token
cross-entropy plus 0.01 of the MoE load-balance loss, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitpack import packed_width
from repro_torch.core.layers import Draws, QuantMode, qmatmul, shared_pack
from repro_torch.core.packed import PackedWeight, map_tree
from repro_torch.kernels.decode_attention import (
    decode_attention_packed_paged_plain, decode_attention_packed_plain,
)
from repro_torch.kernels.pack import pack_rows_into, pack_rows_into_plain
from repro_torch.kernels.prefill_attention import (
    prefill_attention_packed_paged_plain, prefill_attention_packed_plain,
)
from repro_torch.models.attention import (
    chunk_attention, chunk_attention_paged, decode_attention,
    decode_attention_packed, decode_attention_packed_paged,
    decode_attention_paged, flash_attention, prefill_attention_packed,
    prefill_attention_packed_paged, v_cache_scale,
)
from repro_torch.models.common import (
    ffn, ffn_param_shapes, layer_norm, moe_ffn, moe_param_shapes, rms_norm,
    rope, site_qmm, sinusoidal_pos,
)


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise NotImplementedError(f"the transformer does not serve the "
                                  f"{cfg.family} family (models.ssm_lm does)")


def vlm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self-attention blocks per group) of the vlm family."""
    return cfg.n_layers // cfg.xattn_group, cfg.xattn_group - 1


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _norm_shapes(cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}
    return {"scale": (cfg.d_model,)}


def _block_shapes(cfg: ModelConfig, kind: str = "self") -> dict:
    """One block's leaf shapes: a self-attention block, or the vlm
    family's cross-attention block (K/V projections from d_vision, a
    scalar gate, no QKV bias)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d)}
    if kind == "cross":
        dv = cfg.d_vision or d
        attn.update({"wk": (dv, kv * hd), "wv": (dv, kv * hd), "gate": (1,)})
    elif cfg.qkv_bias:
        attn.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    ffn_shapes = (moe_param_shapes(d, cfg.d_ff, cfg.n_experts, cfg.mlp)
                  if cfg.n_experts else ffn_param_shapes(d, cfg.d_ff, cfg.mlp))
    return {"ln1": _norm_shapes(cfg), "ln2": _norm_shapes(cfg), "attn": attn,
            "ffn": ffn_shapes}


def init_transformer_params(gen: torch.Generator, cfg: ModelConfig, *,
                            device=None, freeze_layer=None) -> dict:
    """fp32 masters with the JAX package's shapes and scales: weight
    matrices N(0, 0.02^2), norm scales, biases and the vlm gates 0. Draws
    come from `gen`,
    on its device (a CPU generator gives the same weights on every device;
    a CUDA one draws a full-width model on the card in seconds).

    `freeze_layer`, when given, maps one layer's blocks (leaves with a
    leading axis of 1) to their frozen tree, and each layer is drawn and
    frozen before the next is drawn: only one layer's fp32 masters are
    ever resident (all 40 of phi3-medium-14b's are 54.5 GB; one of
    dbrx-132b's, with its 16 experts, 12.7 GB); the vlm family draws and
    freezes each group's cross block and each self block alike. The weights
    follow the same distribution as freezing the whole tree, not the same
    draws."""
    _check_served(cfg)
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * 0.02).to(dev)

    def init(shapes, prefix):
        if isinstance(shapes, dict):
            return {k: init(v, prefix) for k, v in shapes.items()}
        full = prefix + shapes
        return normal(full) if len(shapes) >= 2 else \
            torch.zeros(full, dtype=torch.float32, device=dev)

    def layers(shapes, n):
        return stack_layers([freeze_layer(init(shapes, (1,)))
                             for _ in range(n)])

    params = {"embed": normal((cfg.vocab, cfg.d_model)),
              "final_norm": {k: torch.zeros(v, device=dev)
                             for k, v in _norm_shapes(cfg).items()}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab))
    blocks = _block_shapes(cfg)
    if cfg.family == "vlm":
        g, p_self = vlm_layout(cfg)
        cross = _block_shapes(cfg, "cross")
        if freeze_layer is None:
            params["groups"] = {"cross": init(cross, (g,)),
                                "self": init(blocks, (g, p_self))}
        else:
            params["groups"] = {
                "cross": layers(cross, g),
                "self": stack_layers([pick(layers(blocks, p_self), None)
                                      for _ in range(g)])}
    elif freeze_layer is None:
        params["blocks"] = init(blocks, (cfg.n_layers,))
    else:
        params["blocks"] = layers(blocks, cfg.n_layers)
    return params


def stack_layers(layers: list):
    """Concatenate per-layer block trees (leading axis 1) along that axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lay[k] for lay in layers]) for k in first}
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


def pick(tree, *idx):
    """Views of the block at leading indices `idx` of stacked leaves (a
    PackedWeight's words, thresholds and flips too); an index of None adds
    a leading axis of 1 instead."""
    def leaf(_, p):
        if isinstance(p, PackedWeight):
            return PackedWeight(
                p.packed[idx], p.k, p.kind, p.conv_shape, p.orig_dtype,
                thresh=None if p.thresh is None else p.thresh[idx],
                flip=None if p.flip is None else p.flip[idx], fold=p.fold)
        return p[idx]
    return map_tree(leaf, tree)


def layer_params(params: dict, layer: int) -> dict:
    """Views of layer `layer` of the stacked block leaves."""
    return pick(params["blocks"], layer)


def layer_stack(params: dict, cfg: ModelConfig):
    """The stack in order, as (kind, block views, index): ("self", layer
    l, (l,)) for each layer; the vlm family's ("cross", group gi's cross
    block, gi) before ("self", its self block j, (gi, j)) for each j. A
    self block's index picks its cache leaves (K/V, V scale)."""
    if cfg.family != "vlm":
        for layer in range(cfg.n_layers):
            yield "self", layer_params(params, layer), (layer,)
        return
    g, p_self = vlm_layout(cfg)
    for gi in range(g):
        yield "cross", pick(params["groups"]["cross"], gi), gi
        for j in range(p_self):
            yield "self", pick(params["groups"]["self"], gi, j), (gi, j)


# ---------------------------------------------------------------------------
# Norm dispatch
# ---------------------------------------------------------------------------
def norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The config's norm: LayerNorm with gain 1 + scale and its bias, or
    RMSNorm."""
    if cfg.norm == "layernorm":
        return layer_norm(x, 1.0 + p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------
def qkv(p: dict, xn: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
        path: str, draws: Draws | None = None, site: str = "attn"):
    """Q, K, V of the normed residual; frozen weights read one shared
    sign-pack of it. The QKV bias (cfg.qkv_bias) is added in the
    activation dtype, before any rope. `draws`: a `core.layers.Draws` at
    train time (None at inference), sites "{site}.wq" etc."""
    b, s, _ = xn.shape
    xs = shared_pack(xn, (p["wq"], p["wk"], p["wv"]), mode, path=path)
    q, k, v = (site_qmm(xs, p[key], mode, path=path, draws=draws,
                        site=f"{site}.{key}") for key in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def ffn_sublayer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 mode: QuantMode, *, path: str = "auto",
                 aux: dict | None = None, draws: Draws | None = None,
                 site: str = "") -> torch.Tensor:
    """x + FFN(norm(x)): the dense FFN, or the MoE sublayer, whose lb_loss
    is added to aux["lb_loss"] when `aux` is given (serving drops it)."""
    xn = norm(p["ln2"], x, cfg)
    kw = dict(path=path, draws=draws, site=f"{site}ffn")
    if not cfg.n_experts:
        return x + ffn(p["ffn"], xn, cfg.mlp, mode, **kw)
    out, moe_aux = moe_ffn(p["ffn"], xn, cfg.mlp, mode, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, **kw)
    if aux is not None:
        aux["lb_loss"] = aux["lb_loss"] + moe_aux["lb_loss"]
    return x + out


def self_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
              *, path: str = "auto", pos_offset: int = 0,
              return_kv: bool = False, draws: Draws | None = None,
              site: str = ""):
    """Causal self-attention sublayer over a whole sequence (x: (B, S, D)
    at positions pos_offset..), float flash attention over the rope'd
    K/V. With `return_kv` also returns (k, v), each (B, S, Hkv, hd), for
    the cache. `site` prefixes the draws' site names ("blocks.3.")."""
    xn = norm(p["ln1"], x, cfg)
    q, k, v = qkv(p["attn"], xn, cfg, mode, path, draws, f"{site}attn")
    if cfg.pos == "rope":
        positions = torch.arange(x.shape[1], device=x.device) + pos_offset
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, True, cfg.local_window, cfg.attn_chunk,
                          pos_offset)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    y = x + site_qmm(out, p["attn"]["wo"], mode, path=path, draws=draws,
                     site=f"{site}attn.wo")
    return (y, (k, v)) if return_kv else y


def _self_block(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
                *, path: str = "auto", pos_offset: int = 0,
                return_kv: bool = False, aux: dict | None = None,
                draws: Draws | None = None, site: str = ""):
    """self_attn then the FFN sublayer; returns (y, (k, v) or None)."""
    res = self_attn(p, x, cfg, mode, path=path, pos_offset=pos_offset,
                    return_kv=return_kv, draws=draws, site=site)
    y, kv = res if return_kv else (res, None)
    return ffn_sublayer(p, y, cfg, mode, path=path, aux=aux, draws=draws,
                        site=site), kv


def image_kv(p: dict, img: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
             path: str, draws: Draws | None = None, site: str = "attn"):
    """K and V, each (B, n_img, Hkv, hd), of image tokens img (B, n_img,
    d_vision) in the activation dtype under a cross block's attention
    params `p`: frozen wk and wv read one shared sign-pack of img."""
    b, ni, _ = img.shape
    imgs = shared_pack(img, (p["wk"], p["wv"]), mode, path=path)
    k, v = (site_qmm(imgs, p[key], mode, path=path, draws=draws,
                     site=f"{site}.{key}") for key in ("wk", "wv"))
    return (k.reshape(b, ni, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, ni, cfg.n_kv_heads, cfg.head_dim))


def cross_query(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
                path: str, draws: Draws | None = None,
                site: str = "") -> torch.Tensor:
    """The cross block's queries (B, S, Hq, hd) of the normed residual (a
    float lhs: no shared pack, no rope)."""
    xn = norm(p["ln1"], x, cfg)
    q = site_qmm(xn, p["attn"]["wq"], mode, path=path, draws=draws,
                 site=f"{site}attn.wq")
    return q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)


def cross_out(p: dict, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig,
              mode: QuantMode, path: str, draws: Draws | None = None,
              site: str = "") -> torch.Tensor:
    """x + tanh(gate) * (out @ wo) in the activation dtype, then the cross
    block's FFN sublayer. out: (B, S, Hq, hd) attention output."""
    b, s = x.shape[:2]
    y = site_qmm(out.reshape(b, s, cfg.n_heads * cfg.head_dim),
                 p["attn"]["wo"], mode, path=path, draws=draws,
                 site=f"{site}attn.wo")
    gate = torch.tanh(p["attn"]["gate"]).to(y.dtype)
    return ffn_sublayer(p, x + gate * y, cfg, mode, path=path, draws=draws,
                        site=site)


def cross_attn(p: dict, x: torch.Tensor, kv, cfg: ModelConfig,
               mode: QuantMode, *, path: str = "auto",
               draws: Draws | None = None, site: str = "") -> torch.Tensor:
    """The vlm family's cross block over a whole sequence: gated
    cross-attention of x (B, S, D) against the image K/V `kv` (`image_kv`)
    with the float flash attention, non-causal, then its FFN sublayer."""
    q = cross_query(p, x, cfg, mode, path, draws, site)
    out = flash_attention(q, *kv, False, 0, cfg.attn_chunk, 0)
    return cross_out(p, x, out, cfg, mode, path, draws, site)


def pack_into(path: str, srcs, pools, rows: torch.Tensor) -> None:
    """Sign-pack the new K and V rows into their cache rows, in place: one
    launch of kernel 5's `pack_rows_into` ('auto'), or its plain version
    ('ref'). rows: one int64 row of the pools' (rows, Hkv, hdw) view per
    source row; rows outside the view write nothing."""
    if path == "auto":
        pack_rows_into(srcs, pools, rows)
    elif path == "ref":
        pack_rows_into_plain(srcs, pools, rows)
    else:
        raise ValueError(path)


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings (B, S, D) in the activation dtype; with sinusoidal
    positions (cfg.pos) plus the embedding of `positions`, which broadcast
    against tokens (default 0..S-1)."""
    h = params["embed"][tokens.long()].to(cfg.activation_dtype)
    if cfg.pos == "sinusoidal":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        pe = sinusoidal_pos(positions.reshape(-1), cfg.d_model)
        h = h + pe.reshape(tuple(positions.shape) + (-1,)).to(h.dtype)
    return h


def head(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm and the LM head, a plain matmul in the activation dtype
    (`freeze` casts the head once, so this cast is then a no-op)."""
    h = norm(params["final_norm"], h, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w.to(h.dtype))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def _kv_leaf(cfg: ModelConfig) -> tuple[torch.dtype, int]:
    """dtype and last-axis width of the K/V leaves: the activation dtype
    and hd (kv_bits=0), or int32 sign words, ceil(hd/32) (kv_bits=1)."""
    if cfg.kv_bits == 1:
        return torch.int32, packed_width(cfg.head_dim)
    if cfg.kv_bits != 0:
        raise ValueError(f"kv_bits must be 0 or 1, got {cfg.kv_bits}")
    return cfg.activation_dtype, cfg.head_dim


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               page_size: int | None = None,
               pool_pages: int | None = None) -> dict:
    """Zeroed KV cache. Contiguous: {"k", "v": (L, batch, max_len, Hkv, w)}
    with w = hd in the activation dtype (kv_bits=0) or ceil(hd/32) int32
    words (kv_bits=1, plus "v_scale": (L, batch, Hkv) float32).

    With `page_size` the layout is paged (the JAX package's): "k", "v" are
    (L, pool_pages, page_size, Hkv, w) pools shared by every slot
    (pool_pages defaults to batch * NP, what the contiguous cache holds),
    "page_table" is (batch, NP = ceil(max_len / page_size)) int32 filled
    with the sentinel pool_pages, and "v_scale" (kv_bits=1) stays (L,
    batch, Hkv). Each layer's pool is followed in memory by one more page,
    the sink, which only writes of inactive rows reach (`_with_sink`) and
    nothing reads.

    The vlm family's leading L is (g, xattn_group - 1) on "k", "v" and
    "v_scale", and its image K/V "xk", "xv" (g, batch, n_img_tokens, Hkv,
    w), with "xv_scale" (g, batch, Hkv) at kv_bits=1, stay per slot in
    either layout."""
    _check_served(cfg)
    dtype, w = _kv_leaf(cfg)
    dev = resolve_device(device)
    hkv = cfg.n_kv_heads
    lead = vlm_layout(cfg) if cfg.family == "vlm" else (cfg.n_layers,)
    cache = {}
    if page_size is None:
        if pool_pages is not None:
            raise ValueError("pool_pages needs page_size (the paged layout)")
        shape = lead + (batch, max_len, hkv, w)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        n_pages = -(-max_len // page_size)
        pool = pool_pages if pool_pages is not None else batch * n_pages
        for name in ("k", "v"):
            cache[name] = new_pool(*lead, pool, page_size, hkv, w,
                                   device=dev, dtype=dtype)
        cache["page_table"] = torch.full((batch, n_pages), pool,
                                         dtype=torch.int32, device=dev)
    if cfg.kv_bits == 1:
        cache["v_scale"] = torch.zeros(lead + (batch, hkv),
                                       dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        g = lead[0]
        for name in ("xk", "xv"):
            cache[name] = torch.zeros((g, batch, cfg.n_img_tokens, hkv, w),
                                      dtype=dtype, device=dev)
        if cfg.kv_bits == 1:
            cache["xv_scale"] = torch.zeros((g, batch, hkv),
                                            dtype=torch.float32, device=dev)
    return cache


def new_pool(*shape: int, device, dtype: torch.dtype = torch.int32
             ) -> torch.Tensor:
    """Zeroed (*lead, pool, page_size, Hkv, w) page pools (int32 words, or
    the float cache's dtype; lead: (L,), or the vlm family's (g,
    xattn_group - 1)): a view of (*lead, pool + 1, ...) storage, so that
    each layer's pool is followed by its sink page (see `_with_sink`)."""
    *lead, pool, page_size, hkv, w = shape
    if pool < 1:
        raise ValueError(f"pool_pages must be >= 1, got {pool}")
    storage = torch.zeros((*lead, pool + 1, page_size, hkv, w), dtype=dtype,
                          device=device)
    return storage[..., :pool, :, :, :]


def _with_sink(pool: torch.Tensor) -> torch.Tensor:
    """One layer's (P, ps, Hkv, w) pool seen as P + 1 pages, the last the
    sink. Rows that must write nothing (inactive decode rows, chunk rows
    whose table entry is the sentinel P) write page P of this view: a page
    no table names and no kernel reads. Writing their own old words instead
    races: a freed slot's all-sentinel row would land on page P - 1, which
    may be the very (page, row) an active slot writes in the same step."""
    p = pool.shape[0]
    end = (pool.storage_offset() + (p + 1) * pool.stride(0)) \
        * pool.element_size()
    if pool.untyped_storage().nbytes() < end:
        raise ValueError("the pool has no sink page: make pools with "
                         "init_cache or new_pool")
    return pool.as_strided((p + 1,) + tuple(pool.shape[1:]), pool.stride())


def _rows_view(panel: torch.Tensor) -> torch.Tensor:
    """A (B | P, T | ps, Hkv, w) panel or pool as (rows, Hkv, w), a view
    (it raises rather than copy)."""
    return panel.view((-1,) + tuple(panel.shape[2:]))


def cache_len_max(cache: dict) -> int:
    """Positions one slot's cache holds: T contiguous, NP * ps paged (the
    K leaf's (..., B | P, T | ps, Hkv, w))."""
    if "page_table" in cache:
        return cache["page_table"].shape[1] * cache["k"].shape[-3]
    return cache["k"].shape[-3]


def _image(cfg: ModelConfig, img_emb, batch: int, *, required: bool):
    """img_emb (batch, n_img_tokens, d_vision) checked and cast to the
    activation dtype, or None where no image is passed (the vlm family
    needs one where `required`; other families take none)."""
    if cfg.family != "vlm":
        if img_emb is not None:
            raise ValueError(f"img_emb is vlm-only (family is "
                             f"{cfg.family!r})")
        return None
    if img_emb is None:
        if required:
            raise ValueError("the vlm family needs img_emb (B, "
                             "n_img_tokens, d_vision)")
        return None
    want = (batch, cfg.n_img_tokens, cfg.d_vision)
    if tuple(img_emb.shape) != want:
        raise ValueError(f"img_emb shape {tuple(img_emb.shape)} != {want}")
    return img_emb.to(cfg.activation_dtype)


def _write_image_kv(cache: dict, gi: int, k: torch.Tensor, v: torch.Tensor,
                    slot: int, cfg: ModelConfig, path: str) -> None:
    """Store group gi's image K/V, each (B, n_img, Hkv, hd), in the image
    rows of slots [slot, slot + B): kv_bits=1 packed in one launch of
    kernel 5 (`pack_rows_into`), the V scale `v_cache_scale` over the
    n_img rows; kv_bits=0 in the activation dtype."""
    b, ni = k.shape[:2]
    xk, xv = cache["xk"][gi], cache["xv"][gi]
    if cfg.kv_bits == 1:
        rows = torch.arange(slot * ni, (slot + b) * ni, device=k.device)
        pack_into(path, (k.flatten(0, 1), v.flatten(0, 1)), (xk, xv), rows)
        cache["xv_scale"][gi, slot:slot + b] = v_cache_scale(v)
    else:
        xk[slot:slot + b] = k.to(xk.dtype)
        xv[slot:slot + b] = v.to(xv.dtype)


# ---------------------------------------------------------------------------
# Decode: one token per row against the cache
# ---------------------------------------------------------------------------
def _decode_self_block(bp, h, kc, vc, vs, cfg, mode, pos, rows, path,
                       pt=None):
    """One-token block. h: (B, 1, D); kc/vc: (B, T, Hkv, w) views of the
    layer's cache, or with the page table `pt` the layer's (P, ps, Hkv, w)
    pools; vs: the layer's (B, Hkv) V scales (kv_bits=1) or None; pos: (B,)
    int32 write positions; rows: (B,) int64 write rows (`_decode_rows`).
    Rows with pos < 0 (freed or mid-admission slots) compute but write
    nothing a table names."""
    b = h.shape[0]
    xn = norm(bp["ln1"], h, cfg)
    q, k_new, v_new = qkv(bp["attn"], xn, cfg, mode, path)
    if cfg.pos == "rope":
        positions = pos[:, None]                               # (B, 1)
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)
    new = (k_new[:, 0], v_new[:, 0])
    window = cfg.local_window
    if cfg.kv_bits == 1:
        if pt is None:
            pack_into(path, new, (kc, vc), rows)
            attend = decode_attention_packed if path == "auto" \
                else decode_attention_packed_plain
            out = attend(q, kc, vc, vs, pos + 1, window=window)
        else:
            pack_into(path, new, (_with_sink(kc), _with_sink(vc)), rows)
            attend = decode_attention_packed_paged if path == "auto" \
                else decode_attention_packed_paged_plain
            out = attend(q, kc, vc, vs, pt, pos + 1, window=window)
    elif pt is None:
        # an inactive row rewrites its own old values (rows are distinct,
        # so no two writes land on one position; no host sync)
        act = (rows >= 0)[:, None, None]
        bi = torch.arange(b, device=h.device)
        idx = pos.clamp(0, kc.shape[1] - 1).long()
        for c, x in zip((kc, vc), new):
            c[bi, idx] = torch.where(act, x.to(c.dtype), c[bi, idx])
        out = decode_attention(q, kc, vc, pos + 1, window=window)
    else:
        for c, x in zip((kc, vc), new):
            _rows_view(_with_sink(c))[rows] = x.to(c.dtype)
        out = decode_attention_paged(q, kc, vc, pt, pos + 1, window=window)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    h = h + qmatmul(out, bp["attn"]["wo"], mode, path=path)
    return ffn_sublayer(bp, h, cfg, mode, path=path)


def _decode_rows(cache: dict, pos: torch.Tensor, act: torch.Tensor):
    """Write rows of a decode step, the same for every layer, as (B,) int64
    rows of the layer's cache seen as (rows, Hkv, w). Contiguous: row b
    writes b * T + pos[b], an inactive row -1 (nothing: it keeps its old
    words). Paged (the pools seen with their sink page): page pt[b, pos //
    ps], row pos % ps; an inactive row the sink page P."""
    b = pos.shape[0]
    pt = cache.get("page_table")
    posc = pos.clamp(min=0).long()
    if pt is None:
        t = cache["k"].shape[-3]
        base = torch.arange(b, device=pos.device) * t
        return torch.where(act, base + posc, -1)
    p_pool, ps = cache["k"].shape[-4], cache["k"].shape[-3]
    pidx = (posc // ps).clamp(max=pt.shape[1] - 1)
    slots = torch.arange(b, device=pos.device)
    wpage = torch.where(act, pt[slots, pidx].long(), p_pool)
    return wpage * ps + posc % ps


def _decode_cross_block(bp, h, xk, xv, xvs, cfg, mode, path):
    """The cross block of a decode step: each row's query against its slot's
    cached image K/V, every one of the n_img rows (inactive rows too).
    h: (B, 1, D); xk/xv: the group's (B, n_img, Hkv, w) image rows; xvs:
    their (B, Hkv) V scales (kv_bits=1) or None."""
    q = cross_query(bp, h, cfg, mode, path)
    n_img = xk.shape[1]
    if cfg.kv_bits == 1:
        attend = decode_attention_packed if path == "auto" \
            else decode_attention_packed_plain
        out = attend(q, xk, xv, xvs, n_img)
    else:
        out = decode_attention(q, xk, xv, n_img)
    return cross_out(bp, h, out, cfg, mode, path)


def transformer_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                       cache: dict, pos, *, path: str = "auto"
                       ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B,) int; pos: int or (B,) int32 tensor (per
    row write position = tokens already in that row's context; pos < 0
    marks a row inactive: it computes but writes nothing to the cache).
    The cache is contiguous or paged (`init_cache`). Returns (logits (B, V),
    the cache, updated in place)."""
    _check_served(cfg)
    mode = QuantMode(cfg.quant)
    b = token.shape[0]
    dev = token.device
    pos = (pos.to(torch.int32) if isinstance(pos, torch.Tensor)
           else torch.full((b,), int(pos), dtype=torch.int32, device=dev))
    act = (pos >= 0) & (pos < cache_len_max(cache))
    rows = _decode_rows(cache, pos, act)
    pt = cache.get("page_table")
    vs = cache.get("v_scale")
    h = embed(params, cfg, token[:, None], pos[:, None])
    for kind, bp, idx in layer_stack(params, cfg):
        if kind == "cross":
            h = _decode_cross_block(
                bp, h, cache["xk"][idx], cache["xv"][idx],
                cache["xv_scale"][idx] if cfg.kv_bits == 1 else None, cfg,
                mode, path)
            continue
        h = _decode_self_block(bp, h, cache["k"][idx], cache["v"][idx],
                               None if vs is None else vs[idx], cfg, mode,
                               pos, rows, path, pt)
    return head(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# Chunked prefill: advance one slot's prompt by one fixed-shape chunk
# ---------------------------------------------------------------------------
def _chunk_self_block(bp, h, kc, vc, vs, cfg, mode, positions, pos, n_valid,
                      rows, path, pt_row=None):
    """One block over a prefill chunk against the slot's cache row.
    h: (1, C, D); kc/vc: (1, T, Hkv, w) and vs: (1, Hkv) (kv_bits=1; else
    None) views of the slot's rows, or with the slot's (1, NP) page-table
    row `pt_row` the layer's (P, ps, Hkv, w) pools; rows: (C,) int64 write
    rows (`_chunk_rows`). The chunk's first n_valid K/V rows are written
    (pad rows write nothing), the V scale becomes the running mean |v| over
    [0, pos + n_valid), then the chunk attends to everything written."""
    c = h.shape[1]
    kv_len = pos + n_valid
    window = cfg.local_window
    xn = norm(bp["ln1"], h, cfg)
    q, k_new, v_new = qkv(bp["attn"], xn, cfg, mode, path)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)
    pools = (kc, vc) if pt_row is None else (_with_sink(kc), _with_sink(vc))
    if cfg.kv_bits == 0:
        for pool, x in zip(pools, (k_new[0], v_new[0])):
            _rows_view(pool)[rows[:n_valid]] = x[:n_valid].to(pool.dtype)
        if pt_row is None:
            out = chunk_attention(q, kc, vc, kv_len, pos, window=window)
        else:
            out = chunk_attention_paged(q, kc, vc, pt_row, kv_len, pos,
                                        window=window)
        out = out.reshape(1, c, cfg.n_heads * cfg.head_dim)
        h = h + qmatmul(out, bp["attn"]["wo"], mode, path=path)
        return ffn_sublayer(bp, h, cfg, mode, path=path)
    pack_into(path, (k_new[0], v_new[0]), pools, rows)
    # running mean |v| over (positions so far, head_dim): equals the
    # whole-prompt v_cache_scale once the last chunk lands; the same in
    # either layout, which keeps paged prefill equal to contiguous
    absm = v_new[0].to(torch.float32).abs().mean(dim=-1)      # (C, Hkv)
    msk = (torch.arange(c, device=h.device) < n_valid)[:, None]
    vs.copy_((vs * float(pos) + (absm * msk).sum(dim=0)[None])
             / float(kv_len))
    if pt_row is None:
        attend = prefill_attention_packed if path == "auto" \
            else prefill_attention_packed_plain
        out = attend(q, kc, vc, vs, kv_len, pos, window=window)
    else:
        attend = prefill_attention_packed_paged if path == "auto" \
            else prefill_attention_packed_paged_plain
        out = attend(q, kc, vc, vs, pt_row, kv_len, pos, window=window)
    out = out.reshape(1, c, cfg.n_heads * cfg.head_dim)
    h = h + qmatmul(out, bp["attn"]["wo"], mode, path=path)
    return ffn_sublayer(bp, h, cfg, mode, path=path)


def _chunk_rows(cache: dict, pt_row, positions: torch.Tensor,
                n_valid: int) -> torch.Tensor:
    """Write rows of a chunk, the same for every layer, as (C,) int64 rows
    of the layer's cache seen as (rows, Hkv, w): contiguous, position t
    of the slot's (1, T) panel; paged (the pools seen with their sink
    page), page pt_row[t // ps], row t % ps, where an unallocated entry
    (the sentinel P) writes the sink page. Pad rows: -1 (nothing)."""
    live = torch.arange(positions.shape[0], device=positions.device) < n_valid
    t = positions.long()
    if pt_row is not None:
        ps = cache["k"].shape[-3]
        pidx = (t // ps).clamp(max=pt_row.shape[1] - 1)
        t = pt_row[0, pidx].long() * ps + t % ps
    return torch.where(live, t, -1)


def _chunk_cross_block(bp, h, xk, xv, xvs, cfg, mode, path):
    """The cross block of a prefill chunk: the chunk's queries against the
    slot's cached image rows, all n_img of them, non-causal (kernel 8 at
    kv_bits=1, q_pos 0; the float chunk attention at kv_bits=0). h: (1,
    C, D); xk/xv: (1, n_img, Hkv, w) views of the slot's rows; xvs: their
    (1, Hkv) V scale (kv_bits=1) or None."""
    q = cross_query(bp, h, cfg, mode, path)
    n_img = xk.shape[1]
    if cfg.kv_bits == 1:
        attend = prefill_attention_packed if path == "auto" \
            else prefill_attention_packed_plain
        out = attend(q, xk, xv, xvs, n_img, 0, causal=False)
    else:
        out = chunk_attention(q, xk, xv, n_img, 0, causal=False)
    return cross_out(bp, h, out, cfg, mode, path)


def transformer_prefill_chunk(params: dict, cfg: ModelConfig,
                              tokens: torch.Tensor, cache: dict, slot: int,
                              pos: int, n_valid: int, *,
                              img_emb: torch.Tensor | None = None,
                              path: str = "auto"
                              ) -> tuple[torch.Tensor, dict]:
    """Advance one slot's prefill by one fixed-shape chunk.

    tokens: (1, C) int, right-padded (only the first n_valid are real);
    cache: the scheduler's whole slot cache, contiguous or paged; slot, pos
    (tokens already written for this slot) and n_valid are host ints. K/V
    rows land at positions [pos, pos + n_valid) of the slot's row -- paged:
    at page pt[slot, t // ps], row t % ps, read from the device page table
    (no host sync); rows whose entry is the sentinel write nothing. vlm:
    img_emb (1, n_img_tokens, d_vision), passed with a request's first
    chunk only, has each group's image K/V computed and written to the
    slot's rows (`_write_image_kv`); every chunk cross-attends to those
    rows. Returns (logits (1, V) at the chunk's last real token, the
    cache, updated in place)."""
    _check_served(cfg)
    if not 1 <= n_valid <= tokens.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside 1..{tokens.shape[1]}")
    t_max = cache_len_max(cache)
    if pos < 0 or pos + n_valid > t_max:
        raise ValueError(f"chunk rows [{pos}, {pos + n_valid}) outside the "
                         f"cache's {t_max} positions")
    img = _image(cfg, img_emb, 1, required=False)
    mode = QuantMode(cfg.quant)
    c = tokens.shape[1]
    positions = torch.arange(c, dtype=torch.int32, device=tokens.device) + pos
    pt_row = cache["page_table"][slot:slot + 1] if "page_table" in cache \
        else None
    rows = _chunk_rows(cache, pt_row, positions, n_valid)
    vs = cache.get("v_scale")
    sl = slice(slot, slot + 1)
    h = embed(params, cfg, tokens, positions)
    for kind, bp, idx in layer_stack(params, cfg):
        if kind == "cross":
            if img is not None:
                _write_image_kv(cache, idx, *image_kv(bp["attn"], img, cfg,
                                                      mode, path),
                                slot, cfg, path)
            h = _chunk_cross_block(
                bp, h, cache["xk"][idx, sl], cache["xv"][idx, sl],
                cache["xv_scale"][idx, sl] if cfg.kv_bits == 1 else None,
                cfg, mode, path)
            continue
        if pt_row is None:
            kc, vc = cache["k"][idx + (sl,)], cache["v"][idx + (sl,)]
        else:
            kc, vc = cache["k"][idx], cache["v"][idx]
        h = _chunk_self_block(
            bp, h, kc, vc, None if vs is None else vs[idx + (sl,)], cfg,
            mode, positions, pos, n_valid, rows, path, pt_row)
    return head(params, cfg, h[:, n_valid - 1:n_valid])[:, 0], cache


# ---------------------------------------------------------------------------
# Whole-prompt prefill and the inference forward
# ---------------------------------------------------------------------------
def transformer_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        *, img_emb: torch.Tensor | None = None,
                        max_len: int | None = None,
                        cache: dict | None = None, slot: int = 0,
                        path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Run whole prompts: tokens (B, S) int. Every layer attends over the
    prompt with the float flash attention, then its K/V rows 0..S-1 land
    in cache rows [slot, slot + B) -- kv_bits=1: packed and stored in one
    launch of kernel 5 (`pack_rows_into`), the V scale `v_cache_scale`.
    vlm: img_emb (B, n_img_tokens, d_vision); each group's image K/V is
    computed once, for the cross-attention (float, non-causal) and for its
    cache rows (`_write_image_kv`). With `cache` None a new contiguous
    cache of B rows at max_len (default S) is made, as the JAX package
    returns one; a given cache is written in place, and at kv_bits=0 its
    rows' positions past S are zeroed (one fill each of K and V over every
    layer), as the JAX scheduler overwrites a slot's whole row: lengths
    mask those positions, but a masked weight 0 times a non-finite V that
    the slot's last occupant left would be NaN (sign words hold no NaN and
    the V scale is rewritten). A paged cache fills through chunked prefill
    only (ValueError). Returns (logits (B, V) at the last position, the
    cache)."""
    _check_served(cfg)
    b, s = tokens.shape
    img = _image(cfg, img_emb, b, required=True)
    given = cache is not None
    if cache is None:
        cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    elif "page_table" in cache:
        raise ValueError("a paged cache fills through chunked admission: "
                         "pass prefill_chunk")
    n_slots, t_max = cache["k"].shape[-4:-2]
    if not (1 <= s <= t_max and 0 <= slot and slot + b <= n_slots):
        raise ValueError(f"prompt rows {s} x slots [{slot}, {slot + b}) "
                         f"outside the cache's {(n_slots, t_max)}")
    mode = QuantMode(cfg.quant)
    if cfg.kv_bits == 1:
        dev = tokens.device
        rows = ((torch.arange(b, device=dev)[:, None] + slot) * t_max
                + torch.arange(s, device=dev)[None]).reshape(-1)
    elif given and s < t_max:
        for name in ("k", "v"):
            cache[name][..., slot:slot + b, s:, :, :].zero_()
    h = embed(params, cfg, tokens)
    for kind, bp, idx in layer_stack(params, cfg):
        if kind == "cross":
            kv = image_kv(bp["attn"], img, cfg, mode, path)
            h = cross_attn(bp, h, kv, cfg, mode, path=path)
            _write_image_kv(cache, idx, *kv, slot, cfg, path)
            continue
        h, (k, v) = _self_block(bp, h, cfg, mode, path=path, return_kv=True)
        kc, vc = cache["k"][idx], cache["v"][idx]
        if cfg.kv_bits == 1:
            pack_into(path, (k.flatten(0, 1), v.flatten(0, 1)), (kc, vc),
                      rows)
            cache["v_scale"][idx + (slice(slot, slot + b),)] = \
                v_cache_scale(v)
        else:
            kc[slot:slot + b, :s] = k.to(kc.dtype)
            vc[slot:slot + b, :s] = v.to(vc.dtype)
    return head(params, cfg, h[:, -1:])[:, 0], cache


def transformer_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       *, img_emb: torch.Tensor | None = None,
                       train: bool = False, gen: torch.Generator | None = None,
                       noise: dict | None = None, path: str = "auto"
                       ) -> tuple[torch.Tensor, dict]:
    """The forward over whole sequences: tokens (B, S) (vlm: and img_emb (B,
    n_img_tokens, d_vision)) -> (logits (B, S, V), {"lb_loss": the MoE
    load-balance loss summed over the layers, 0 for a dense stack}), causal
    float flash attention in every self block, non-causal in every cross
    block, no cache.

    train=True: the training forward of fp32 masters (Algorithm 1: every
    projection binarized with the STE; stochastically in the modes that
    draw, from `gen` in the order the forward visits the sites or from the
    dict `noise` by site name, "blocks.{l}.attn.wq.qact", "blocks.{l}.ffn.
    w_up.w", vlm "groups.{g}.cross.attn.wk.w", "groups.{g}.self.{j}.ffn.
    experts.w_down.qact"). With cfg.remat each block (vlm: each group) is
    recomputed in the backward (`remat`)."""
    _check_served(cfg)
    img = _image(cfg, img_emb, tokens.shape[0], required=True)
    mode = QuantMode(cfg.quant)
    h = embed(params, cfg, tokens)
    aux = {"lb_loss": torch.zeros((), dtype=torch.float32, device=h.device)}
    if train:
        return _train_forward(params, cfg, h, img, Draws(True, gen, noise),
                              path, aux)
    for kind, bp, _ in layer_stack(params, cfg):
        if kind == "cross":
            h = cross_attn(bp, h, image_kv(bp["attn"], img, cfg, mode, path),
                           cfg, mode, path=path)
        else:
            h, _ = _self_block(bp, h, cfg, mode, path=path, aux=aux)
    return head(params, cfg, h), aux


def unstack(tree) -> list:
    """The per-layer trees of a tree of stacked masters: each leaf unbound
    along its leading axis (one backward node per leaf, which stacks the
    layers' gradients)."""
    if isinstance(tree, dict):
        subs = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def remat(cfg: ModelConfig, draws: Draws, fn, *args):
    """fn(*args), recomputed in the backward under cfg.remat
    (`torch.utils.checkpoint`, non-reentrant). The recomputation draws the
    same noise as the forward: a generator the draws come from is set back
    to its state at the region's start for the recomputation, and to where
    it was after it (checkpoint's own RNG handling covers the global
    generators only)."""
    if not cfg.remat:
        return fn(*args)
    gen = draws.gen if draws.on and draws.noise is None else None
    run = fn
    if gen is not None:
        start, calls = gen.get_state(), [0]

        def run(*a):
            calls[0] += 1
            if calls[0] == 1:
                return fn(*a)
            end = gen.get_state()
            gen.set_state(start)
            try:
                return fn(*a)
            finally:
                gen.set_state(end)
    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _train_forward(params, cfg, h, img, draws: Draws, path: str, aux: dict):
    mode = QuantMode(cfg.quant)

    def block(bp, site, h):
        a = {"lb_loss": torch.zeros((), dtype=torch.float32, device=h.device)}
        h, _ = _self_block(bp, h, cfg, mode, path=path, aux=a, draws=draws,
                           site=site)
        return h, a["lb_loss"]

    def group(cp, sps, gi, h):
        site = f"groups.{gi}.cross."
        kv = image_kv(cp["attn"], img, cfg, mode, path, draws, f"{site}attn")
        h = cross_attn(cp, h, kv, cfg, mode, path=path, draws=draws,
                       site=site)
        lb = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, sp in enumerate(sps):
            h, lb_j = block(sp, f"groups.{gi}.self.{j}.", h)
            lb = lb + lb_j
        return h, lb

    if cfg.family == "vlm":
        cross = unstack(params["groups"]["cross"])
        selfs = [unstack(g) for g in unstack(params["groups"]["self"])]
        for gi, (cp, sps) in enumerate(zip(cross, selfs)):
            h, lb = remat(cfg, draws, lambda x, cp=cp, sps=sps, gi=gi:
                          group(cp, sps, gi, x), h)
            aux["lb_loss"] = aux["lb_loss"] + lb
    else:
        for layer, bp in enumerate(unstack(params["blocks"])):
            h, lb = remat(cfg, draws, lambda x, bp=bp, layer=layer:
                          block(bp, f"blocks.{layer}.", x), h)
            aux["lb_loss"] = aux["lb_loss"] + lb
    return head(params, cfg, h), aux


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] (in float32) against tokens[:,
    1:], the JAX package's logsumexp - gold."""
    logits = logits[:, :-1].to(torch.float32)
    gold = torch.take_along_dim(logits, tokens[:, 1:, None].long(), dim=-1)
    return (torch.logsumexp(logits, dim=-1) - gold[..., 0]).mean()


def transformer_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                     gen: torch.Generator | None = None,
                     noise: dict | None = None, path: str = "auto"
                     ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy plus 0.01 lb_loss of the training forward.
    batch: {"tokens" (B, S), ["img_emb"]}. Returns (loss, {"nll",
    "lb_loss"})."""
    tokens = batch["tokens"]
    logits, aux = transformer_logits(params, cfg, tokens,
                                     img_emb=batch.get("img_emb"), train=True,
                                     gen=gen, noise=noise, path=path)
    nll = next_token_nll(logits, tokens)
    return nll + 0.01 * aux["lb_loss"], {"nll": nll, **aux}
