"""The SSM-family LMs, served from O(1) recurrent state per slot (port of
the serving paths of `repro.models.ssm_lm`): falcon-mamba-7b, the pure
Mamba stack, and recurrentgemma-2b, the hybrid of RG-LRU and local
attention.

falcon-mamba-7b. Params are the JAX package's tree: {"embed", "blocks",
"final_norm", "lm_head"}, the blocks' leaves stacked along a leading L axis
(frozen in_proj / x_proj / out_proj are `PackedWeight`s whose words carry
that axis), so trees carry across with `convert`. The state is {"conv": (L,
B, K-1, di) in the activation dtype, "h": (L, B, di, N) float32}; like the
port's transformer cache it is updated in place and the same dict returned.

`path` ('auto' | 'ref') picks the kernels (the binary GEMMs and kernel 10,
the selective scan) or their plain versions, as in `models.transformer`.

Whole-prompt `mamba_prefill` and the inference forward `mamba_logits` run
each block as the chunk block from zero state over the whole sequence, so
the scan is one launch of kernel 10 at T = S per layer (the JAX package
runs its jnp `_mamba_chunk_scan` there).

recurrentgemma-2b. Layers come in groups of the block pattern (rec, rec,
attn), then a tail of leftover rec layers; every layer is its temporal mix
(an RG-LRU sublayer, `models.ssm`, or local attention with window W =
`local_window`) followed by a GeGLU MLP. Params: {"embed", "groups": {"rec":
leaves stacked (g, n_rec, ...), "attn": (g, ...)}, "tail": (tail, ...),
"final_norm"}; the head is the embedding (`tie_embeddings`). The state
(`rg_init_state`) holds each rec layer's conv history and h, and each
attention layer's ring of the last W K/V rows, position t at slot t % W:
float rows (kv_bits=0) or sign words with a V scale per (slot, KV head)
(kv_bits=1). A decode step attends over the ring through kernel 6 at
kv_bits=1 (its rows packed in by kernel 5's `pack_rows_into`) and through
the float `decode_attention` at kv_bits=0; a whole prompt runs the float
flash attention with the window; a prefill chunk attends over the ring and
its own rows with the plain `packed_masked_attention_ref` or
`masked_chunk_attention`, as the JAX package does with its jnp cores.

Training (`mamba_logits` / `rg_logits` with train=True, `mamba_loss`,
`rg_loss`): fp32 masters through the blocks' train paths (`models.ssm`),
stochastic draws from `gen` or the dict `noise` by site ("blocks.{l}.
in_proj.w"; the hybrid's "groups.{g}.rec.{j}.mix.w_x.qact", "groups.{g}.
attn.mix.attn.wq.w", "groups.{g}.attn.ffn.w_up.w", "tail.{j}.mix.w_out.w");
under cfg.remat each Mamba block, each hybrid group and each tail layer
is recomputed in the backward, as the JAX package remats them.
"""
from __future__ import annotations

import torch

from repro_torch._device import draw_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitpack import packed_width
from repro_torch.core.layers import BatchShard, Draws, QuantMode, qmatmul
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, decode_attention_packed_plain,
)
from repro_torch.kernels.ref import packed_masked_attention_ref
from repro_torch.models.attention import (
    decode_attention, masked_chunk_attention, v_cache_scale,
)
from repro_torch.models.common import ffn_param_shapes, rms_norm, rope
from repro_torch.models.ssm import (
    init_mamba_blocks, mamba_block_chunk, mamba_block_step,
    mamba_block_train, rglru_block, rglru_block_chunk, rglru_block_shapes,
    rglru_block_step,
)
from repro_torch.models.transformer import (
    embed, ffn_sublayer, head, layer_params, next_token_nll, pack_into, pick,
    qkv, remat, self_attn, stack_layers, unstack,
)


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} is {cfg.family}, not the Mamba stack")


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, *,
                      device=None, freeze_layer=None) -> dict:
    """fp32 masters with the JAX package's shapes and init rules
    (`ssm.init_mamba_blocks`; embedding and head N(0, 0.02^2), final norm
    scale 0). Draws come from `gen`, on its device.

    `freeze_layer`, when given, maps one layer's blocks (leading axis 1) to
    their frozen tree, and each layer is drawn and frozen before the next:
    only one layer's fp32 masters are ever resident (all 64 of
    falcon-mamba-7b's are about 27 GB). The weights follow the same
    distribution as freezing the whole tree, not the same draws."""
    _check_served(cfg)
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=gen,
                            device=draw_device(gen, dev))
                * 0.02).to(dev)

    params = {"embed": normal((cfg.vocab, cfg.d_model)),
              "final_norm": {"scale": torch.zeros(cfg.d_model, device=dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab))
    if freeze_layer is None:
        params["blocks"] = init_mamba_blocks(gen, cfg, cfg.n_layers, dev)
    else:
        params["blocks"] = stack_layers(
            [freeze_layer(init_mamba_blocks(gen, cfg, 1, dev))
             for _ in range(cfg.n_layers)])
    return params


def mamba_init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """Zeroed recurrent state of `batch` slots: the conv history (L, B,
    K-1, di) in the activation dtype and the SSM state (L, B, di, N)
    float32."""
    _check_served(cfg)
    dev = resolve_device(device)
    di = cfg.expand * cfg.d_model
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, di),
                            dtype=cfg.activation_dtype, device=dev),
        "h": torch.zeros((cfg.n_layers, batch, di, cfg.ssm_state),
                         dtype=torch.float32, device=dev),
    }


def mamba_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: dict, pos, *, path: str = "auto"
                 ) -> tuple[torch.Tensor, dict]:
    """O(1) decode step. token: (B,) int; pos: int or (B,) int32 tensor. The
    recurrence is position-free, so `pos` only marks inactive rows: rows
    with pos < 0 compute but leave their state as it was. Returns (logits
    (B, V), the state, updated in place)."""
    _check_served(cfg)
    mode = QuantMode(cfg.quant)
    b = token.shape[0]
    pos = (pos.to(torch.int32) if isinstance(pos, torch.Tensor)
           else torch.full((b,), int(pos), dtype=torch.int32,
                           device=token.device))
    live = (pos >= 0)[:, None, None]
    h = embed(params, cfg, token[:, None])
    for layer in range(cfg.n_layers):
        cs, hs = cache["conv"][layer], cache["h"][layer]
        h, cs_new, hs_new = mamba_block_step(layer_params(params, layer), h,
                                             cs, hs, cfg, mode, path=path)
        cs.copy_(torch.where(live, cs_new, cs))
        hs.copy_(torch.where(live, hs_new, hs))
    return head(params, cfg, h)[:, 0], cache


def mamba_prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        cache: dict, slot: int, pos: int, n_valid: int, *,
                        path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Advance one slot's prefill by one fixed-shape chunk: the slot's state
    advances by `n_valid` real tokens (pads are masked out of the
    recurrence). tokens: (1, C) int, right-padded; slot, pos (tokens already
    consumed) and n_valid are host ints. pos == 0 is the first chunk: the
    slot's (recycled, stale) state is zeroed first. Returns (logits (1, V)
    at the chunk's last real token, the state, updated in place)."""
    _check_served(cfg)
    if not 1 <= n_valid <= tokens.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside 1..{tokens.shape[1]}")
    if pos < 0:
        raise ValueError(f"pos={pos} < 0")
    mode = QuantMode(cfg.quant)
    if pos == 0:
        cache["conv"][:, slot].zero_()
        cache["h"][:, slot].zero_()
    h = embed(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        cs = cache["conv"][layer, slot:slot + 1]
        hs = cache["h"][layer, slot:slot + 1]
        h, cs_new, hs_new = mamba_block_chunk(layer_params(params, layer), h,
                                              cs, hs, n_valid, cfg, mode,
                                              path=path)
        cs.copy_(cs_new)
        hs.copy_(hs_new)
    return head(params, cfg, h[:, n_valid - 1:n_valid])[:, 0], cache


def _whole_sequence(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    path: str, states: list | None = None) -> torch.Tensor:
    """Every block over tokens (B, S) from zero state (the chunk block with
    all S rows real); appends each layer's (conv, h) state to `states`.
    Returns the residual stream (B, S, D)."""
    mode = QuantMode(cfg.quant)
    b = tokens.shape[0]
    di = cfg.expand * cfg.d_model
    conv0 = torch.zeros((b, cfg.d_conv - 1, di), dtype=cfg.activation_dtype,
                        device=tokens.device)
    h = embed(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        h, cs, hs = mamba_block_chunk(layer_params(params, layer), h, conv0,
                                      None, tokens.shape[1], cfg, mode,
                                      path=path)
        if states is not None:
            states.append((cs, hs))
    return h


def mamba_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  cache: dict | None = None, slot: int = 0,
                  path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Run whole prompts tokens (B, S) from zero state; their final conv and
    SSM states land in state rows [slot, slot + B) of `cache` (None: a new
    state of B rows, as the JAX package returns one), in place. Returns
    (logits (B, V) at the last position, the state)."""
    _check_served(cfg)
    b = tokens.shape[0]
    if cache is None:
        cache = mamba_init_state(cfg, b, device=tokens.device)
    if slot < 0 or slot + b > cache["h"].shape[1]:
        raise ValueError(f"slots [{slot}, {slot + b}) outside the state's "
                         f"{cache['h'].shape[1]}")
    states: list = []
    h = _whole_sequence(params, cfg, tokens, path, states)
    for layer, (cs, hs) in enumerate(states):
        cache["conv"][layer, slot:slot + b] = cs
        cache["h"][layer, slot:slot + b] = hs
    return head(params, cfg, h[:, -1:])[:, 0], cache


def mamba_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                 train: bool = False, gen: torch.Generator | None = None,
                 noise: dict | None = None, shard: BatchShard | None = None,
                 path: str = "auto"
                 ) -> tuple[torch.Tensor, dict]:
    """The forward over whole sequences: tokens (B, S) -> (logits (B, S, V),
    {}). train=True: the training forward of fp32 masters (the module
    doc)."""
    _check_served(cfg)
    if not train:
        return head(params, cfg, _whole_sequence(params, cfg, tokens,
                                                 path)), {}
    mode, draws = QuantMode(cfg.quant), Draws(True, gen, noise, shard)
    h = embed(params, cfg, tokens)
    for layer, bp in enumerate(unstack(params["blocks"])):
        h = remat(cfg, draws, lambda x, bp=bp, layer=layer: mamba_block_train(
            bp, x, cfg, mode, draws, site=f"blocks.{layer}.", path=path), h)
    return head(params, cfg, h), {}


def mamba_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               gen: torch.Generator | None = None, noise: dict | None = None,
               shard: BatchShard | None = None,
               path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of the training forward; (loss, {"nll"})."""
    logits, _ = mamba_logits(params, cfg, batch["tokens"], train=True,
                             gen=gen, noise=noise, shard=shard, path=path)
    nll = next_token_nll(logits, batch["tokens"])
    return nll, {"nll": nll}


# ===========================================================================
# recurrentgemma-2b (Griffin): groups of (rec, rec, local-attn), each layer
# followed by a GeGLU MLP sublayer; a tail of leftover rec layers
# ===========================================================================
def _check_hybrid(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name} is {cfg.family}, not the hybrid")
    if cfg.norm != "rmsnorm" or cfg.pos != "rope" or cfg.qkv_bias:
        raise NotImplementedError("the port serves rmsnorm + rope without "
                                  "qkv bias (ROADMAP Queue A)")
    if cfg.kv_bits not in (0, 1):
        raise ValueError(f"kv_bits must be 0 or 1, got {cfg.kv_bits}")


def rg_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_tail_rec): groups of the repeating pattern, and the
    leftover recurrent layers."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    n_groups = cfg.n_layers // len(pat)
    return n_groups, cfg.n_layers - n_groups * len(pat)


def _n_rec(cfg: ModelConfig) -> int:
    """Rec layers per group (each group runs them, then its attention)."""
    return sum(1 for p in (cfg.block_pattern or ("rec", "rec", "attn"))
               if p == "rec")


def _rg_layer_shapes(cfg: ModelConfig, kind: str) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {"ln2": {"scale": (d,)},
         "ffn": ffn_param_shapes(d, cfg.d_ff, cfg.mlp)}
    if kind == "rec":
        s["mix"] = rglru_block_shapes(cfg)
    else:
        s["mix"] = {"ln1": {"scale": (d,)},
                    "attn": {"wq": (d, h * hd), "wk": (d, kv * hd),
                             "wv": (d, kv * hd), "wo": (h * hd, d)}}
    return s


def init_rg_params(gen: torch.Generator, cfg: ModelConfig, *, device=None,
                   freeze_layer=None) -> dict:
    """fp32 masters with the JAX package's shapes and init rules (matrices
    N(0, 0.02^2), vectors zeros; the embedding, also the head when tied,
    N(0, 0.02^2); final norm scale 0). Draws come from `gen`, on its
    device.

    `freeze_layer`, when given, maps one layer's tree (leading axis 1) to
    its frozen tree, and each layer is drawn and frozen before the next, as
    in `init_mamba_params`; the weights follow the same distribution as
    freezing the whole tree, not the same draws."""
    _check_hybrid(cfg)
    dev = resolve_device(device)
    g, tail = rg_layout(cfg)
    n_rec = _n_rec(cfg)

    def normal(shape):
        return (torch.randn(shape, generator=gen,
                            device=draw_device(gen, dev))
                * 0.02).to(dev)

    def init(shapes, prefix):
        if isinstance(shapes, dict):
            return {k: init(v, prefix) for k, v in shapes.items()}
        full = prefix + shapes
        return normal(full) if len(shapes) >= 2 else \
            torch.zeros(full, dtype=torch.float32, device=dev)

    rec, attn = _rg_layer_shapes(cfg, "rec"), _rg_layer_shapes(cfg, "attn")
    params = {"embed": normal((cfg.vocab, cfg.d_model)),
              "final_norm": {"scale": torch.zeros(cfg.d_model, device=dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab))
    if freeze_layer is None:
        params["groups"] = {"rec": init(rec, (g, n_rec)),
                            "attn": init(attn, (g,))}
        if tail:
            params["tail"] = init(rec, (tail,))
        return params

    def layers(shapes, n):
        return stack_layers([freeze_layer(init(shapes, (1,)))
                              for _ in range(n)])

    params["groups"] = {
        "rec": stack_layers([pick(layers(rec, n_rec), None)
                              for _ in range(g)]),
        "attn": layers(attn, g)}
    if tail:
        params["tail"] = layers(rec, tail)
    return params


def rg_init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """Zeroed state of `batch` slots: each rec layer's conv history
    ("rec_conv" (g, n_rec, B, K-1, W) and "tail_conv" (tail, B, K-1, W), in
    the activation dtype) and h ("rec_h", "tail_h", float32), and each
    attention layer's ring of `local_window` rows, "attn_k" / "attn_v" (g,
    B, window, Hkv, hd) in the activation dtype (kv_bits=0) or (..., Hkv,
    ceil(hd/32)) int32 sign words (kv_bits=1, with "attn_v_scale" (g, B,
    Hkv) float32)."""
    _check_hybrid(cfg)
    dev = resolve_device(device)
    g, tail = rg_layout(cfg)
    n_rec = _n_rec(cfg)
    w = cfg.lru_width or cfg.d_model
    packed = cfg.kv_bits == 1
    kvdt = torch.int32 if packed else cfg.activation_dtype
    hd = packed_width(cfg.head_dim) if packed else cfg.head_dim
    act = dict(dtype=cfg.activation_dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ring = (g, batch, cfg.local_window, cfg.n_kv_heads, hd)
    state = {
        "rec_conv": torch.zeros((g, n_rec, batch, cfg.d_conv - 1, w), **act),
        "rec_h": torch.zeros((g, n_rec, batch, w), **f32),
        "attn_k": torch.zeros(ring, dtype=kvdt, device=dev),
        "attn_v": torch.zeros(ring, dtype=kvdt, device=dev),
        "tail_conv": torch.zeros((tail, batch, cfg.d_conv - 1, w), **act),
        "tail_h": torch.zeros((tail, batch, w), **f32),
    }
    if packed:
        state["attn_v_scale"] = torch.zeros((g, batch, cfg.n_kv_heads),
                                            **f32)
    return state


def _rg_rec(lp: dict, h: torch.Tensor, cfg: ModelConfig, mode: QuantMode,
            path: str):
    """A rec layer over whole sequences from zero state: (y, (conv, h))."""
    h, state = rglru_block(lp["mix"], h, cfg, mode, path=path)
    return ffn_sublayer(lp, h, cfg, mode, path=path), state


def _rg_whole(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
              path: str, cache: dict | None = None, slot: int = 0
              ) -> torch.Tensor:
    """Every layer over tokens (B, S) from zero state, attention the float
    flash attention with the window (the JAX package's `_rg_attn_mix`).
    With `cache`, each layer's final state lands in state rows [slot, slot
    + B): conv and h, and the slot's whole ring (its last min(S, W)
    positions at t % W, the rest zeros, as the JAX package's `ring_pack`),
    packed at kv_bits=1 by one launch of kernel 5 per layer with the V
    scale `v_cache_scale` over all S positions. Returns the residual
    stream (B, S, D)."""
    mode = QuantMode(cfg.quant)
    g, tail = rg_layout(cfg)
    b, s = tokens.shape
    wnd = cfg.local_window
    if cache is not None:
        sl = slice(slot, slot + b)
        w_eff = min(s, wnd)
        ring = torch.arange(s - w_eff, s, device=tokens.device) % wnd
        cache["attn_k"][:, sl].zero_()
        cache["attn_v"][:, sl].zero_()
        if cfg.kv_bits == 1:
            rows = ((torch.arange(b, device=tokens.device)[:, None] + slot)
                    * wnd + ring[None]).reshape(-1)
    h = embed(params, cfg, tokens)
    for gi in range(g):
        for j in range(_n_rec(cfg)):
            h, (cs, hs) = _rg_rec(pick(params["groups"]["rec"], gi, j), h,
                                  cfg, mode, path)
            if cache is not None:
                cache["rec_conv"][gi, j, sl] = cs
                cache["rec_h"][gi, j, sl] = hs
        lp = pick(params["groups"]["attn"], gi)
        h, (k, v) = self_attn(lp["mix"], h, cfg, mode, path=path,
                              return_kv=True)
        if cache is not None:
            kc, vc = cache["attn_k"][gi], cache["attn_v"][gi]
            if cfg.kv_bits == 1:      # the scale is over all S positions
                cache["attn_v_scale"][gi, sl] = v_cache_scale(v)
            k, v = k[:, s - w_eff:], v[:, s - w_eff:]
            if cfg.kv_bits == 1:
                pack_into(path, (k.flatten(0, 1).contiguous(),
                                  v.flatten(0, 1).contiguous()),
                          (kc, vc), rows)
            else:
                kc[sl, ring] = k.to(kc.dtype)
                vc[sl, ring] = v.to(vc.dtype)
        h = ffn_sublayer(lp, h, cfg, mode, path=path)
    for j in range(tail):
        h, (cs, hs) = _rg_rec(pick(params["tail"], j), h, cfg, mode, path)
        if cache is not None:
            cache["tail_conv"][j, sl] = cs
            cache["tail_h"][j, sl] = hs
    return h


def rg_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               cache: dict | None = None, slot: int = 0, path: str = "auto"
               ) -> tuple[torch.Tensor, dict]:
    """Run whole prompts tokens (B, S) from zero state; every layer's final
    state, and each attention layer's whole ring, land in state rows
    [slot, slot + B) of `cache` (None: a new state of B rows, as the JAX
    package returns one), in place. Returns (logits (B, V) at the last
    position, the state)."""
    _check_hybrid(cfg)
    b = tokens.shape[0]
    if cache is None:
        cache = rg_init_state(cfg, b, device=tokens.device)
    if slot < 0 or slot + b > cache["attn_k"].shape[1]:
        raise ValueError(f"slots [{slot}, {slot + b}) outside the state's "
                         f"{cache['attn_k'].shape[1]}")
    h = _rg_whole(params, cfg, tokens, path, cache, slot)
    return head(params, cfg, h[:, -1:])[:, 0], cache


def rg_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
              train: bool = False, gen: torch.Generator | None = None,
              noise: dict | None = None, shard: BatchShard | None = None,
              path: str = "auto"
              ) -> tuple[torch.Tensor, dict]:
    """The forward over whole sequences: tokens (B, S) -> (logits (B, S, V),
    {}). train=True: the training forward of fp32 masters (the module
    doc): each group's rec layers, then its local attention (the float
    flash attention with the window), each followed by its MLP."""
    _check_hybrid(cfg)
    if not train:
        return head(params, cfg, _rg_whole(params, cfg, tokens, path)), {}
    mode, draws = QuantMode(cfg.quant), Draws(True, gen, noise, shard)

    def rec(lp, site, h):
        h, _ = rglru_block(lp["mix"], h, cfg, mode, path=path, draws=draws,
                           site=f"{site}mix.")
        return ffn_sublayer(lp, h, cfg, mode, path=path, draws=draws,
                            site=site)

    def group(recs, ap, gi, h):
        for j, lp in enumerate(recs):
            h = rec(lp, f"groups.{gi}.rec.{j}.", h)
        site = f"groups.{gi}.attn."
        h = self_attn(ap["mix"], h, cfg, mode, path=path, draws=draws,
                      site=f"{site}mix.")
        return ffn_sublayer(ap, h, cfg, mode, path=path, draws=draws,
                            site=site)

    h = embed(params, cfg, tokens)
    recs = [unstack(g) for g in unstack(params["groups"]["rec"])]
    for gi, (rs, ap) in enumerate(zip(recs,
                                      unstack(params["groups"]["attn"]))):
        h = remat(cfg, draws, lambda x, rs=rs, ap=ap, gi=gi:
                  group(rs, ap, gi, x), h)
    if "tail" in params:
        for j, lp in enumerate(unstack(params["tail"])):
            h = remat(cfg, draws, lambda x, lp=lp, j=j:
                      rec(lp, f"tail.{j}.", x), h)
    return head(params, cfg, h), {}


def rg_loss(params: dict, cfg: ModelConfig, batch: dict, *,
            gen: torch.Generator | None = None, noise: dict | None = None,
            shard: BatchShard | None = None,
            path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of the training forward; (loss, {"nll"})."""
    logits, _ = rg_logits(params, cfg, batch["tokens"], train=True, gen=gen,
                          noise=noise, shard=shard, path=path)
    nll = next_token_nll(logits, batch["tokens"])
    return nll, {"nll": nll}


def _rg_rec_step(lp, h, cs, hs, live, cfg, mode, path):
    """A rec layer's decode step from its state (cs (B, K-1, W), hs (B, W)),
    updated in place; rows not `live` keep theirs."""
    h, cs_new, hs_new = rglru_block_step(lp["mix"], h, cs, hs, cfg, mode,
                                         path=path)
    cs.copy_(torch.where(live[:, None, None], cs_new, cs))
    hs.copy_(torch.where(live[:, None], hs_new, hs))
    return ffn_sublayer(lp, h, cfg, mode, path=path)


def _rg_attn_step(lp, h, kc, vc, vsc, cfg, mode, pos, live, rows, cache_len,
                  path):
    """A local-attention layer's decode step against its ring. h: (B, 1,
    D); kc/vc: the layer's (B, W, Hkv, w) ring; vsc: (B, Hkv) or None; pos:
    (B,) int32 positions (< 0: inactive, writes nothing); rows: (B,) int64
    ring rows of the (B*W, Hkv, w) view for kernel 5 (-1 when inactive);
    cache_len: (B,) valid ring rows.
    kv_bits=1: the new K/V rows are packed into their ring rows (kernel 5)
    and the query attends through kernel 6; kv_bits=0 the float
    `decode_attention` (the JAX package's jnp)."""
    b = h.shape[0]
    ap = lp["mix"]["attn"]
    xn = rms_norm(h, lp["mix"]["ln1"]["scale"])
    q, k, v = qkv(ap, xn, cfg, mode, path)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    if cfg.kv_bits == 1:
        pack_into(path, (k[:, 0], v[:, 0]), (kc, vc), rows)
        attend = decode_attention_packed if path == "auto" \
            else decode_attention_packed_plain
        out = attend(q, kc, vc, vsc, cache_len)
    else:
        # an inactive row rewrites its own old values (no host sync)
        bi = torch.arange(b, device=h.device)
        idx = pos.clamp(min=0).long() % kc.shape[1]
        act = live[:, None, None]
        for c, x in zip((kc, vc), (k[:, 0], v[:, 0])):
            c[bi, idx] = torch.where(act, x.to(c.dtype), c[bi, idx])
        out = decode_attention(q, kc, vc, cache_len)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return h + qmatmul(out, ap["wo"], mode, path=path)


def rg_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
              cache: dict, pos, *, path: str = "auto"
              ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B,) int; pos: int or (B,) int32 tensor,
    each row's position: it writes ring slot pos % W and attends over its
    min(pos + 1, W) valid ring rows. pos < 0 marks a row inactive: it
    computes but writes no ring row and no recurrent state. The V scale is
    not updated (the JAX package's decode keeps it). Returns (logits (B,
    V), the state, updated in place)."""
    _check_hybrid(cfg)
    mode = QuantMode(cfg.quant)
    g, tail = rg_layout(cfg)
    b = token.shape[0]
    dev = token.device
    wnd = cfg.local_window
    pos = (pos.to(torch.int32) if isinstance(pos, torch.Tensor)
           else torch.full((b,), int(pos), dtype=torch.int32, device=dev))
    live = pos >= 0
    rows = torch.where(live, torch.arange(b, device=dev) * wnd
                       + pos.long() % wnd, -1)
    cache_len = torch.where(live, torch.clamp_max(pos + 1, wnd), 0) \
        .to(torch.int32)
    vs = cache.get("attn_v_scale")
    h = embed(params, cfg, token[:, None])
    for gi in range(g):
        for j in range(_n_rec(cfg)):
            h = _rg_rec_step(pick(params["groups"]["rec"], gi, j), h,
                             cache["rec_conv"][gi, j], cache["rec_h"][gi, j],
                             live, cfg, mode, path)
        lp = pick(params["groups"]["attn"], gi)
        h = _rg_attn_step(lp, h, cache["attn_k"][gi], cache["attn_v"][gi],
                          None if vs is None else vs[gi], cfg, mode, pos,
                          live, rows, cache_len, path)
        h = ffn_sublayer(lp, h, cfg, mode, path=path)
    for j in range(tail):
        h = _rg_rec_step(pick(params["tail"], j), h, cache["tail_conv"][j],
                         cache["tail_h"][j], live, cfg, mode, path)
    return head(params, cfg, h)[:, 0], cache


def _rg_attn_chunk(lp, h, kc, vc, vsc, cfg, mode, positions, pos, n_valid,
                   valid, ring_idx, path):
    """A local-attention layer over one prefill chunk against the slot's
    ring. h: (1, C, D); kc/vc: the slot's (1, W, Hkv, w) ring; vsc: its (1,
    Hkv) V scale or None; valid: (1, C, W + C) validity of the ring rows
    and the chunk's own rows (`_chunk_geometry`); ring_idx: (W,) the row
    of [ring | chunk] each ring slot holds after the chunk. The chunk's
    K/V rows ride after the ring (packed by one launch of kernel 5 at
    kv_bits=1, where the V scale becomes the running mean over [0, pos +
    n_valid)); the chunk attends over both with the JAX package's jnp
    cores in plain PyTorch; then the ring advances by one gather ('later
    wins': slot j takes the latest real chunk row at a position = j mod
    W, else keeps its row)."""
    c = h.shape[1]
    wnd = kc.shape[1]
    ap = lp["mix"]["attn"]
    xn = rms_norm(h, lp["mix"]["ln1"]["scale"])
    q, k, v = qkv(ap, xn, cfg, mode, path)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.kv_bits == 1:
        kb = torch.empty((1, wnd + c) + tuple(kc.shape[2:]), dtype=kc.dtype,
                         device=kc.device)
        vb = torch.empty_like(kb)
        kb[:, :wnd], vb[:, :wnd] = kc, vc
        pack_into(path, (k[0], v[0]), (kb, vb),
                  torch.arange(wnd, wnd + c, device=h.device))
        absm = v[0].to(torch.float32).abs().mean(dim=-1)       # (C, Hkv)
        msk = (torch.arange(c, device=h.device) < n_valid)[:, None]
        vsc.copy_((vsc * float(pos) + (absm * msk).sum(dim=0)[None])
                  / float(pos + n_valid))
        out = packed_masked_attention_ref(q, kb, vb, vsc, valid)
    else:
        kb = torch.cat([kc, k.to(kc.dtype)], dim=1)
        vb = torch.cat([vc, v.to(vc.dtype)], dim=1)
        out = masked_chunk_attention(q, kb, vb, valid)
    out = out.reshape(1, c, cfg.n_heads * cfg.head_dim)
    h = h + qmatmul(out, ap["wo"], mode, path=path)
    kc.copy_(kb[:, ring_idx])
    vc.copy_(vb[:, ring_idx])
    return h


def _chunk_geometry(wnd: int, c: int, pos: int, n_valid: int, device):
    """For a chunk of C rows at positions pos.. (n_valid real) against a
    ring of W rows: the (1, C, W + C) validity of [ring | chunk] rows (ring
    slot j holds position pos-1 - ((pos-1-j) mod W), real when >= 0 and
    pos > 0; causal; within the window), and the (W,) gather index of the
    advanced ring: W + i for the latest real chunk row i with (pos + i) mod
    W = j, else j."""
    j = torch.arange(wnd, device=device)
    i = torch.arange(c, device=device)
    positions = i + pos
    t_ring = pos - 1 - (pos - 1 - j) % wnd
    kpos = torch.cat([t_ring, positions])
    kvalid = torch.cat([(t_ring >= 0) & (pos > 0), i < n_valid])
    valid = (kvalid[None] & (kpos[None] <= positions[:, None])
             & (kpos[None] > positions[:, None] - wnd))[None]
    i0 = (j - pos) % wnd
    istar = (i0 + torch.div(n_valid - 1 - i0, wnd, rounding_mode="floor")
             * wnd).clamp(0, c - 1)
    return valid, torch.where(i0 < n_valid, wnd + istar, j)


def rg_prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     cache: dict, slot: int, pos: int, n_valid: int, *,
                     path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Advance one slot's prefill by one fixed-shape chunk: its rec states
    advance by `n_valid` real tokens (pads are masked out of the
    recurrence) and each attention layer's ring by the chunk. tokens: (1,
    C) int, right-padded; slot, pos (tokens already consumed) and n_valid
    are host ints. pos == 0 is the first chunk: the slot's (recycled,
    stale) recurrent state is zeroed first (ring rows are masked by
    position and need no reset). Returns (logits (1, V) at the chunk's last
    real token, the state, updated in place)."""
    _check_hybrid(cfg)
    if not 1 <= n_valid <= tokens.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside 1..{tokens.shape[1]}")
    if pos < 0:
        raise ValueError(f"pos={pos} < 0")
    mode = QuantMode(cfg.quant)
    g, tail = rg_layout(cfg)
    c = tokens.shape[1]
    dev = tokens.device
    if pos == 0:
        for name in ("rec_conv", "rec_h"):
            cache[name][:, :, slot].zero_()
        for name in ("tail_conv", "tail_h"):
            cache[name][:, slot].zero_()
    positions = torch.arange(c, device=dev) + pos
    valid, ring_idx = _chunk_geometry(cfg.local_window, c, pos, n_valid, dev)
    vs = cache.get("attn_v_scale")
    sl = slice(slot, slot + 1)

    def rec(lp, h, cs, hs):
        h, cs_new, hs_new = rglru_block_chunk(lp["mix"], h, cs, hs, n_valid,
                                              cfg, mode, path=path)
        cs.copy_(cs_new)
        hs.copy_(hs_new)
        return ffn_sublayer(lp, h, cfg, mode, path=path)

    h = embed(params, cfg, tokens)
    for gi in range(g):
        for j in range(_n_rec(cfg)):
            h = rec(pick(params["groups"]["rec"], gi, j), h,
                    cache["rec_conv"][gi, j, sl], cache["rec_h"][gi, j, sl])
        lp = pick(params["groups"]["attn"], gi)
        h = _rg_attn_chunk(lp, h, cache["attn_k"][gi, sl],
                           cache["attn_v"][gi, sl],
                           None if vs is None else vs[gi, sl], cfg, mode,
                           positions, pos, n_valid, valid, ring_idx, path)
        h = ffn_sublayer(lp, h, cfg, mode, path=path)
    for j in range(tail):
        h = rec(pick(params["tail"], j), h, cache["tail_conv"][j, sl],
                cache["tail_h"][j, sl])
    return head(params, cfg, h[:, n_valid - 1:n_valid])[:, 0], cache
