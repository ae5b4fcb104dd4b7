"""Family-dispatching model API used by the serving engine (port of
`repro.models.api`: the transformer families dense, moe, audio and vlm,
the Mamba stack, `ssm`, and the recurrentgemma hybrid, `hybrid`).

    model = get_model(cfg)
    params = model.init(gen)                 # fp32 masters
    frozen = model.freeze(params)            # 1-bit PackedWeights
    frozen = model.init_frozen(gen)          # the same, one layer at a time
    loss, metrics = model.loss(params, batch, gen=gen)   # train forward
    logits, aux = model.logits(params, tokens)           # (B, S, V)
    cache = model.init_cache(slots, max_len)            # contiguous
    cache = model.init_cache(slots, max_len, page_size=P)   # paged (dense)
    logits, cache = model.prefill(params, tokens, max_len=T)     # new cache
    logits, cache = model.prefill(params, tokens, cache=c, slot=s)  # in place
    logits, cache = model.prefill_chunk(params, tokens, cache, slot, pos, n)
    logits, cache = model.decode(params, token, cache, pos)

The vlm family's `logits` and `prefill` also take `img_emb=` (B,
n_img_tokens, d_vision), and its `prefill_chunk` takes one with a
request's first chunk (`models.transformer`).

`path` ('auto' | 'ref'), passed to get_model, picks the kernels or their
plain versions for every call of the model (see `models.transformer`).

`loss(params, batch, gen=None, noise=None, shard=None)` is the training
loss of fp32 masters (`transformer_loss`, `mamba_loss` or `rg_loss`):
batch {"tokens" (B, S), vlm "img_emb"}; `gen` draws the stochastic
binarization of mode 'bbp' (the train step passes one only in that mode,
as the JAX package passes a key), `noise` feeds the draws by site, and
`shard` (a `core.layers.BatchShard`) makes it one data-parallel shard's
forward over its rows of a global batch. A frozen tree raises
ValueError: 1-bit packed weights are inference only.

The `ssm` family's "cache" is its recurrent state ({"conv", "h"},
`models.ssm_lm`), O(1) per slot, and the `hybrid` family's its recurrent
state and a ring of `local_window` K/V rows per attention layer: for both,
`init_cache` and `prefill` take and ignore `max_len` and the paging
arguments, as the JAX package's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import (
    PackedWeight, attach_ffn_act_thresholds, freeze_params, params_frozen,
)
from repro_torch.optim.base import tree_leaves
from repro_torch.models import ssm_lm as S
from repro_torch.models import transformer as T

# families whose cache is a KV cache (paging, the prefix cache and the V
# scale apply to them only); the rest carry O(1) recurrent state per slot
# (the hybrid also a fixed ring of K/V rows, never paged)
ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    # loss(params, batch, *, gen=None, noise=None, shard=None) -> (loss,
    # metrics): the training loss of fp32 masters
    loss: Callable[..., tuple[torch.Tensor, dict]]
    # logits(params, tokens (B, S)) -> (logits (B, S, V), aux): the
    # inference forward
    logits: Callable[..., tuple[torch.Tensor, dict]]
    # prefill(params, tokens (B, S), *, max_len=None, cache=None, slot=0)
    # -> (logits (B, V), cache): whole prompts into cache rows [slot,
    # slot + B), in place, or into a new cache when none is given
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]
    # prefill_chunk(params, tokens (1, C), cache, slot, pos, n_valid) ->
    # (logits (1, V), cache): advance one slot of the shared slot cache by
    # one fixed-shape prompt chunk (the chunked-admission primitive)
    prefill_chunk: Callable[..., tuple[torch.Tensor, Any]]

    def freeze(self, params):
        """Freeze fp32 masters to 1-bit packed weights (inference only),
        and cast the LM head to the activation dtype once: `head` casts
        it on every call otherwise (a 2 GB read per step at full width),
        and the product is the same. A tied head is the embedding: it is
        cast once too (a cast commutes with the lookup's gather). A
        sq_relu FFN also gets its activation fold, so it serves
        bit-resident (`models.common.ffn`), as the JAX package's does; an
        sq_relu MoE's experts get it too, and `moe_ffn` ignores it, as
        there. A MoE's router stays float32."""
        self._check_freezable()
        return self._cast_head(self._freeze_tree(params))

    def init_frozen(self, gen: torch.Generator, device=None):
        """Frozen params drawn and frozen one layer at a time, so that only
        one layer's fp32 masters are ever resident: what `freeze(init(gen))`
        gives (same shapes, same distribution, other draws) for a model
        whose masters do not fit on the device."""
        self._check_freezable()
        init = {"ssm": S.init_mamba_params, "hybrid": S.init_rg_params} \
            .get(self.cfg.family, T.init_transformer_params)
        return self._cast_head(init(gen, self.cfg, device=device,
                                    freeze_layer=self._freeze_tree))

    def _freeze_tree(self, params):
        frozen = freeze_params(params)
        if self.cfg.mlp == "sq_relu":
            frozen = attach_ffn_act_thresholds(frozen, "sq_relu")
        return frozen

    def _check_freezable(self) -> None:
        if self.cfg.quant == "none":
            raise ValueError(f"{self.cfg.name}: quant='none' has no binary "
                             "weights to freeze")

    def _cast_head(self, frozen):
        head = "embed" if self.cfg.tie_embeddings else "lm_head"
        if head in frozen:
            frozen[head] = frozen[head].to(self.cfg.activation_dtype)
        return frozen


def _guard_trainable(params, fn, *args, **kw):
    if params_frozen(params):
        raise ValueError("params are frozen to packed 1-bit form — "
                         "inference only; restore the fp32 masters to train")
    return fn(params, *args, **kw)


def param_count(params) -> int:
    """Elements of every leaf, as the JAX package counts them: a
    PackedWeight's words, thresholds and flips."""
    def numel(p):
        if isinstance(p, PackedWeight):
            return sum(t.numel() for t in (p.packed, p.thresh, p.flip)
                       if t is not None)
        return p.numel()
    return sum(int(numel(p)) for p in tree_leaves(params))


def get_model(cfg: ModelConfig, *, path: str = "auto") -> Model:
    if path not in ("auto", "ref"):
        raise ValueError(path)
    loss_fn = {"ssm": S.mamba_loss, "hybrid": S.rg_loss}.get(
        cfg.family, T.transformer_loss)

    def loss(p, batch, gen=None, noise=None, shard=None):
        return _guard_trainable(p, loss_fn, cfg, batch, gen=gen, noise=noise,
                                shard=shard, path=path)
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: S.init_mamba_params(
                gen, cfg, device=device),
            loss=loss,
            logits=lambda p, tokens: S.mamba_logits(p, cfg, tokens,
                                                    path=path),
            prefill=lambda p, tokens, max_len=None, cache=None, slot=0:
                S.mamba_prefill(p, cfg, tokens, cache=cache, slot=slot,
                                path=path),
            decode=lambda p, token, cache, pos: S.mamba_decode(
                p, cfg, token, cache, pos, path=path),
            init_cache=lambda batch, max_len, device=None, **kw:
                S.mamba_init_state(cfg, batch, device=device),
            prefill_chunk=lambda p, tokens, cache, slot, pos, n_valid:
                S.mamba_prefill_chunk(p, cfg, tokens, cache, slot, pos,
                                      n_valid, path=path),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: S.init_rg_params(
                gen, cfg, device=device),
            loss=loss,
            logits=lambda p, tokens: S.rg_logits(p, cfg, tokens, path=path),
            prefill=lambda p, tokens, max_len=None, cache=None, slot=0:
                S.rg_prefill(p, cfg, tokens, cache=cache, slot=slot,
                             path=path),
            decode=lambda p, token, cache, pos: S.rg_decode(
                p, cfg, token, cache, pos, path=path),
            init_cache=lambda batch, max_len, device=None, **kw:
                S.rg_init_state(cfg, batch, device=device),
            prefill_chunk=lambda p, tokens, cache, slot, pos, n_valid:
                S.rg_prefill_chunk(p, cfg, tokens, cache, slot, pos,
                                   n_valid, path=path),
        )
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: T.init_transformer_params(
            gen, cfg, device=device),
        loss=loss,
        logits=lambda p, tokens, img_emb=None: T.transformer_logits(
            p, cfg, tokens, img_emb=img_emb, path=path),
        prefill=lambda p, tokens, max_len=None, cache=None, slot=0,
        img_emb=None, shard=None: T.transformer_prefill(
            p, cfg, tokens, img_emb=img_emb, max_len=max_len, cache=cache,
            slot=slot, path=path, shard=shard),
        decode=lambda p, token, cache, pos, shard=None: T.transformer_decode(
            p, cfg, token, cache, pos, path=path, shard=shard),
        init_cache=lambda batch, max_len, device=None, **kw: T.init_cache(
            cfg, batch, max_len, device=device, **kw),
        prefill_chunk=lambda p, tokens, cache, slot, pos, n_valid,
        img_emb=None: T.transformer_prefill_chunk(
            p, cfg, tokens, cache, slot, pos, n_valid, img_emb=img_emb,
            path=path),
    )


# marker for cache leaves with no per-slot batch axis: the K/V page pools of
# a paged cache, shared by every slot and addressed through the page table
PAGED = "paged"


def cache_batch_axes(model: Model, max_len: int, **cache_kw) -> dict:
    """Which axis of each cache leaf is the batch (slot) axis: the one axis
    on which a 1-slot and a 2-slot cache disagree (shapes only, on the meta
    device). `cache_kw` passes the paged layout's page_size / pool_pages;
    the pools' shapes do not depend on the slot count (the probe pins
    pool_pages), so they get `PAGED` instead of an axis."""
    if cache_kw.get("page_size") is not None:
        cache_kw = dict(cache_kw, pool_pages=cache_kw.get("pool_pages") or 8)
    c1 = model.init_cache(1, max_len, device="meta", **cache_kw)
    c2 = model.init_cache(2, max_len, device="meta", **cache_kw)
    out = {}
    for name in c1:
        diff = [i for i, (x, y) in enumerate(zip(c1[name].shape,
                                                 c2[name].shape)) if x != y]
        assert len(diff) <= 1, f"ambiguous batch axis of {name}"
        out[name] = diff[0] if diff else PAGED
    return out
