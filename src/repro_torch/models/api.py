"""Family-dispatching model API used by the serving engine (port of
`repro.models.api` for the dense family).

    model = get_model(cfg)
    params = model.init(gen)                 # fp32 masters
    frozen = model.freeze(params)            # 1-bit PackedWeights
    frozen = model.init_frozen(gen)          # the same, one layer at a time
    cache = model.init_cache(slots, max_len)
    logits, cache = model.prefill_chunk(params, tokens, cache, slot, pos, n)
    logits, cache = model.decode(params, token, cache, pos)

`path` ('auto' | 'ref'), passed to get_model, picks the kernels or their
plain versions for every call of the model (see `models.transformer`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import freeze_params
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]
    # prefill_chunk(params, tokens (1, C), cache, slot, pos, n_valid) ->
    # (logits (1, V), cache): advance one slot of the shared slot cache by
    # one fixed-shape prompt chunk (the chunked-admission primitive)
    prefill_chunk: Callable[..., tuple[torch.Tensor, Any]]

    def freeze(self, params):
        """Freeze fp32 masters to 1-bit packed weights (inference only),
        and cast the LM head to the activation dtype once: `_head` casts
        it on every call otherwise (a 2 GB read per step at full width),
        and the product is the same."""
        self._check_freezable()
        return self._cast_head(freeze_params(params))

    def init_frozen(self, gen: torch.Generator, device=None):
        """Frozen params drawn and frozen one layer at a time, so that only
        one layer's fp32 masters are ever resident: what `freeze(init(gen))`
        gives (same shapes, same distribution, other draws) for a model
        whose masters do not fit on the device."""
        self._check_freezable()
        return self._cast_head(T.init_transformer_params(
            gen, self.cfg, device=device, freeze_layer=freeze_params))

    def _check_freezable(self) -> None:
        if self.cfg.quant == "none":
            raise ValueError(f"{self.cfg.name}: quant='none' has no binary "
                             "weights to freeze")
        if self.cfg.mlp == "sq_relu":
            raise NotImplementedError("the sq_relu fold is not ported yet "
                                      "(ROADMAP Queue A)")

    def _cast_head(self, frozen):
        if "lm_head" in frozen:
            frozen["lm_head"] = frozen["lm_head"].to(self.cfg.activation_dtype)
        return frozen


def _whole_prompt(*args, **kwargs):
    raise NotImplementedError("whole-prompt prefill (float flash attention) "
                              "comes with the next slice (ROADMAP Queue A); "
                              "admit through prefill_chunk")


def get_model(cfg: ModelConfig, *, path: str = "auto") -> Model:
    if path not in ("auto", "ref"):
        raise ValueError(path)
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} family is not ported yet "
                                  "(ROADMAP Queue A)")
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: T.init_transformer_params(
            gen, cfg, device=device),
        prefill=_whole_prompt,
        decode=lambda p, token, cache, pos: T.transformer_decode(
            p, cfg, token, cache, pos, path=path),
        init_cache=lambda batch, max_len, device=None, **kw: T.init_cache(
            cfg, batch, max_len, device=device, **kw),
        prefill_chunk=lambda p, tokens, cache, slot, pos, n_valid:
            T.transformer_prefill_chunk(p, cfg, tokens, cache, slot, pos,
                                        n_valid, path=path),
    )


def cache_batch_axes(model: Model, max_len: int) -> dict:
    """Which axis of each cache leaf is the batch (slot) axis: the one axis
    on which a 1-slot and a 2-slot cache disagree (shapes only, on the meta
    device)."""
    c1 = model.init_cache(1, max_len, device="meta")
    c2 = model.init_cache(2, max_len, device="meta")
    out = {}
    for name in c1:
        diff = [i for i, (x, y) in enumerate(zip(c1[name].shape,
                                                 c2[name].shape)) if x != y]
        assert len(diff) == 1, f"ambiguous batch axis of {name}"
        out[name] = diff[0]
    return out
