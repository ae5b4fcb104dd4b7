"""falcon-mamba-7b: the pure Mamba stack, served from O(1) recurrent state
per slot (port of the falcon-mamba serving path of `repro.models.ssm_lm`).

Params are the JAX package's tree: {"embed", "blocks", "final_norm",
"lm_head"}, the blocks' leaves stacked along a leading L axis (frozen
in_proj / x_proj / out_proj are `PackedWeight`s whose words carry that
axis), so trees carry across with `convert`. The state is {"conv": (L, B,
K-1, di) in the activation dtype, "h": (L, B, di, N) float32}; like the
port's transformer cache it is updated in place and the same dict returned.

`path` ('auto' | 'ref') picks the kernels (the binary GEMMs and kernel 10,
the selective scan) or their plain versions, as in `models.transformer`.

Whole-prompt `mamba_prefill` and the inference forward `mamba_logits` run
each block as the chunk block from zero state over the whole sequence, so
the scan is one launch of kernel 10 at T = S per layer (the JAX package
runs its jnp `_mamba_chunk_scan` there).

Not ported yet (ROADMAP Queue A): training and the recurrentgemma hybrid.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import QuantMode
from repro_torch.models.ssm import (
    init_mamba_blocks, mamba_block_chunk, mamba_block_step,
)
from repro_torch.models.transformer import (
    _embed, _head, _stack_layers, layer_params,
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
        return (torch.randn(shape, generator=gen, device=gen.device)
                * 0.02).to(dev)

    params = {"embed": normal((cfg.vocab, cfg.d_model)),
              "final_norm": {"scale": torch.zeros(cfg.d_model, device=dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab))
    if freeze_layer is None:
        params["blocks"] = init_mamba_blocks(gen, cfg, cfg.n_layers, dev)
    else:
        params["blocks"] = _stack_layers(
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
    h = _embed(params, cfg, token[:, None])
    for layer in range(cfg.n_layers):
        cs, hs = cache["conv"][layer], cache["h"][layer]
        h, cs_new, hs_new = mamba_block_step(layer_params(params, layer), h,
                                             cs, hs, cfg, mode, path=path)
        cs.copy_(torch.where(live, cs_new, cs))
        hs.copy_(torch.where(live, hs_new, hs))
    return _head(params, cfg, h)[:, 0], cache


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
    h = _embed(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        cs = cache["conv"][layer, slot:slot + 1]
        hs = cache["h"][layer, slot:slot + 1]
        h, cs_new, hs_new = mamba_block_chunk(layer_params(params, layer), h,
                                              cs, hs, n_valid, cfg, mode,
                                              path=path)
        cs.copy_(cs_new)
        hs.copy_(hs_new)
    return _head(params, cfg, h[:, n_valid - 1:n_valid])[:, 0], cache


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
    h = _embed(params, cfg, tokens)
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
    return _head(params, cfg, h[:, -1:])[:, 0], cache


def mamba_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                 path: str = "auto") -> tuple[torch.Tensor, dict]:
    """Inference forward: tokens (B, S) -> (logits (B, S, V), {}). (The
    training forward comes with the LM trainer, ROADMAP Queue A.)"""
    _check_served(cfg)
    return _head(params, cfg, _whole_sequence(params, cfg, tokens, path)), {}
