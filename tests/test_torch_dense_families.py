"""deepseek-67b, qwen2-72b (QKV bias) and nemotron-4-15b (LayerNorm, the
squared-ReLU FFN served bit-resident) in the port against the JAX package,
at smoke size (2 layers, d 64, hd 16, float32): configs, the frozen tree
(nemotron's up-projection carries the act:sq_relu fold), masters against
frozen logits, whole-prompt prefill, chunked prefill and decode, and the
greedy tokens of the chunked kv_bits=1 engine and of the default engine
(whole prompt, float cache) against the JAX engine's; the paged engine
with the prefix cache against the contiguous one. The checks and their
tolerances are in tests/_torch_families.py.

deepseek-67b's smoke config is phi3-medium-14b's in every field but its
name and source, so its chunk, decode and engine runs would repeat
tests/test_torch_transformer.py, tests/test_torch_serving.py and
tests/test_torch_whole_prompt.py: it gets the config, tree, logits and
whole-prompt prefill checks only.

The module runs torch on one thread with denormals flushed to zero, XLA's
float mode (`test_torch_whole_prompt._flush_denormals`).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.layers import QuantMode as JaxQuantMode
from repro.core.packed import attach_ffn_act_thresholds as jax_attach
from repro.core.packed import freeze_params as jax_freeze
from repro.models import common as JC
from repro_torch.configs.base import get_config, list_archs
from repro_torch.configs.smoke import smoke_config
from repro_torch.core.layers import QuantMode
from repro_torch.core.packed import attach_ffn_act_thresholds, freeze_params
from repro_torch.models import common as C
from repro_torch.models.api import get_model

import _torch_families as F
from _torch_parity import assert_rel, np_to_jax, to_port
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)

ARCHS = ["deepseek-67b", "qwen2-72b", "nemotron-4-15b"]
SERVED = ["qwen2-72b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch):
    F.check_config(arch)


def test_registry_and_unported_families():
    """Every arch of the JAX registry is registered in the port, the four
    dense-stack families and the two moe archs among them; the moe and
    vlm families serve."""
    from repro.configs.base import list_archs as jax_list_archs
    assert list_archs() == sorted(jax_list_archs())
    assert set(ARCHS) | {"musicgen-large", "dbrx-132b",
                         "llama4-scout-17b-a16e"} <= set(list_archs())
    assert get_config("llama-3.2-vision-11b").family == "vlm"
    vlm = smoke_config("llama-3.2-vision-11b")
    assert get_model(vlm).cfg.xattn_group == 5
    assert get_model(smoke_config("dbrx-132b")).cfg.family == "moe"


def test_deepseek_smoke_is_phi3_smoke():
    ds, phi3 = smoke_config("deepseek-67b"), smoke_config("phi3-medium-14b")
    assert ds != phi3
    assert dataclasses.replace(ds, name=phi3.name, source=phi3.source) == phi3


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_tree_equals_jax(arch):
    F.check_frozen_tree(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_masters_and_frozen_logits(arch):
    F.check_logits(arch)


@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, kv_bits):
    F.check_prefill(arch, kv_bits)


@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("arch", SERVED)
def test_chunks_and_decode_match_jax(arch, kv_bits):
    F.check_chunks_and_decode(arch, kv_bits)


@pytest.mark.parametrize("case", list(F.ENGINES))
@pytest.mark.parametrize("arch", SERVED)
def test_engine_tokens_match_jax(arch, case, monkeypatch):
    F.check_engine_tokens(arch, case, monkeypatch)


@pytest.mark.parametrize("arch", SERVED)
def test_paged_engine_equals_contiguous(arch):
    F.check_paged_equals_contiguous(arch)


def test_layer_norm_matches_jax():
    """float32 and bfloat16 rows, the gain passed as 1 + scale."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 4 + 1).astype(np.float32)
    scale = (rng.normal(size=64) * 0.1).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    for jdt, tdt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        want = JC.layer_norm(jax.numpy.asarray(x, jdt), 1.0 + scale, bias)
        got = C.layer_norm(torch.from_numpy(x).to(tdt),
                           1.0 + torch.from_numpy(scale),
                           torch.from_numpy(bias))
        assert got.dtype == tdt
        assert_rel(got.float().numpy(), np.asarray(want, np.float32),
                   rel=1e-6 if tdt == torch.float32 else 1e-2, what=jdt)


@pytest.mark.parametrize("kind", ["sq_relu", "gelu"])
def test_two_matrix_ffn_matches_jax(kind):
    """`common.ffn` of the two-matrix kinds on masters and frozen weights,
    equal to JAX's bit for bit. sq_relu frozen with the fold takes the
    fused chain: its hidden bits are the constant +1, so every row gives
    the same output, which equals the unfused frozen and the masters'
    result. gelu has no fold (its sign is not a threshold of the dot)."""
    rng = np.random.default_rng(1)
    tree = {"w_up": rng.normal(size=(64, 96)).astype(np.float32),
            "w_down": rng.normal(size=(96, 64)).astype(np.float32)}
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jm, pm = np_to_jax(tree), to_port(tree)
    pairs = [(jm, pm), (jax_freeze(jm), freeze_params(pm))]
    if kind == "sq_relu":
        pairs.append((jax_attach(jax_freeze(jm), kind),
                      attach_ffn_act_thresholds(freeze_params(pm), kind)))
        assert pairs[-1][1]["w_up"].fold == "act:sq_relu"
    else:
        with pytest.raises(ValueError, match="no exact"):
            attach_ffn_act_thresholds(freeze_params(pm), kind)
    outs = []
    for jp, pp in pairs:
        want = JC.ffn(jp, jax.numpy.asarray(x), kind, JaxQuantMode.BBP_DET)
        got = C.ffn(pp, torch.from_numpy(x), kind, QuantMode.BBP_DET)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs)
    if kind == "sq_relu":
        assert torch.equal(outs[2][0, 0], outs[2][1, 2])
