"""musicgen-large (the audio family: sinusoidal positions, LayerNorm, GELU
FFN, MHA at head_dim 64) in the port against the JAX package, at smoke
size (2 layers, d 64, 4 heads of 16, float32): the config, the frozen
tree, masters against frozen logits, whole-prompt prefill, chunked prefill
and decode (the position embedding of each row's own position), and the
greedy tokens of the chunked kv_bits=1 engine and of the default engine
against the JAX engine's; the paged engine with the prefix cache against
the contiguous one. The checks and their tolerances are in
tests/_torch_families.py.

The module runs torch on one thread with denormals flushed to zero, XLA's
float mode (`test_torch_whole_prompt._flush_denormals`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro_torch.models import common as C
from repro_torch.models import transformer as T

import _torch_families as F
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)

ARCH = "musicgen-large"


def test_config_fields_equal_jax():
    F.check_config(ARCH)


def test_frozen_tree_equals_jax():
    F.check_frozen_tree(ARCH)


def test_masters_and_frozen_logits():
    F.check_logits(ARCH)


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_prefill_matches_jax(kv_bits):
    F.check_prefill(ARCH, kv_bits)


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_chunks_and_decode_match_jax(kv_bits):
    F.check_chunks_and_decode(ARCH, kv_bits)


@pytest.mark.parametrize("case", list(F.ENGINES))
def test_engine_tokens_match_jax(case, monkeypatch):
    F.check_engine_tokens(ARCH, case, monkeypatch)


def test_paged_engine_equals_contiguous():
    F.check_paged_equals_contiguous(ARCH)


@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_pos_matches_jax(d):
    """Positions 0..4095 at the smoke and the full width. The frequencies
    are exp of the same float32 arguments, which XLA's exp and torch's
    round up to an ulp apart (ROADMAP Queue C); an ulp of a frequency is
    pos ulps of the angle. So each entry is held within two ulps (2^-23
    relative) of its angle plus two of 1, and the frequencies within one
    ulp of JAX's."""
    half = d // 2
    want_f = np.asarray(jnp.exp(-jnp.log(10000.0) * jnp.arange(half) / half))
    got_f = torch.exp(-np.log(10000.0)
                      * torch.arange(half, dtype=torch.float32) / half)
    assert (np.abs(got_f.numpy() - want_f) <= np.spacing(want_f)).all()
    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(JC.sinusoidal_pos(jnp.asarray(pos), d))
    got = C.sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (4096, d)
    ang = np.tile(pos[:, None] * want_f[None].astype(np.float64), 2)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 2 * 2.0**-23 * (ang + 1)).all(), err.max()


def test_embed_adds_each_rows_position():
    """Whole prompt: positions 0..S-1; decode: each row its own position
    (an inactive row's -1 too); a chunk: its positions."""
    _, cfg, _, _, _, pf = F.params(ARCH)
    toks = torch.tensor([[3, 9, 4, 1]])
    base = pf["embed"][toks]
    pe = C.sinusoidal_pos(torch.arange(8), cfg.d_model)
    assert torch.equal(T.embed(pf, cfg, toks), base + pe[:4])
    assert torch.equal(T.embed(pf, cfg, toks, torch.arange(4) + 4),
                       base + pe[4:])
    pos = torch.tensor([5, -1], dtype=torch.int32)
    got = T.embed(pf, cfg, toks[0, :2, None], pos[:, None])
    want = base[0, :2, None] + C.sinusoidal_pos(pos, cfg.d_model)[:, None]
    assert got.shape == (2, 1, cfg.d_model) and torch.equal(got, want)
