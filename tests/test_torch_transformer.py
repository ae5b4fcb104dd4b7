"""The port's dense transformer with a bit-resident KV cache against the JAX
package's `transformer_prefill_chunk` / `transformer_decode`, on frozen
smoke phi3-medium-14b params (2 layers, d 64, hd 16, float32), plus the
config copy and the param / cache carry-over.

Cache words are compared exactly. V scales: rtol 1e-6 (a mean of at most
16 * 32 float32 values, summed in another order). Logits: atol 1e-4, rtol
1e-5 (the residual stream is integer-valued in both packages; the final
RMSNorm's rsqrt and the head's float32 matmul round differently, each by a
few ulps of logits of size ~1).

The prompts of the prefill and decode comparisons come from seeds whose
port runs meet no exact cancellation of the weighted V terms (where the
sign of an attention output is a matter of rounding; see
tests/test_torch_serving.py and ROADMAP Queue C).

The JAX side runs inside `tune.gspmd_safe()`, which pins its packed kernels
to their jnp oracles (some Pallas interpret block shapes fail on the CPU,
ROADMAP Queue C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config as jax_smoke
from repro.kernels import tune
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config, list_archs
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import (
    cache_from_numpy, cache_to_numpy, from_numpy_tree, to_numpy_tree,
)
from repro_torch.core.packed import PackedWeight, map_tree
from repro_torch.models import transformer as T
from repro_torch.models.api import cache_batch_axes, get_model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import jax_to_np, to_port

ARCH = "phi3-medium-14b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).scaled(kv_bits=1)
    cfg = smoke_config(ARCH).scaled(kv_bits=1)
    jm = jax_get_model(jcfg)
    jp = jm.freeze(jm.init(jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, to_port(jax_to_np(jp))


def _np_cache(c):
    return {k: np.asarray(v) for k, v in c.items()}


def _assert_cache(jc, pc):
    jn, pn = _np_cache(jc), cache_to_numpy(pc)
    np.testing.assert_array_equal(pn["k"], jn["k"])
    np.testing.assert_array_equal(pn["v"], jn["v"])
    np.testing.assert_allclose(pn["v_scale"], jn["v_scale"], rtol=1e-6)


def _run_chunks(jcfg, cfg, jp, pp, prompt, slot, c=4, slots=2, t=32):
    """Admit `prompt` into `slot` chunk by chunk in both packages; returns
    both caches and the last chunk's logits."""
    jc = JT.init_cache(jcfg, slots, t)
    pc = T.init_cache(cfg, slots, t, device="cpu")
    for lo in range(0, len(prompt), c):
        nv = min(c, len(prompt) - lo)
        ch = np.zeros((1, c), np.int32)
        ch[0, :nv] = prompt[lo:lo + nv]
        with tune.gspmd_safe():
            jl, jc = JT.transformer_prefill_chunk(jp, jcfg, jnp.asarray(ch),
                                                  jc, slot, lo, nv)
        pl, pc = T.transformer_prefill_chunk(pp, cfg, torch.from_numpy(ch),
                                             pc, slot, lo, nv)
    return jc, pc, np.asarray(jl), pl.numpy()


def test_prefill_chunks_match_jax(models):
    """Three chunks, the last padded (n_valid 2 of 4): cache words, V
    scales and the last real token's logits. Pad rows write nothing."""
    jcfg, cfg, jp, pp = models
    prompt = np.random.default_rng(36).integers(0, cfg.vocab, 10)
    jc, pc, jl, pl = _run_chunks(jcfg, cfg, jp, pp, prompt, slot=1)
    _assert_cache(jc, pc)
    np.testing.assert_allclose(pl, jl, **LOGIT_TOL)
    assert (pc["k"][:, 1, 10:] == 0).all() and (pc["k"][:, 0] == 0).all()


def test_running_v_scale_equals_whole_prompt(models):
    """After the last chunk the running mean |v| equals v_cache_scale of
    the whole prompt's V (float tolerance rtol 1e-6)."""
    _, cfg, _, pp = models
    prompt = np.random.default_rng(22).integers(0, cfg.vocab, 11)
    cache = T.init_cache(cfg, 1, 16, device="cpu")
    for lo in range(0, 11, 4):
        nv = min(4, 11 - lo)
        ch = torch.zeros((1, 4), dtype=torch.int64)
        ch[0, :nv] = torch.from_numpy(prompt[lo:lo + nv])
        T.transformer_prefill_chunk(pp, cfg, ch, cache, 0, lo, nv)
    # the whole prompt's V of layer 0, recomputed in one pass
    from repro_torch.core.layers import QuantMode
    from repro_torch.kernels.decode_attention import v_cache_scale
    from repro_torch.models.common import rms_norm
    bp = T.layer_params(pp, 0)
    h = T._embed(pp, cfg, torch.from_numpy(prompt)[None])
    _, _, v = T._qkv(bp["attn"], rms_norm(h, bp["ln1"]["scale"]), cfg,
                     QuantMode(cfg.quant), "auto")
    np.testing.assert_allclose(cache["v_scale"][0].numpy(),
                               v_cache_scale(v).numpy(), rtol=1e-6)


def test_decode_step_matches_jax(models):
    """Two slots prefilled, then one decode step with slot 0 at its next
    position and slot 1 inactive (pos = -1): words written for slot 0 only,
    logits of the active row within tolerance."""
    jcfg, cfg, jp, pp = models
    rng = np.random.default_rng(27)
    p0, p1 = rng.integers(0, cfg.vocab, 6), rng.integers(0, cfg.vocab, 9)
    jc = JT.init_cache(jcfg, 2, 32)
    pc = T.init_cache(cfg, 2, 32, device="cpu")
    for slot, p in ((0, p0), (1, p1)):
        for lo in range(0, len(p), 4):
            nv = min(4, len(p) - lo)
            ch = np.zeros((1, 4), np.int32)
            ch[0, :nv] = p[lo:lo + nv]
            with tune.gspmd_safe():
                _, jc = JT.transformer_prefill_chunk(
                    jp, jcfg, jnp.asarray(ch), jc, slot, lo, nv)
            T.transformer_prefill_chunk(pp, cfg, torch.from_numpy(ch), pc,
                                        slot, lo, nv)
    before = {k: a.copy() for k, a in cache_to_numpy(pc).items()}
    token = np.array([5, 7], np.int32)
    pos = np.array([6, -1], np.int32)
    with tune.gspmd_safe():
        jl, jc = JT.transformer_decode(jp, jcfg, jnp.asarray(token), jc,
                                       jnp.asarray(pos))
    pl, pc = T.transformer_decode(pp, cfg, torch.from_numpy(token), pc,
                                  torch.from_numpy(pos))
    _assert_cache(jc, pc)
    np.testing.assert_allclose(pl[0].numpy(), np.asarray(jl)[0], **LOGIT_TOL)
    after = cache_to_numpy(pc)
    np.testing.assert_array_equal(after["k"][:, 1], before["k"][:, 1])
    np.testing.assert_array_equal(after["v"][:, 1], before["v"][:, 1])
    assert (after["k"][:, 0, 6] != before["k"][:, 0, 6]).any()


def test_inactive_rows_and_pad_rows_write_nothing(models):
    """A decode step over a slot mid-admission (pos = -1) leaves its words
    and V scale unchanged; a padded chunk writes its n_valid rows only."""
    _, cfg, _, pp = models
    cache = T.init_cache(cfg, 3, 24, device="cpu")
    ch = torch.tensor([[3, 1, 4, 1]])
    T.transformer_prefill_chunk(pp, cfg, ch, cache, 1, 0, 4)
    T.transformer_prefill_chunk(pp, cfg, ch, cache, 1, 4, 1)
    assert (cache["k"][:, 1, 5:] == 0).all()
    snap = {k: v.clone() for k, v in cache.items()}
    for _ in range(3):
        T.transformer_decode(pp, cfg, torch.tensor([2, 9, 4]), cache,
                             torch.tensor([-1, -1, -1], dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k], snap[k]), k


def test_config_fields_equal_jax():
    from repro.configs.base import get_config as jax_get_config
    assert list_archs() == [ARCH]
    for port_cfg, jax_cfg in ((get_config(ARCH), jax_get_config(ARCH)),
                              (smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        assert port_cfg.activation_dtype == getattr(
            torch, jnp.dtype(jax_cfg.activation_dtype).name)


def test_unported_archs_raise():
    with pytest.raises(KeyError, match="ROADMAP Queue A"):
        get_config("dbrx-132b")
    cfg = smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="kv_bits=0"):
        T.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        get_model(cfg.scaled(family="moe"))


def test_init_cache_shapes_and_batch_axes():
    cfg = smoke_config(ARCH).scaled(kv_bits=1)
    c = T.init_cache(cfg, 3, 40, device="cpu")
    assert c["k"].shape == (2, 3, 40, 2, 1) and c["k"].dtype == torch.int32
    assert c["v_scale"].shape == (2, 3, 2)
    assert cache_batch_axes(get_model(cfg), 40) == {"k": 1, "v": 1,
                                                    "v_scale": 1}
    jc = JT.init_cache(jax_smoke(ARCH).scaled(kv_bits=1), 3, 40)
    assert {k: v.shape for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in c.items()}


def test_params_and_cache_round_trip(models):
    """Stacked fp32 masters and frozen PackedWeight trees (leading L axis)
    carry across and back unchanged; so do packed caches (uint32 words)."""
    jcfg, _, jp, pp = models
    w = pp["blocks"]["attn"]["wq"]
    assert isinstance(w, PackedWeight) and w.packed.shape[0] == 2
    back = to_numpy_tree(pp)
    want = jax_to_np(jp)
    np.testing.assert_array_equal(back["blocks"]["ffn"]["w_down"]["packed"],
                                  want["blocks"]["ffn"]["w_down"]["packed"])
    assert back["blocks"]["ffn"]["w_down"]["packed"].dtype == np.uint32
    np.testing.assert_array_equal(back["embed"], want["embed"])
    masters = jax_to_np(jax_get_model(jcfg).init(jax.random.PRNGKey(1)))
    again = to_numpy_tree(from_numpy_tree(masters, device="cpu"))
    for a, b in zip(jax.tree.leaves(masters), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    cache = {"k": rng.integers(0, 2**32, (2, 1, 4, 2, 1), dtype=np.uint64)
             .astype(np.uint32),
             "v": np.full((2, 1, 4, 2, 1), 0xFFFFFFFF, np.uint32),
             "v_scale": rng.random((2, 1, 2)).astype(np.float32)}
    back = cache_to_numpy(cache_from_numpy(cache, device="cpu"))
    for k in cache:
        np.testing.assert_array_equal(back[k], cache[k])
        assert back[k].dtype == cache[k].dtype


def test_freeze_casts_head_once(models):
    _, cfg, _, _ = models
    bf = cfg.scaled(dtype="bfloat16")
    m = get_model(bf)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    frozen = m.freeze(params)
    assert frozen["lm_head"].dtype == torch.bfloat16
    assert params["lm_head"].dtype == torch.float32
    assert isinstance(frozen["blocks"]["ffn"]["w_gate"], PackedWeight)


def test_init_frozen_draws_layer_by_layer(models):
    """init_frozen gives the tree freeze(init(...)) gives: the same leaves,
    shapes, dtypes and packing, the embedding and head drawn first from the
    same generator state (so equal), the layers drawn one at a time (so
    other draws, and each layer its own); the engine serves it as is."""
    _, cfg, _, _ = models
    m = get_model(cfg.scaled(n_layers=3))
    want = m.freeze(m.init(torch.Generator().manual_seed(4), device="cpu"))
    got = m.init_frozen(torch.Generator().manual_seed(4), device="cpu")
    leaves = []
    map_tree(lambda name, p: leaves.append((name, p)), want)
    got_leaves = []
    map_tree(lambda name, p: got_leaves.append((name, p)), got)
    assert [n for n, _ in got_leaves] == [n for n, _ in leaves]
    for (name, a), (_, b) in zip(got_leaves, leaves):
        assert type(a) is type(b), name
        if isinstance(a, PackedWeight):
            assert (a.k, a.kind, a.packed.shape, a.packed.dtype) == \
                (b.k, b.kind, b.packed.shape, b.packed.dtype), name
        else:
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    torch.testing.assert_close(got["embed"], want["embed"], rtol=0, atol=0)
    torch.testing.assert_close(got["lm_head"], want["lm_head"], rtol=0,
                               atol=0)
    wq = got["blocks"]["attn"]["wq"].packed
    assert not torch.equal(wq[0], wq[1]) and not torch.equal(wq[1], wq[2])
    eng = ServingEngine(m.cfg, got, freeze=True, kv_bits=1, prefill_chunk=4,
                        slots=2, max_len=16)
    assert eng.params is got
    out = eng.generate([Request(np.arange(6) % cfg.vocab, max_new_tokens=3)])
    assert out[0].shape == (3,)
