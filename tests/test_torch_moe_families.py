"""dbrx-132b (16 experts, top-4) and llama4-scout-17b-a16e (16 experts,
top-1) in the port against the JAX package, at smoke size (2 layers, d 64,
4 experts, top-k min(k, 2), capacity factor 8, float32): configs, the
frozen tree (experts frozen with their leading E axis, the router float),
logits and the load-balance loss, whole-prompt prefill, chunked prefill
and a decode step whose inactive row comes first and takes expert capacity
before the active one, and the greedy tokens of the engines (chunked and
whole, kv_bits 0 and 1, paged with the prefix cache) against the JAX
engine's, at the smoke capacity factor and at 1.0, where routes drop at
decode. The checks shared with the dense families and their tolerances are
in tests/_torch_families.py.

The module runs torch on one thread with denormals flushed to zero, XLA's
float mode (`test_torch_whole_prompt._flush_denormals`).
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tune
from repro.models import transformer as JT
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.convert import cache_to_numpy
from repro_torch.core.packed import PackedWeight
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServingEngine

import _torch_families as F
from _torch_parity import assert_rel
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)
from test_torch_whole_prompt import _hold_to_jax

ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch):
    F.check_config(arch)
    cfg = F.smoke_config(arch)
    assert (cfg.family, cfg.n_experts, cfg.capacity_factor) == ("moe", 4, 8.0)
    assert cfg.top_k == min(F.get_config(arch).top_k, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_tree_equals_jax(arch):
    """Words, folds and every float leaf equal JAX's freeze; the experts'
    words keep the (L, E) axes and a layer's view is (E, N, KW)."""
    jcfg, _, _, jf, _, pf = F.params(arch)
    F._assert_tree_equal(jf, pf)
    ex = pf["blocks"]["ffn"]["experts"]
    for name, (k, n) in (("w_gate", (jcfg.d_model, jcfg.d_ff)),
                         ("w_up", (jcfg.d_model, jcfg.d_ff)),
                         ("w_down", (jcfg.d_ff, jcfg.d_model))):
        w = ex[name]
        assert isinstance(w, PackedWeight) and w.fold is None
        assert w.packed.shape == (jcfg.n_layers, jcfg.n_experts, n,
                                  -(-k // 32))
        assert T.layer_params(pf, 1)["ffn"]["experts"][name].packed.shape \
            == w.packed.shape[1:]
    assert pf["blocks"]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_masters_and_frozen_logits(arch):
    """`transformer_logits`: masters and frozen params give equal logits in
    the port, and JAX's within tolerance; the load-balance loss summed over
    the layers equals JAX's within 1e-6."""
    jcfg, cfg, _, jf, pp, pf = F.params(arch)
    toks = F.prompt(3, 2, 19)
    model = get_model(cfg)
    pm, am = model.logits(pp, torch.from_numpy(toks).long())
    pfl, af = model.logits(pf, torch.from_numpy(toks).long())
    assert torch.equal(pm, pfl) and torch.equal(am["lb_loss"], af["lb_loss"])
    with tune.gspmd_safe():
        jl, ja = jax.jit(functools.partial(JT.transformer_logits, cfg=jcfg))(
            jf, tokens=jnp.asarray(toks))
    F.close_logits(pfl, jl)
    np.testing.assert_allclose(float(af["lb_loss"]), float(ja["lb_loss"]),
                               rtol=1e-6)
    assert float(af["lb_loss"]) > 0


@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_jax(arch, kv_bits):
    F.check_prefill(arch, kv_bits)


def _drops(calls):
    """A wrapper of `moe_ffn` that records each call's drop_frac."""
    real = T.moe_ffn

    def wrapped(*args, **kw):
        out, aux = real(*args, **kw)
        calls.append(float(aux["drop_frac"]))
        return out, aux
    return wrapped


@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_and_decode_with_a_leading_inactive_row(arch, kv_bits):
    """Slots 0 and 3 of four admitted chunk by chunk (chunks of 4, the last
    padded: its pad rows reach the router), then one decode step at
    capacity factor 1.0 with slots 0-2 inactive (pos -1; 1 and 2 never
    admitted) and slot 3 at its next position: the inactive rows are
    routed first and take capacity (routes drop), so the active row's
    logits depend on them. Every row's logits, the last chunks' and every
    cache leaf equal JAX's."""
    _, _, _, jf, _, pf = F.params(arch)
    jcfg = F.jax_smoke(arch).scaled(kv_bits=kv_bits, capacity_factor=1.0)
    cfg = F.smoke_config(arch).scaled(kv_bits=kv_bits, capacity_factor=1.0)
    rng = np.random.default_rng(31)
    prompts = (rng.integers(0, cfg.vocab, 6), rng.integers(0, cfg.vocab, 10))
    jc = JT.init_cache(jcfg, 4, F.MAX_LEN)
    pc = T.init_cache(cfg, 4, F.MAX_LEN, device="cpu")

    def same_cache():
        jn, pn = {k: np.asarray(v) for k, v in jc.items()}, cache_to_numpy(pc)
        for name in jn:
            if kv_bits == 1 and name in ("k", "v"):
                np.testing.assert_array_equal(pn[name], jn[name])
            else:
                assert_rel(pn[name], jn[name], rel=1e-6, what=name)

    for slot, p in zip((0, 3), prompts):
        for lo in range(0, len(p), 4):
            nv = min(4, len(p) - lo)
            ch = np.zeros((1, 4), np.int32)
            ch[0, :nv] = p[lo:lo + nv]
            with tune.gspmd_safe():
                jl, jc = JT.transformer_prefill_chunk(
                    jf, jcfg, jnp.asarray(ch), jc, slot, lo, nv)
            pl, pc = T.transformer_prefill_chunk(
                pf, cfg, torch.from_numpy(ch), pc, slot, lo, nv)
        F.close_logits(pl, jl)
        same_cache()
    token = np.array([5, 7, 0, 9], np.int32)
    pos = np.array([-1, -1, -1, 10], np.int32)
    with tune.gspmd_safe():
        jl, jc = JT.transformer_decode(jf, jcfg, jnp.asarray(token), jc,
                                       jnp.asarray(pos))
    calls = []
    with mock.patch.object(T, "moe_ffn", _drops(calls)):
        pl, pc = T.transformer_decode(pf, cfg, torch.from_numpy(token), pc,
                                      torch.from_numpy(pos))
    F.close_logits(pl, jl)
    same_cache()
    assert len(calls) == cfg.n_layers and max(calls) > 0


def _engine_tokens(arch, kw, traffic, cf, monkeypatch, what):
    """Greedy tokens of `ServingEngine(cfg, masters, freeze=True, **kw)`
    at capacity factor `cf` against the JAX engine's on the same masters
    (kv_bits=1: `_hold_to_jax`); returns the port's completions' stats."""
    jcfg, cfg, jp, _, pp, _ = F.params(arch)
    jcfg, cfg = (c.scaled(capacity_factor=cf) for c in (jcfg, cfg))
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jp, freeze=True, slots=2, max_len=F.MAX_LEN,
                         **kw).generate([JaxRequest(p, max_new_tokens=b)
                                         for p, b in traffic])
    calls = []
    engines = []

    def run():
        eng = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=F.MAX_LEN,
                            **kw)
        engines.append(eng)
        with mock.patch.object(T, "moe_ffn", _drops(calls)):
            return eng.generate([Request(p, max_new_tokens=b)
                                 for p, b in traffic])
    _hold_to_jax(run, want, kw.get("kv_bits", 0), monkeypatch, what)
    return calls, engines[-1].scheduler().stats


# engine case -> (options of both engines, traffic, capacity factor):
# the smoke factor, and 1.0, where decode steps drop routes
ENGINE_CASES = {
    "chunked kv1": (dict(kv_bits=1, prefill_chunk=4), "plain", 8.0),
    "whole kv0": (dict(kv_bits=0), "plain", 8.0),
    "chunked kv1 cf1": (dict(kv_bits=1, prefill_chunk=4), "plain", 1.0),
    "whole kv0 cf1": (dict(kv_bits=0), "plain", 1.0),
    "paged prefix kv1 cf1": (dict(kv_bits=1, prefill_chunk=4, page_size=4,
                                  prefix_cache=True), "shared", 1.0),
    "whole kv1 cf1": (dict(kv_bits=1), "plain", 1.0),
    "chunked kv0 cf1": (dict(kv_bits=0, prefill_chunk=4), "plain", 1.0),
}
ARCH_CASES = [(a, c) for a in ARCHS
              for c in ("chunked kv1", "whole kv0", "paged prefix kv1 cf1")] \
    + [("dbrx-132b", "chunked kv1 cf1"), ("dbrx-132b", "chunked kv0 cf1"),
       ("llama4-scout-17b-a16e", "whole kv1 cf1"),
       ("llama4-scout-17b-a16e", "whole kv0 cf1")]


@pytest.mark.parametrize("arch,case", ARCH_CASES)
def test_engine_tokens_equal_jax(arch, case, monkeypatch):
    """The engines' greedy tokens equal the JAX engine's: the same rows
    reach the router in both (whole slot batches at decode, inactive rows
    included; chunks with their pad rows; whole prompts alone), and at
    capacity factor 1.0 decode steps drop routes."""
    kw, which, cf = ENGINE_CASES[case]
    traffic = F.traffic(5) if which == "plain" else F.shared_traffic(1)
    calls, stats = _engine_tokens(arch, kw, traffic, cf, monkeypatch,
                                  f"{arch} {case}")
    if cf < 8.0:
        assert max(calls) > 0, "no route dropped"
    if kw.get("prefix_cache"):
        assert stats["prefix_hits"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_contiguous(arch):
    F.check_paged_equals_contiguous(arch)
