"""Checks shared by tests/test_torch_dense_families.py (deepseek-67b,
qwen2-72b, nemotron-4-15b), tests/test_torch_audio.py (musicgen-large),
the moe and the vlm tests:
each family's smoke config served by the port's transformer against the
JAX package's, on the same params.

Params: one numpy tree per arch, drawn from a seed in the JAX init's
shapes, every leaf N(0, 0.02^2) but the vlm family's cross-attention gates,
N(0, 1). The norm scales and biases, the QKV bias and the gates are 0 in
both packages' own init, so a path that dropped them would pass unseen;
here each is non-zero. Both packages take the tree as it is
(`np_to_jax`, `convert`) and each freezes it itself.

Tolerances: logits atol 1e-4, rtol 1e-5, as tests/test_torch_transformer.py
(the final norm's rsqrt, LayerNorm's too, sin / cos of the sinusoidal
positions and the head's float32 matmul round a few ulps apart); float K/V
rows and V scales 1e-6 of their largest magnitude; packed words, frozen
words, thresholds and greedy tokens exactly, except where packed attention
meets an exact tie (`test_torch_whole_prompt._hold_to_jax`, ROADMAP Queue
C). The JAX side runs inside `tune.gspmd_safe()`, its packed kernels on
their jnp oracles.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.packed import PackedWeight as JaxPackedWeight
from repro.kernels import tune
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import cache_to_numpy, words_to_numpy
from repro_torch.core.packed import PackedWeight
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import assert_rel, np_to_jax, to_port
from test_torch_whole_prompt import _hold_to_jax

LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
MAX_LEN = 32


@functools.lru_cache(maxsize=None)
def params(arch: str, seed: int = 0):
    """(JAX cfg, port cfg, JAX masters, JAX frozen, port masters, port
    frozen) of the smoke config, from one numpy tree."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jm = jax_get_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.02).astype(np.float32),
        shapes)
    if jcfg.family == "vlm":
        # the cross blocks' gates N(0, 1): tanh(gate) weighs the whole
        # cross-attention path (0 at init, 0.02 where drawn as the rest)
        attn = tree["groups"]["cross"]["attn"]
        attn["gate"] = rng.normal(size=attn["gate"].shape).astype(np.float32)
    jp, pp = np_to_jax(tree), to_port(tree)
    return jcfg, cfg, jp, jm.freeze(jp), pp, get_model(cfg).freeze(pp)


def prompt(seed, b, s, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def close_logits(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def check_config(arch):
    """Fields equal to JAX's, full and smoke; the activation dtype too."""
    for port_cfg, jax_cfg in ((get_config(arch), jax_get_config(arch)),
                              (smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        assert port_cfg.activation_dtype == getattr(
            torch, jnp.dtype(jax_cfg.activation_dtype).name)


def _assert_tree_equal(jt, pt, where=""):
    if isinstance(jt, dict):
        assert set(jt) == set(pt), where
        for k in jt:
            _assert_tree_equal(jt[k], pt[k], f"{where}/{k}")
    elif isinstance(jt, JaxPackedWeight):
        assert isinstance(pt, PackedWeight), where
        np.testing.assert_array_equal(words_to_numpy(pt.packed),
                                      np.asarray(jt.packed), err_msg=where)
        assert (pt.k, pt.kind, pt.fold) == (jt.k, jt.kind, jt.fold), where
        for field in ("thresh", "flip"):
            a, b = getattr(pt, field), getattr(jt, field)
            assert (a is None) == (b is None), (where, field)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{where} {field}")
    else:
        np.testing.assert_array_equal(pt.float().numpy(),
                                      np.asarray(jt, np.float32),
                                      err_msg=where)


def check_frozen_tree(arch):
    """The port's freeze of the tree equals JAX's: words, thresholds,
    folds and every float leaf (norms, biases, embedding, head)."""
    jcfg, _, _, jf, _, pf = params(arch)
    _assert_tree_equal(jf, pf)
    w_up = pf["blocks"]["ffn"]["w_up"]
    if jcfg.mlp == "sq_relu":
        assert w_up.fold == "act:sq_relu"
        assert w_up.thresh.shape == (jcfg.n_layers, jcfg.d_ff)
    else:
        assert w_up.fold is None and w_up.thresh is None


def check_logits(arch):
    """`transformer_logits`: masters and frozen params give equal logits in
    the port, bit for bit, and JAX's within tolerance."""
    jcfg, cfg, jp, jf, pp, pf = params(arch)
    toks = prompt(3, 2, 19)
    model = get_model(cfg)
    pm, _ = model.logits(pp, torch.from_numpy(toks).long())
    pfl, _ = model.logits(pf, torch.from_numpy(toks).long())
    assert torch.equal(pm, pfl)
    with tune.gspmd_safe():
        jl, _ = jax.jit(functools.partial(JT.transformer_logits, cfg=jcfg))(
            jf, tokens=jnp.asarray(toks))
    close_logits(pfl, jl)


def check_prefill(arch, kv_bits):
    """Whole-prompt prefill of two 21-token prompts into a new cache of 32
    rows: last-position logits and every cache leaf."""
    _, _, _, jf, _, pf = params(arch)
    jcfg = jax_smoke(arch).scaled(kv_bits=kv_bits)
    cfg = smoke_config(arch).scaled(kv_bits=kv_bits)
    toks = prompt(1, 2, 21)
    with tune.gspmd_safe():
        jl, jc = jax.jit(functools.partial(JT.transformer_prefill, cfg=jcfg,
                                           max_len=MAX_LEN))(
            jf, tokens=jnp.asarray(toks))
    pl, pc = T.transformer_prefill(pf, cfg, torch.from_numpy(toks).long(),
                                   max_len=MAX_LEN)
    close_logits(pl, jl)
    jn, pn = {k: np.asarray(v) for k, v in jc.items()}, cache_to_numpy(pc)
    assert set(pn) == set(jn)
    for name in jn:
        assert pn[name].shape == jn[name].shape, name
        if kv_bits == 1 and name in ("k", "v"):
            np.testing.assert_array_equal(pn[name], jn[name])
        else:
            assert_rel(pn[name], jn[name], rel=1e-6, what=name)


def check_chunks_and_decode(arch, kv_bits):
    """Two slots admitted chunk by chunk (chunks of 4, the last padded),
    then one decode step with slot 0 at its next position and slot 1
    inactive (pos -1): the logits of every last chunk and of the active
    decode row, and every cache leaf after each."""
    _, _, _, jf, _, pf = params(arch)
    jcfg = jax_smoke(arch).scaled(kv_bits=kv_bits)
    cfg = smoke_config(arch).scaled(kv_bits=kv_bits)
    rng = np.random.default_rng(27)
    prompts = (rng.integers(0, cfg.vocab, 6), rng.integers(0, cfg.vocab, 10))
    jc = JT.init_cache(jcfg, 2, MAX_LEN)
    pc = T.init_cache(cfg, 2, MAX_LEN, device="cpu")

    def same_cache():
        jn, pn = {k: np.asarray(v) for k, v in jc.items()}, cache_to_numpy(pc)
        for name in jn:
            if kv_bits == 1 and name in ("k", "v"):
                np.testing.assert_array_equal(pn[name], jn[name])
            else:
                assert_rel(pn[name], jn[name], rel=1e-6, what=name)

    for slot, p in enumerate(prompts):
        for lo in range(0, len(p), 4):
            nv = min(4, len(p) - lo)
            ch = np.zeros((1, 4), np.int32)
            ch[0, :nv] = p[lo:lo + nv]
            with tune.gspmd_safe():
                jl, jc = JT.transformer_prefill_chunk(
                    jf, jcfg, jnp.asarray(ch), jc, slot, lo, nv)
            pl, pc = T.transformer_prefill_chunk(
                pf, cfg, torch.from_numpy(ch), pc, slot, lo, nv)
        close_logits(pl, jl)
        same_cache()
    token, pos = np.array([5, 7], np.int32), np.array([6, -1], np.int32)
    with tune.gspmd_safe():
        jl, jc = JT.transformer_decode(jf, jcfg, jnp.asarray(token), jc,
                                       jnp.asarray(pos))
    pl, pc = T.transformer_decode(pf, cfg, torch.from_numpy(token), pc,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(pl[0].numpy(), np.asarray(jl)[0], **LOGIT_TOL)
    same_cache()


def traffic(seed, vocab=128):
    """Four requests of two prompt lengths (18 spans two flash chunks and
    five prefill chunks), budgets 2-6, through 2 slots."""
    rng = np.random.default_rng(seed)
    lens, budgets = (6, 18, 18, 6), (4, 6, 2, 5)
    return [(rng.integers(0, vocab, n).astype(np.int32), b)
            for n, b in zip(lens, budgets)]


# engine case -> the options of both engines: the main serving path
# (chunked, kv_bits=1) and the JAX package's default (whole prompt, float
# cache)
ENGINES = {"chunked kv1": dict(kv_bits=1, prefill_chunk=4),
           "whole kv0": dict(kv_bits=0, prefill_chunk=None)}


def check_engine_tokens(arch, case, monkeypatch):
    """`ServingEngine(cfg, masters, freeze=True, ...)`: greedy tokens equal
    the JAX engine's on the same masters (kv_bits=1: `_hold_to_jax`)."""
    jcfg, cfg, jp, _, pp, _ = params(arch)
    kw = ENGINES[case]
    reqs = traffic(5)
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jp, freeze=True, slots=2, max_len=MAX_LEN,
                         **kw).generate([JaxRequest(p, max_new_tokens=b)
                                         for p, b in reqs])
    _hold_to_jax(lambda: ServingEngine(
        cfg, pp, freeze=True, slots=2, max_len=MAX_LEN, **kw).generate(
            [Request(p, max_new_tokens=b) for p, b in reqs]),
        want, kw["kv_bits"], monkeypatch, f"{arch} {case}")


def shared_traffic(seed, vocab=128, prefix=11):
    """Five requests: four share an 11-token prefix and add 1-7 tokens of
    their own, one shares nothing."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix)
    out = []
    for i in range(5):
        own = rng.integers(0, vocab, int(rng.integers(1, 8)))
        p = own if i == 3 else np.concatenate([shared, own])
        out.append((p.astype(np.int32), int(rng.integers(2, 6))))
    return out


def check_paged_equals_contiguous(arch):
    """The paged kv_bits=1 engine with the prefix cache gives the
    contiguous engine's tokens exactly, and the tree serves some prompt
    tokens."""
    _, cfg, _, _, pp, _ = params(arch)
    reqs = [Request(p, max_new_tokens=b) for p, b in shared_traffic(1)]
    kw = dict(freeze=True, kv_bits=1, prefill_chunk=4, slots=2,
              max_len=MAX_LEN)
    base = ServingEngine(cfg, pp, **kw).generate(reqs)
    eng = ServingEngine(cfg, pp, page_size=4, prefix_cache=True, **kw)
    for c, want in zip(eng.serve(reqs), base, strict=True):
        np.testing.assert_array_equal(c.tokens, want)
    st = eng.scheduler().stats
    assert st["prefix_hits"] >= 2
    assert st["prefill_tokens"] + st["prefill_tokens_saved"] == \
        sum(r.prompt.size for r in reqs)
