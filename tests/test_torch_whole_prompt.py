"""Whole-prompt prefill and the float KV cache (the JAX package's default
serving path) against the JAX package, on the smoke phi3-medium-14b and
falcon-mamba-7b (2 layers, float32): `transformer_prefill` (logits and
every cache leaf, kv_bits 0 and 1, fp32 masters and frozen params),
`transformer_logits`, `mamba_prefill`, `mamba_logits`, the greedy tokens
of `ServingEngine(cfg, params, freeze=True)` with the JAX defaults and
beside them, `generate_static`, and the float cache's carry-over.

Tolerances: logits atol 1e-4, rtol 1e-5, as tests/test_torch_transformer.py
(the residual stream is integer-valued in both packages; the final
RMSNorm, the head's float32 matmul and here the float attention round
differently by a few ulps); float K/V rows and V scales 1e-6 of their
largest magnitude (rope's cos / sin and the mean round by an ulp); packed
words exactly; the Mamba states 2e-6 as tests/test_torch_ssm.py.

At kv_bits=1 a greedy token may part from JAX's only where packed
attention's weighted V terms cancel exactly (ROADMAP Queue C): each
kv_bits=1 run is repeated with every packed attention output taken from
the JAX oracle on the port's own inputs (tests/test_torch_serving.py's
`_swap_in_jax_attention`), which must give JAX's tokens, and every sign
the two attentions disagree on must be an exact tie; with no tie the
port's own tokens must equal JAX's. The static batch's traffic meets one
such tie (run with -s to print it). The chunked kv_bits=1 phi3 engine and
the chunked falcon-mamba engine are held to JAX in
tests/test_torch_serving.py and tests/test_torch_ssm.py.

falcon-mamba's greedy tokens may part from JAX's only where an input of a
binarized matmul (the normed residual, the conv output, the gated scan
output) is zero to float32 rounding, so softplus, silu and exp, which
round by an ulp apart in the two packages (ROADMAP Queue C), give it
opposite signs: `_mamba_parting` replays such a request step by step and
proves it. The traffic here meets one (request 1, its fourth token; run
with -s to print it); whole-prompt and chunked admission part the same way
(the port's two admissions give equal tokens).

Denormals: XLA's CPU backend (like the TPU) flushes them to zero; torch
keeps them. Where a float attention output is a sum of denormal terms
(softmax weights below 2^-126 on V values of 0 elsewhere), JAX returns 0,
a +1 sign for the next binarized matmul, and the port a denormal of either
sign. This module runs the port with `torch.set_flush_denormal(True)` on
one thread, the float mode the JAX side runs in (ROADMAP Queue C records
the difference).

The JAX side runs inside `tune.gspmd_safe()` (its packed kernels on their
jnp oracles).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.layers import QuantMode as JaxQuantMode
from repro.core.layers import qmatmul as jax_qmatmul
from repro.kernels import tune
from repro.models import ssm as JS
from repro.models import ssm_lm as JL
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy
from repro_torch.core.layers import QuantMode, qmatmul
from repro_torch.models import ssm as S
from repro_torch.models import ssm_lm as L
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import assert_rel, jax_to_np, to_port
from test_torch_serving import _swap_in_jax_attention

LM, SSM = "phi3-medium-14b", "falcon-mamba-7b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals():
    """The port in XLA's float mode (denormals flushed to zero), for this
    module's tests only. The flag is the calling thread's (MXCSR): torch's
    intra-op pool threads, started earlier in the process, keep theirs, so
    the module runs torch on this thread alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX masters, JAX frozen, port masters, port frozen)."""
    jm = jax_get_model(jax_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    jf = jm.freeze(jp)
    return jp, jf, to_port(jax_to_np(jp)), to_port(jax_to_np(jf))


def _prompt(seed, b, s, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _close_logits(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("frozen", [False, True], ids=["masters", "frozen"])
@pytest.mark.parametrize("kv_bits", [0, 1])
def test_transformer_prefill_matches_jax(kv_bits, frozen):
    """Two prompts of 21 tokens (two flash chunks of 16) into a new cache
    of 32 rows: last-position logits and every cache leaf."""
    jp, jf, pp, pf = _params(LM)
    jcfg = jax_smoke(LM).scaled(kv_bits=kv_bits)
    cfg = smoke_config(LM).scaled(kv_bits=kv_bits)
    toks = _prompt(1, 2, 21)
    with tune.gspmd_safe():
        jl, jc = jax.jit(functools.partial(JT.transformer_prefill, cfg=jcfg,
                                           max_len=MAX_LEN))(
            jf if frozen else jp, tokens=jnp.asarray(toks))
    pl, pc = T.transformer_prefill(pf if frozen else pp, cfg,
                                   torch.from_numpy(toks).long(),
                                   max_len=MAX_LEN)
    _close_logits(pl, jl)
    jn, pn = {k: np.asarray(v) for k, v in jc.items()}, cache_to_numpy(pc)
    assert set(pn) == set(jn)
    for name in jn:
        assert pn[name].shape == jn[name].shape, name
        if kv_bits == 1 and name in ("k", "v"):
            np.testing.assert_array_equal(pn[name], jn[name])
        else:
            assert_rel(pn[name], jn[name], rel=1e-6, what=name)


def test_transformer_prefill_writes_slot_rows_in_place():
    """Into a given cache, prompt rows land at slot rows, in place: the
    same leaves as a new cache's at those rows, other slots untouched."""
    _, _, _, pf = _params(LM)
    toks = torch.from_numpy(_prompt(2, 1, 9)).long()
    for kv_bits in (0, 1):
        cfg = smoke_config(LM).scaled(kv_bits=kv_bits)
        cache = T.init_cache(cfg, 3, MAX_LEN, device="cpu")
        for leaf in cache.values():
            leaf.copy_(torch.ones_like(leaf))
        ones = {k: v.clone() for k, v in cache.items()}
        l2, got = T.transformer_prefill(pf, cfg, toks, cache=cache, slot=2)
        assert got is cache
        l1, new = T.transformer_prefill(pf, cfg, toks, max_len=MAX_LEN)
        assert torch.equal(l1, l2)
        for name, leaf in cache.items():
            assert torch.equal(leaf[:, :2], ones[name][:, :2]), name
            if name == "v_scale":
                assert torch.equal(leaf[:, 2], new[name][:, 0])
            else:
                assert torch.equal(leaf[:, 2, :9], new[name][:, 0, :9])
                assert torch.equal(leaf[:, 2, 9:], ones[name][:, 2, 9:])
    paged = T.init_cache(cfg, 2, MAX_LEN, device="cpu", page_size=8)
    with pytest.raises(ValueError, match="chunked"):
        T.transformer_prefill(pf, cfg, toks, cache=paged)


def test_transformer_logits_matches_jax():
    jp, jf, pp, pf = _params(LM)
    toks = _prompt(3, 2, 19)
    for j, p in ((jp, pp), (jf, pf)):
        with tune.gspmd_safe():
            jl, jaux = jax.jit(functools.partial(
                JT.transformer_logits, cfg=jax_smoke(LM)))(
                j, tokens=jnp.asarray(toks))
        pl, aux = get_model(smoke_config(LM)).logits(
            p, torch.from_numpy(toks).long())
        assert pl.shape == (2, 19, 128)
        _close_logits(pl, jl)
        assert float(aux["lb_loss"]) == float(jaux["lb_loss"]) == 0.0


def test_mamba_prefill_and_logits_match_jax():
    """From zero state over the whole prompt (the port's chunk block at
    T = S; JAX's _mamba_chunk_scan): `mamba_prefill` on frozen params
    (logits, the conv history and the SSM state of every layer),
    `mamba_logits` on the masters."""
    jp, jf, pp, pf = _params(SSM)
    jcfg, cfg = jax_smoke(SSM), smoke_config(SSM)
    toks = _prompt(4, 2, 13)
    jl, jc = jax.jit(functools.partial(JL.mamba_prefill, cfg=jcfg))(
        jf, tokens=jnp.asarray(toks))
    pl, pc = L.mamba_prefill(pf, cfg, torch.from_numpy(toks).long())
    _close_logits(pl, jl)
    got = cache_to_numpy(pc)
    for name in ("conv", "h"):
        assert_rel(got[name], np.asarray(jc[name]), rel=2e-6, what=name)
    jall, _ = jax.jit(functools.partial(JL.mamba_logits, cfg=jcfg))(
        jp, tokens=jnp.asarray(toks))
    pall, aux = get_model(cfg).logits(pp, torch.from_numpy(toks).long())
    assert aux == {} and pall.shape == (2, 13, 128)
    _close_logits(pall, jall)


def _hold_to_jax(run, want, kv_bits, monkeypatch, what, mamba_prompts=None):
    """The port's tokens (`run()`) against JAX's `want`: equal at
    kv_bits=0; at kv_bits=1 equal, or parting only at exact ties (see the
    module doc), each printed; falcon-mamba (`mamba_prompts`, the
    requests' prompts): equal, or parting only at a rounding sign
    (`_mamba_parting`), each printed."""
    got = run()
    want = [np.asarray(w) for w in want]
    if mamba_prompts is not None:
        for prompt, a, b in zip(mamba_prompts, got, want, strict=True):
            if not np.array_equal(a, b):
                print(f"{what}: tokens {a.tolist()} part from JAX's "
                      f"{b.tolist()} at a rounding sign: "
                      f"{_mamba_parting(prompt, b.tolist(), a.tolist())}")
        return
    if kv_bits == 0:
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        return
    ties = []
    with monkeypatch.context() as mp:
        _swap_in_jax_attention(mp, ties)
        hybrid = run()
    for a, b in zip(hybrid, want, strict=True):
        np.testing.assert_array_equal(a, b)
    parted = [i for i, (a, b) in enumerate(zip(got, want))
              if not np.array_equal(a, b)]
    if not ties:
        assert not parted
    for step, layer, elem, mine, theirs in ties:
        print(f"{what}: exact tie at {step}, layer {layer}, element (row, "
              f"query, head, d) {elem}: port {mine!r}, JAX {theirs!r}")
    print(f"{what}: requests parting from JAX: {parted}")


def _mamba_step_signs(bp, x, conv, h, cfg, port: bool):
    """One decode step of a Mamba block (its `mamba_block_step`, written
    out) returning (the inputs of its three binarized matmuls as float32
    numpy: normed residual, conv output, gated scan output; the block's
    output; the new conv and SSM state)."""
    if port:
        mode = QuantMode(cfg.quant)
        xn = S.rms_norm(x, bp["ln"]["scale"])
        xi, z = qmatmul(xn, bp["in_proj"], mode).chunk(2, dim=-1)
        xi, conv = S.causal_conv1d(xi, bp["conv_w"], bp["conv_b"], conv)
        xi = torch.nn.functional.silu(xi)
        dt, bm, cm, am = S._ssm_inputs(bp, xi, cfg, mode, "auto")
        y, h = S.scan(dt, xi.contiguous(), bm, cm, am, h, "auto")
        y = (y + bp["D"] * xi.float()).to(x.dtype) * \
            torch.nn.functional.silu(z)
        out = x + qmatmul(y, bp["out_proj"], mode)
        ins = [t.float().numpy() for t in (xn, xi, y)]
        return ins, out, conv, h
    mode = JaxQuantMode(cfg.quant)
    xn = JS.rms_norm(x, bp["ln"]["scale"])
    xi, z = jnp.split(jax_qmatmul(xn, bp["in_proj"], mode), 2, axis=-1)
    xi, conv = JS.causal_conv1d(xi, bp["conv_w"], bp["conv_b"], conv)
    xi = jax.nn.silu(xi)
    a, bx, cm = JS._mamba_ssm_coeffs(bp, xi, cfg, mode, False, None)
    h = a[:, 0] * h + bx[:, 0]
    y = jnp.einsum("bdn,bn->bd", h, cm[:, 0])[:, None]
    y = (y + bp["D"] * xi.astype(jnp.float32)).astype(x.dtype) * \
        jax.nn.silu(z)
    out = x + jax_qmatmul(y, bp["out_proj"], mode)
    return [np.asarray(t, np.float32) for t in (xn, xi, y)], out, conv, h


def _mamba_parting(prompt, want, got) -> str:
    """Why a falcon-mamba request's port tokens `got` part from JAX's
    `want`: replays the request alone in both packages (frozen params,
    each from its own state, both fed JAX's tokens). No binarized-matmul
    input may differ in sign before the step that gives the first parting
    token; in that step the first one that does must be zero to rounding
    on both sides (|x| <= 1e-6 of its tensor's largest magnitude). Returns
    where it was."""
    _, jf, _, pf = _params(SSM)
    jcfg, cfg = jax_smoke(SSM), smoke_config(SSM)
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    assert i > 0, "parting at the first token (prefill) is not explained"
    _, jc = JL.mamba_prefill(jf, jcfg, jnp.asarray(prompt[None]))
    _, pc = L.mamba_prefill(pf, cfg, torch.from_numpy(prompt[None]).long())
    jc = dict(jc)
    for step, tok in enumerate(want[:i]):
        xj = jf["embed"][jnp.asarray([[tok]])].astype(jcfg.activation_dtype)
        xp = pf["embed"][torch.tensor([[int(tok)]])].to(cfg.activation_dtype)
        for layer in range(cfg.n_layers):
            ins_j, xj, cj, hj = _mamba_step_signs(
                jax.tree.map(lambda a: a[layer], jf["blocks"]), xj,
                jc["conv"][layer], jc["h"][layer], jcfg, port=False)
            ins_p, xp, cp, hp = _mamba_step_signs(
                T.layer_params(pf, layer), xp, pc["conv"][layer],
                pc["h"][layer], cfg, port=True)
            jc["conv"] = jc["conv"].at[layer].set(cj)
            jc["h"] = jc["h"].at[layer].set(hj)
            pc["conv"][layer], pc["h"][layer] = cp, hp
            for name, a, b in zip(("xn", "xi", "y"), ins_j, ins_p):
                flip = (a >= 0) != (b >= 0)
                if not flip.any():
                    continue
                assert step == i - 1, f"a sign parts at step {step}"
                floor = 1e-6 * np.abs(a).max()
                assert np.abs(a[flip]).max() <= floor and \
                    np.abs(b[flip]).max() <= floor, (name, a[flip], b[flip])
                return (f"decode step {step + 1}, layer {layer}, input of "
                        f"{name}'s matmul: JAX {a[flip].tolist()}, port "
                        f"{b[flip].tolist()} (largest |x| {np.abs(a).max()})")
    raise AssertionError("no binarized input parts in the parting step")


def _traffic(seed, vocab=128):
    """Four requests of two prompt lengths (whole-prompt admission compiles
    one JAX prefill per length; 18 spans two flash chunks), budgets 2-6,
    through 2 slots."""
    rng = np.random.default_rng(seed)
    lens, budgets = (6, 18, 18, 6), (4, 6, 2, 5)
    return [(rng.integers(0, vocab, n).astype(np.int32), b)
            for n, b in zip(lens, budgets)]


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(arch, kv_bits, prefill_chunk):
    jp = _params(arch)[0]
    with tune.gspmd_safe():
        out = JaxEngine(jax_smoke(arch), jp, freeze=True, slots=2,
                        max_len=MAX_LEN, kv_bits=kv_bits,
                        prefill_chunk=prefill_chunk).generate(
            [JaxRequest(p, max_new_tokens=b) for p, b in _traffic(5)])
    return [np.asarray(t) for t in out]


# case -> (arch, the port engine's options); the paged case is held to the
# JAX chunked engine's tokens (JAX's paged engine gives those, its own
# contract), so four JAX engines serve five cases
ENGINE_CASES = {
    "whole kv0": (LM, dict()),
    "whole kv1": (LM, dict(kv_bits=1)),
    "chunked kv0": (LM, dict(prefill_chunk=4)),
    "paged kv0": (LM, dict(prefill_chunk=4, page_size=8)),
    "ssm whole": (SSM, dict()),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_match_jax(case, monkeypatch):
    """`ServingEngine(cfg, params, freeze=True, ...)` with the JAX defaults
    (whole-prompt admission, float cache) and beside them: greedy tokens
    equal the JAX engine's on the same masters (kv_bits=1: see
    `_hold_to_jax`)."""
    arch, kw = ENGINE_CASES[case]
    pp = _params(arch)[2]
    kv_bits = kw.get("kv_bits", 0)
    want = _jax_engine_tokens(arch, kv_bits, kw.get("prefill_chunk"))
    _hold_to_jax(lambda: ServingEngine(
        smoke_config(arch), pp, freeze=True, slots=2, max_len=MAX_LEN,
        **kw).generate([Request(p, max_new_tokens=b)
                        for p, b in _traffic(5)]),
        want, kv_bits, monkeypatch, case,
        [p for p, _ in _traffic(5)] if arch == SSM else None)


@pytest.mark.parametrize("arch", [LM, SSM])
def test_whole_prompt_tokens_equal_chunked(arch):
    """The contract of tests/test_prefill_chunking.py: prompts below, at
    and off the chunk size, more requests than slots; whole-prompt
    admission gives the chunked scheduler's tokens (kv_bits=0, masters),
    and counts one prefill shape per prompt length."""
    _, _, pp, _ = _params(arch)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, 128, n).astype(np.int32),
                    max_new_tokens=b)
            for n, b in ((5, 4), (11, 3), (3, 5), (8, 2))]
    cfg = smoke_config(arch)
    whole = ServingEngine(cfg, pp, slots=2, max_len=24)
    chunked = ServingEngine(cfg, pp, slots=2, max_len=24, prefill_chunk=4,
                            interleave_steps=2)
    for a, b in zip(whole.generate(reqs), chunked.generate(reqs),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    sched = whole.scheduler()
    assert sched.prefill_shape_count == 4
    assert sched.stats["prefill_tokens"] == 27


@pytest.mark.parametrize("arch,kv_bits", [(LM, 0), (LM, 1), (SSM, 0)])
def test_generate_static_matches_jax(arch, kv_bits, monkeypatch):
    """Four prompts of one length, budgets 1-5 (kv_bits=1: see
    `_hold_to_jax`; this traffic meets an exact tie at its first decode
    step, layer 0, which parts request 1 from JAX)."""
    jp, _, pp, _ = _params(arch)
    prompts = _prompt(6, 4, 7)
    budgets = (3, 5, 1, 4)
    with tune.gspmd_safe():
        want = JaxEngine(jax_smoke(arch), jp, freeze=True, kv_bits=kv_bits,
                         max_len=MAX_LEN).generate_static(
            [JaxRequest(p, max_new_tokens=b)
             for p, b in zip(prompts, budgets)])
    eng = ServingEngine(smoke_config(arch), pp, freeze=True, kv_bits=kv_bits,
                        max_len=MAX_LEN)

    def run():
        got = eng.generate_static([Request(p, max_new_tokens=b)
                                   for p, b in zip(prompts, budgets)])
        assert [len(t) for t in got] == list(budgets)
        return got
    _hold_to_jax(run, want, kv_bits, monkeypatch, f"static {arch}",
                 list(prompts) if arch == SSM else None)


def test_static_and_paged_options_raise():
    """Where the JAX package asserts, the port raises ValueError: paged KV
    without a prefill chunk, a static batch of ragged prompts, an empty
    static batch; a static batch past max_len too. A sampled static batch
    is reproducible from the engine's seed."""
    _, _, pp, _ = _params(LM)
    cfg = smoke_config(LM)
    with pytest.raises(ValueError, match="chunked admission"):
        ServingEngine(cfg, pp, freeze=True, page_size=8)
    eng = ServingEngine(cfg, pp, freeze=True, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="same-length"):
        eng.generate_static([Request(np.arange(3)), Request(np.arange(4))])
    with pytest.raises(ValueError, match="empty"):
        eng.generate_static([])
    with pytest.raises(ValueError, match="max_len"):
        eng.generate_static([Request(np.arange(30), max_new_tokens=4)])
    # a sampled row draws from the engine's seeded generator: the same
    # seed gives the same tokens, the greedy row the argmax
    reqs = [Request(np.arange(5), max_new_tokens=4, temperature=1.0),
            Request(np.arange(5) + 1, max_new_tokens=3)]
    a, b = (ServingEngine(cfg, pp, freeze=True, max_len=MAX_LEN, seed=3)
            .generate_static(reqs) for _ in range(2))
    greedy = eng.generate_static([Request(np.arange(5), max_new_tokens=4),
                                  reqs[1]])
    assert [len(t) for t in a] == [4, 3]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], greedy[1])


def test_float_cache_round_trips():
    """The float cache carries across both ways: the JAX cache of
    `init_cache` and of `transformer_prefill` (kv_bits=0), bf16 leaves,
    and paged float pools (the port's get their sink pages)."""
    jp, _, _, _ = _params(LM)
    jcfg = jax_smoke(LM)
    with tune.gspmd_safe():
        _, filled = JT.transformer_prefill(jp, jcfg, jnp.asarray(
            _prompt(7, 1, 6)), max_len=8)
    for jc in (JT.init_cache(jcfg, 2, 8), filled,
               JT.init_cache(jcfg.scaled(dtype="bfloat16"), 2, 8),
               JT.init_cache(jcfg, 2, 8, page_size=4, pool_pages=3)):
        jn = {k: np.asarray(v) for k, v in jc.items()}
        port = cache_from_numpy(jn, device="cpu")
        back = cache_to_numpy(port)
        for name in jn:
            assert port[name].dtype == getattr(torch, jn[name].dtype.name), \
                name
            np.testing.assert_array_equal(back[name],
                                          jn[name].astype(back[name].dtype))
        if "page_table" in jn:
            assert T._with_sink(port["k"][0]).shape[0] == 4
    bf = JT.init_cache(jcfg.scaled(dtype="bfloat16"), 1, 4)
    vals = np.random.default_rng(8).normal(size=bf["k"].shape)
    jn = {"k": jnp.asarray(vals, jnp.bfloat16), "v": bf["v"]}
    port = cache_from_numpy({k: np.asarray(v) for k, v in jn.items()},
                            device="cpu")
    assert port["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(cache_to_numpy(port)["k"],
                                  np.asarray(jn["k"].astype(jnp.float32)))
