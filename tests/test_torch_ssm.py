"""The port's Mamba stack (falcon-mamba-7b, `repro_torch.models.ssm`,
`models.ssm_lm`) against the JAX package's, on the smoke config (3 layers,
d 64, d_inner 128, N 4, dt_rank 8, float32), on fp32 masters and on frozen
params; and the engine, scheduler and config behaviour of the `ssm` family.

Tolerances, each against the JAX side run eagerly (not jitted) with the
same numpy-seeded inputs and the same params carried across:
  * the causal conv and its state: exact (the same products and sums in
    the same order);
  * block outputs and recurrent states: 2e-6 of each tensor's largest
    magnitude. The block's float parts (softplus of the dt projection, the
    scan's exp, silu) round differently in XLA and torch by an ulp or two,
    and the scan takes exp in float64 (kernel 10's order). The binary
    projections read only signs, so the residual stream stays equal;
  * logits: atol 1e-4, rtol 1e-5, as for the transformer (the final
    RMSNorm and the head's float32 matmul round differently).
The engine's greedy tokens must equal the JAX engine's (traffic seeds
0-3); none parts there, so no tie needs proving.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.layers import QuantMode as JaxQuantMode
from repro.models import ssm as JS
from repro.models import ssm_lm as JL
from repro.models.api import cache_batch_axes as jax_cache_batch_axes
from repro.models.api import get_model as jax_get_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.base import get_config, list_archs
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import (
    cache_from_numpy, cache_to_numpy, from_numpy_tree, to_numpy_tree,
)
from repro_torch.core.layers import QuantMode
from repro_torch.core.packed import PackedWeight, map_tree
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import ssm as S
from repro_torch.models import ssm_lm as L
from repro_torch.models import transformer as T
from repro_torch.models.api import cache_batch_axes, get_model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import assert_rel, jax_to_np, to_port

ARCH = "falcon-mamba-7b"
REL = 2e-6
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
ENGINE = dict(prefill_chunk=4, slots=2, max_len=32)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, port cfg, JAX masters, JAX frozen, port masters, port
    frozen), the port's carried across from the JAX trees."""
    jcfg, cfg = jax_smoke(ARCH), smoke_config(ARCH)
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jf = jm.freeze(jp)
    return jcfg, cfg, jp, jf, to_port(jax_to_np(jp)), to_port(jax_to_np(jf))


@pytest.fixture(scope="module")
def jax_engine(models):
    """One JAX engine (its jitted steps compile once) for every seed."""
    jcfg, _, jp, _, _, _ = models
    return JaxEngine(jcfg, jp, freeze=True, **ENGINE)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def test_causal_conv1d_and_conv_state_match_jax():
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(2, 5, 16)), rng.normal(size=(4, 16))
    b, st = rng.normal(size=16), rng.normal(size=(2, 3, 16))
    x, w, b, st = (a.astype(np.float32) for a in (x, w, b, st))
    for state in (None, st):
        jy, js = JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), None if state is None
                                  else jnp.asarray(state))
        py, ps = S.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), None if state is None
                                 else torch.from_numpy(state))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for n_valid in (1, 3, 5):
        want = JS._conv_state_at(jnp.asarray(st), jnp.asarray(x), n_valid, 4)
        got = S._conv_state_at(torch.from_numpy(st), torch.from_numpy(x),
                               n_valid, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("n_valid", [6, 3])
def test_mamba_block_chunk_matches_jax(models, frozen, n_valid):
    """One block over a 6-row chunk from nonzero state, full and with pad
    rows (n_valid 3): outputs, the conv history and the SSM state."""
    jcfg, cfg, jp, jf, pp, pf = models
    jtree, ptree = (jf, pf) if frozen else (jp, pp)
    rng = np.random.default_rng(1)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    x = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    cs = rng.normal(size=(1, cfg.d_conv - 1, di)).astype(np.float32)
    h0 = (rng.normal(size=(1, di, n)) * 0.5).astype(np.float32)
    jy, jcs, jh = JS.mamba_block_chunk(
        _layer(jtree["blocks"], 1), jnp.asarray(x), jnp.asarray(cs),
        jnp.asarray(h0), jnp.int32(n_valid), jcfg,
        JaxQuantMode(jcfg.quant), chunk=4)
    py, pcs, ph = S.mamba_block_chunk(
        T.layer_params(ptree, 1), torch.from_numpy(x), torch.from_numpy(cs),
        torch.from_numpy(h0), n_valid, cfg, QuantMode(cfg.quant))
    assert_rel(_np(py), jy, REL, "y")
    np.testing.assert_array_equal(_np(pcs), np.asarray(jcs))
    assert_rel(_np(ph), jh, REL, "h")


@pytest.mark.parametrize("frozen", [False, True])
def test_mamba_block_step_matches_jax(models, frozen):
    jcfg, cfg, jp, jf, pp, pf = models
    jtree, ptree = (jf, pf) if frozen else (jp, pp)
    rng = np.random.default_rng(2)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cs = rng.normal(size=(3, cfg.d_conv - 1, di)).astype(np.float32)
    h = (rng.normal(size=(3, di, n)) * 0.5).astype(np.float32)
    jy, jcs, jh = JS.mamba_block_step(
        _layer(jtree["blocks"], 2), jnp.asarray(x), jnp.asarray(cs),
        jnp.asarray(h), jcfg, JaxQuantMode(jcfg.quant))
    py, pcs, ph = S.mamba_block_step(
        T.layer_params(ptree, 2), torch.from_numpy(x), torch.from_numpy(cs),
        torch.from_numpy(h), cfg, QuantMode(cfg.quant))
    assert_rel(_np(py), jy, REL, "y")
    np.testing.assert_array_equal(_np(pcs), np.asarray(jcs))
    assert_rel(_np(ph), jh, REL, "h")


def _assert_state(jc, pc):
    pn = cache_to_numpy(pc)
    np.testing.assert_array_equal(pn["conv"], np.asarray(jc["conv"]))
    assert_rel(pn["h"], np.asarray(jc["h"]), REL, "h")


def test_prefill_chunks_then_decode_match_jax(models):
    """Frozen params: a 10-token prompt admitted into slot 1 in chunks of 4
    (the last one padded), over a slot 1 holding a stale state, then three
    decode steps with slot 0 inactive: logits and states after each."""
    jcfg, cfg, _, jf, _, pf = models
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 10)
    jc = JL.mamba_init_state(jcfg, 2)
    jc = {k: v.at[:, 1].set(1.5) for k, v in jc.items()}       # stale
    pc = cache_from_numpy({k: np.asarray(v) for k, v in jc.items()},
                          device="cpu")
    for lo in range(0, 10, 4):
        nv = min(4, 10 - lo)
        ch = np.zeros((1, 4), np.int32)
        ch[0, :nv] = prompt[lo:lo + nv]
        jl, jc = JL.mamba_prefill_chunk(jf, jcfg, jnp.asarray(ch), jc, 1, lo,
                                        nv)
        pl, pc = L.mamba_prefill_chunk(pf, cfg, torch.from_numpy(ch), pc, 1,
                                       lo, nv)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_state(jc, pc)
    tok = int(np.asarray(jl).argmax())
    for step in range(3):
        token = np.array([7, tok], np.int32)
        pos = np.array([-1, 10 + step], np.int32)
        jl, jc = JL.mamba_decode(jf, jcfg, jnp.asarray(token), jc,
                                 jnp.asarray(pos))
        pl, pc = L.mamba_decode(pf, cfg, torch.from_numpy(token), pc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_state(jc, pc)
        tok = int(np.asarray(jl)[1].argmax())


def test_inactive_rows_keep_state_and_first_chunk_resets_it(models):
    """A decode row with pos < 0 leaves its state bit for bit; a first
    chunk (pos 0) starts from zeros whatever the slot held."""
    _, cfg, _, _, _, pf = models
    state = L.mamba_init_state(cfg, 2, device="cpu")
    for leaf in state.values():
        leaf.normal_(generator=torch.Generator().manual_seed(0))
    snap = {k: v.clone() for k, v in state.items()}
    L.mamba_decode(pf, cfg, torch.tensor([3, 4]), state,
                   torch.tensor([5, -1], dtype=torch.int32))
    for k in state:
        assert torch.equal(state[k][:, 1], snap[k][:, 1]), k
        assert not torch.equal(state[k][:, 0], snap[k][:, 0]), k
    fresh = L.mamba_init_state(cfg, 2, device="cpu")
    ch = torch.tensor([[3, 1, 4, 1]])
    la, _ = L.mamba_prefill_chunk(pf, cfg, ch, state, 0, 0, 3)
    lb, _ = L.mamba_prefill_chunk(pf, cfg, ch, fresh, 0, 0, 3)
    assert torch.equal(la, lb)
    for k in state:
        assert torch.equal(state[k][:, 0], fresh[k][:, 0]), k


def test_config_fields_equal_jax():
    """falcon-mamba-7b, full and smoke, field by field; the port's
    registry holds every arch of the JAX registry, the vlm and moe archs
    among them."""
    for port_cfg, jax_cfg in ((get_config(ARCH), jax_get_config(ARCH)),
                              (smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        assert port_cfg.activation_dtype == getattr(
            torch, jnp.dtype(jax_cfg.activation_dtype).name)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.expand, full.ssm_state,
            full.dt_rank, full.d_conv, full.vocab) == \
        (64, 4096, 2, 16, 256, 4, 65024)
    assert not full.tie_embeddings and full.quant == "bbp_det"
    from repro.configs.base import list_archs as jax_list_archs
    assert list_archs() == sorted(jax_list_archs())
    assert get_config("llama-3.2-vision-11b").family == "vlm"
    assert get_config("dbrx-132b").family == "moe"


def test_cache_batch_axes_on_the_ssm_state():
    cfg = smoke_config(ARCH)
    m = get_model(cfg)
    assert cache_batch_axes(m, 40) == {"conv": 1, "h": 1}
    assert cache_batch_axes(m, 40) == jax_cache_batch_axes(
        jax_get_model(jax_smoke(ARCH)), 40)
    c = m.init_cache(3, 40, device="cpu")
    jc = JL.mamba_init_state(jax_smoke(ARCH), 3)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert c["conv"].dtype == cfg.activation_dtype
    assert c["h"].dtype == torch.float32
    bf = get_model(cfg.scaled(dtype="bfloat16")).init_cache(1, 8,
                                                            device="cpu")
    assert bf["conv"].dtype == torch.bfloat16 and bf["h"].dtype == \
        torch.float32


def test_params_and_state_round_trip(models):
    """Stacked masters and frozen trees (in/x/out_proj PackedWeights with a
    leading L axis) carry across and back; so does the {conv, h} state, a
    bf16 conv history included."""
    _, cfg, jp, jf, pp, pf = models
    for jtree, ptree in ((jp, pp), (jf, pf)):
        want = jax_to_np(jtree)
        back = to_numpy_tree(ptree)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
    for key in ("in_proj", "x_proj", "out_proj"):
        w = pf["blocks"][key]
        assert isinstance(w, PackedWeight) and w.packed.shape[0] == 3
    for key in ("dt_w", "A_log", "conv_w", "D", "dt_b"):
        assert isinstance(pf["blocks"][key], torch.Tensor)
    again = to_numpy_tree(from_numpy_tree(jax_to_np(jf), device="cpu"))
    for a, b in zip(jax.tree.leaves(jax_to_np(jf)), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    jstate = JL.mamba_init_state(jax_smoke(ARCH).scaled(dtype="bfloat16"), 2)
    jstate = {k: (v + rng.normal(size=v.shape)).astype(v.dtype)
              for k, v in jstate.items()}
    state = cache_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             device="cpu")
    assert state["conv"].dtype == torch.bfloat16
    back = cache_to_numpy(state)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k],
                                      np.asarray(v.astype(jnp.float32)))


def test_init_frozen_rules(models):
    """init_frozen draws and freezes one layer at a time the tree that
    freeze(init(...)) gives: same leaves, shapes and packing; the JAX init
    rules (A_log = log(1..N), D ones, softplus(dt_b) in [1e-3, 1e-1], conv
    bias and norm scales 0); layers drawn apart; the engine serves it."""
    _, cfg, _, _, _, _ = models
    m = get_model(cfg)
    masters = m.init(torch.Generator().manual_seed(4), device="cpu")
    want = m.freeze(masters)
    got = m.init_frozen(torch.Generator().manual_seed(4), device="cpu")
    leaves, got_leaves = [], []
    map_tree(lambda name, p: leaves.append((name, p)), want)
    map_tree(lambda name, p: got_leaves.append((name, p)), got)
    assert [n for n, _ in got_leaves] == [n for n, _ in leaves]
    for (name, a), (_, b) in zip(got_leaves, leaves):
        assert type(a) is type(b), name
        if isinstance(a, PackedWeight):
            assert (a.k, a.kind, a.packed.shape) == \
                (b.k, b.kind, b.packed.shape), name
        else:
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    for tree in (masters, got):
        blk = tree["blocks"]
        a_log = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                       dtype=torch.float32))
        assert torch.equal(blk["A_log"], a_log.expand_as(blk["A_log"]))
        assert torch.equal(blk["D"], torch.ones_like(blk["D"]))
        assert not blk["conv_b"].any() and not blk["ln"]["scale"].any()
        dt = torch.nn.functional.softplus(blk["dt_b"])
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert abs(float(masters["blocks"]["in_proj"].std()) - 0.02) < 2e-3
    assert torch.equal(got["embed"], want["embed"])
    inp = got["blocks"]["in_proj"].packed
    assert not torch.equal(inp[0], inp[1])
    eng = ServingEngine(cfg, got, freeze=True, **ENGINE)
    assert eng.params is got
    assert len(eng.generate([Request(np.arange(5), max_new_tokens=3)])[0]) \
        == 3


def _traffic(seed, vocab=128):
    """Ragged prompts (1..19 tokens), per-request budgets; more requests
    than the engine's two slots."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 20, 5)
    budgets = rng.integers(2, 8, 5)
    return [(rng.integers(0, vocab, n).astype(np.int32), int(b))
            for n, b in zip(lens, budgets)]


@pytest.mark.parametrize("seed", range(4))
def test_engine_tokens_match_jax(models, jax_engine, seed):
    """ServingEngine(freeze=True, prefill_chunk=4, 2 slots) on ragged
    traffic gives the JAX engine's greedy tokens; on seed 0 one request
    stops at an eos taken from its own greedy run."""
    _, cfg, _, _, pp, _ = models
    reqs = _traffic(seed)
    eos = None
    if seed == 0:
        alone = ServingEngine(cfg, pp, freeze=True, **ENGINE).generate(
            [Request(reqs[2][0], max_new_tokens=reqs[2][1])])[0]
        eos = int(alone[1])
    got = ServingEngine(cfg, pp, freeze=True, **ENGINE).generate(
        [Request(p, max_new_tokens=b, eos_id=eos if i == 2 else None)
         for i, (p, b) in enumerate(reqs)])
    want = jax_engine.generate(
        [JaxRequest(p, max_new_tokens=b, eos_id=eos if i == 2 else None)
         for i, (p, b) in enumerate(reqs)])
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    if eos is not None:
        assert got[2][-1] == eos and len(got[2]) <= 2


def test_engine_options_behave_as_jax_for_ssm(models, jax_engine):
    """kv_bits has no effect and page_size / pool_pages / prefix_cache are
    ignored for the ssm family, as in the JAX engine: every such engine
    gives the same tokens and state bytes, and no paging or V-scale path
    is taken. Attention families keep their checks."""
    jcfg, cfg, jp, _, pp, _ = models
    reqs = [Request(p, max_new_tokens=b) for p, b in _traffic(1)[:3]]
    base = ServingEngine(cfg, pp, freeze=True, **ENGINE)
    want = base.generate(reqs)
    jeng = JaxEngine(jcfg, jp, freeze=True, page_size=8, prefix_cache=True,
                     kv_bits=1, **ENGINE)
    jsched = jeng.scheduler()
    assert not jsched._paged and not jsched._use_tree \
        and not jsched._needs_vs
    for kw in (dict(kv_bits=0), dict(kv_bits=1), dict(page_size=8),
               dict(page_size=8, pool_pages=3, prefix_cache=True),
               dict(prefix_cache=True), dict(pool_pages=5)):
        eng = ServingEngine(cfg, pp, freeze=True, **ENGINE, **kw)
        sched = eng.scheduler()
        assert not sched._paged and not sched._use_tree \
            and not sched._needs_vs, kw
        assert sched.page_stats() is None
        for a, b in zip(eng.generate(reqs), want, strict=True):
            np.testing.assert_array_equal(a, b)
        assert eng.resident_cache_bytes() == base.resident_cache_bytes()
    di = cfg.expand * cfg.d_model
    c = base.resident_cache_bytes()
    assert c == {"packed": 0, "total": c["float"],
                 "float": cfg.n_layers * 2 * (cfg.d_conv - 1) * di * 4
                 + cfg.n_layers * 2 * di * cfg.ssm_state * 4}
    w = base.resident_weight_bytes()
    d, n, r = cfg.d_model, cfg.ssm_state, cfg.dt_rank
    per_layer = d * 2 * di + di * (r + 2 * n) + di * d      # in, x, out
    assert w["binary"] == cfg.n_layers * per_layer // 8
    dense = smoke_config("phi3-medium-14b")
    dp = get_model(dense.scaled(kv_bits=1)).init(
        torch.Generator().manual_seed(0), device="cpu")
    # the float KV cache serves the dense family now: K/V in its dtype
    float_eng = ServingEngine(dense, dp, freeze=True, kv_bits=0,
                              prefill_chunk=4, max_len=32)
    assert len(float_eng.generate(reqs[:1])[0]) == reqs[0].max_new_tokens
    assert float_eng.resident_cache_bytes()["packed"] == 0
    with pytest.raises(ValueError, match="prefix_cache needs the paged"):
        ServingEngine(dense, dp, freeze=True, kv_bits=1, prefill_chunk=4,
                      max_len=32, prefix_cache=True)


def test_ssm_path_runs_the_plain_scan_on_cpu_and_unported_families_raise(
        models):
    """On the CPU, path 'auto' (kernel 10's wrapper) and 'ref' give the same
    tokens and launch nothing; the vlm and moe families serve, and the
    transformer's serving check refuses the ssm family. Whole-prompt
    prefill serves: `Model.prefill` gives the logits of the last chunk of a
    chunked admission of the same prompt, and the whole-prompt engine the
    chunked engine's tokens."""
    _, cfg, _, _, pp, _ = models
    reqs = [Request(p, max_new_tokens=b) for p, b in _traffic(2)[:2]]
    ss.reset_launches()
    auto = ServingEngine(cfg, pp, freeze=True, **ENGINE).generate(reqs)
    ref = ServingEngine(cfg, pp, freeze=True, kernel_path="ref",
                        **ENGINE).generate(reqs)
    for a, b in zip(auto, ref, strict=True):
        np.testing.assert_array_equal(a, b)
    assert ss.launches["selective_scan"] == 0
    assert get_model(smoke_config("llama-3.2-vision-11b")).cfg.family == \
        "vlm"
    assert get_model(smoke_config("llama4-scout-17b-a16e")).cfg.family == \
        "moe"
    frozen = ServingEngine(cfg, pp, freeze=True, **ENGINE).params
    prompt = torch.tensor([[5, 1, 7]])
    whole, _ = get_model(cfg).prefill(frozen, prompt)
    state = L.mamba_init_state(cfg, 1, device="cpu")
    chunked, _ = L.mamba_prefill_chunk(frozen, cfg, prompt, state, 0, 0, 3)
    assert_rel(whole.numpy(), chunked.numpy(), what="whole vs chunked")
    with pytest.raises(NotImplementedError):
        T.init_cache(cfg.scaled(kv_bits=1), 1, 8, device="cpu")
    got = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=32,
                        prefill_chunk=None).generate(reqs)
    for a, b in zip(got, auto, strict=True):
        np.testing.assert_array_equal(a, b)
