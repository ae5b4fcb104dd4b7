"""What a slot and an engine carry from one request to the next, on the
CPU: whole-prompt admission into a slot whose last occupant left
non-finite V rows behind, and `ServingEngine.freeze(kv_bits=...)` on a
live engine (tests/test_decode_attention_packed.py's
test_freeze_kv_bits_switches_cache_layout, against the JAX engine).

Stale rows. The JAX scheduler overwrites a slot's whole cache row at
whole-prompt admission; the port writes the prompt's rows and zeroes the
rest of a float cache's row (`models.transformer.transformer_prefill`).
Rows past the prompt are masked by length, but a masked softmax weight 0
times a NaN V is NaN, so without the zeroing a request admitted whole
behind one that left NaN V decodes non-finite logits and errors. Each test
writes NaN into every slot's V rows past the next prompt (for the vlm also
into every image V row), admits that prompt whole, and holds its tokens to
a clean run: the JAX engine's for phi3-medium-14b, the port's own clean
engine for the recurrentgemma-2b ring (rewritten whole at admission) and
the llama-3.2-vision-11b self and image K/V, whose clean engines are held
to JAX in tests/test_torch_hybrid.py and tests/test_torch_vlm_serving.py.

Params: one numpy tree per arch carried into both packages
(`_torch_families.params`). Tokens exactly, the port in XLA's float mode
(`test_torch_whole_prompt._flush_denormals`); at kv_bits=1 a token may
part from JAX's only at an exact tie of packed attention
(`test_torch_whole_prompt._hold_to_jax`, ROADMAP Queue C).
"""
import numpy as np
import pytest

from repro.kernels import tune
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.serving.engine import Request, ServingEngine

from _torch_families import params
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)
from test_torch_whole_prompt import _hold_to_jax

MAX_LEN = 32
LONG, SHORT, NEW = 20, 7, 6


def _prompts(seed, vocab=128):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, LONG).astype(np.int32),
            rng.integers(0, vocab, SHORT).astype(np.int32))


def _poison_past(cache, names, s):
    """NaN into every slot's rows [s, T) of each named K/V leaf (batch
    axis -4, positions -3)."""
    for name in names:
        cache[name][..., s:, :, :] = float("nan")


def test_whole_prompt_admission_ignores_stale_nan_v():
    jcfg, cfg, _, jf, _, pf = params("phi3-medium-14b")
    long_p, short_p = _prompts(3)
    eng = ServingEngine(cfg, pf, slots=2, max_len=MAX_LEN)
    eng.generate([Request(long_p, max_new_tokens=4),
                  Request(long_p[::-1].copy(), max_new_tokens=4)])
    _poison_past(eng.scheduler()._cache, ("v",), SHORT)
    got = eng.serve([Request(short_p, max_new_tokens=NEW)])[0]
    assert got.status == "completed", got.error
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jf, slots=2, max_len=MAX_LEN).generate(
            [JaxRequest(short_p, max_new_tokens=NEW)])[0]
    np.testing.assert_array_equal(got.tokens, np.asarray(want))


def test_hybrid_ring_admission_ignores_stale_nan_v():
    _, cfg, _, _, _, pf = params("recurrentgemma-2b")
    long_p, short_p = _prompts(4)
    assert SHORT < cfg.local_window     # ring rows past the prompt exist
    eng = ServingEngine(cfg, pf, slots=2, max_len=MAX_LEN)
    eng.generate([Request(long_p, max_new_tokens=4)] * 2)
    _poison_past(eng.scheduler()._cache, ("attn_v",), SHORT)
    got = eng.serve([Request(short_p, max_new_tokens=NEW)])[0]
    clean = ServingEngine(cfg, pf, slots=2, max_len=MAX_LEN).generate(
        [Request(short_p, max_new_tokens=NEW)])[0]
    assert got.status == "completed", got.error
    np.testing.assert_array_equal(got.tokens, clean)


def test_vlm_admission_ignores_stale_nan_v_and_image_v():
    _, cfg, _, _, _, pf = params("llama-3.2-vision-11b")
    long_p, short_p = _prompts(5)
    rng = np.random.default_rng(6)
    img = [rng.normal(size=(cfg.n_img_tokens, cfg.d_vision))
           .astype(np.float32) for _ in range(2)]
    eng = ServingEngine(cfg, pf, slots=2, max_len=MAX_LEN)
    eng.generate([Request(long_p, max_new_tokens=4, img_emb=img[0])] * 2)
    cache = eng.scheduler()._cache
    _poison_past(cache, ("v",), SHORT)
    _poison_past(cache, ("xv",), 0)
    got = eng.serve([Request(short_p, max_new_tokens=NEW,
                             img_emb=img[1])])[0]
    clean = ServingEngine(cfg, pf, slots=2, max_len=MAX_LEN).generate(
        [Request(short_p, max_new_tokens=NEW, img_emb=img[1])])[0]
    assert got.status == "completed", got.error
    np.testing.assert_array_equal(got.tokens, clean)


def _traffic(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, n).astype(np.int32), b)
            for n, b in ((5, 4), (9, 6), (3, 4))]


def test_freeze_kv_bits_switches_cache_layout(monkeypatch):
    """freeze(kv_bits=1) on a live engine of fp32 masters freezes the
    weights and rebuilds model and cache: the packed cache allocates sign
    bitplanes, and the tokens equal the JAX engine's after the same
    switch. kv_bits outside {0, 1} raises, at construction and here."""
    jcfg, cfg, jp, _, pp, _ = params("qwen2-72b")
    reqs = _traffic()
    eng = ServingEngine(cfg, pp, max_len=16, slots=2)
    assert eng.resident_cache_bytes()["packed"] == 0
    assert all(len(t) == b for t, (_, b) in
               zip(eng.generate([Request(p, max_new_tokens=b)
                                 for p, b in reqs]), reqs))
    eng.freeze(kv_bits=1)
    assert eng.frozen and eng.cfg.kv_bits == 1
    assert eng.resident_cache_bytes()["packed"] > 0
    with tune.gspmd_safe():
        jeng = JaxEngine(jcfg, jp, max_len=16, slots=2)
        jeng.freeze(kv_bits=1)
        want = jeng.generate([JaxRequest(p, max_new_tokens=b)
                              for p, b in reqs])
    _hold_to_jax(lambda: eng.generate([Request(p, max_new_tokens=b)
                                       for p, b in reqs]),
                 want, 1, monkeypatch, "qwen2 after freeze(kv_bits=1)")
    with pytest.raises(ValueError, match="kv_bits"):
        ServingEngine(cfg, pp, max_len=16, kv_bits=3)
    with pytest.raises(ValueError, match="kv_bits"):
        eng.freeze(kv_bits=3)


def test_freeze_refuses_requests_in_flight():
    """Freezing the weights, or switching the cache of a frozen engine,
    with a request in flight raises RuntimeError and changes nothing; once
    drained, the switch goes through."""
    _, cfg, _, _, pp, pf = params("qwen2-72b")
    for tree, calls in ((pp, ({}, {"kv_bits": 1})), (pf, ({"kv_bits": 1},))):
        eng = ServingEngine(cfg, tree, max_len=16, slots=2)
        frozen = eng.frozen
        sched = eng.scheduler()
        for p, b in _traffic()[:2]:
            sched.submit(Request(p, max_new_tokens=b))
        sched.poll()                     # the 4-token request completes
        assert not sched.idle
        for kw in calls:
            with pytest.raises(RuntimeError, match="in flight"):
                eng.freeze(**kw)
        assert eng.frozen == frozen and eng.cfg.kv_bits == 0
        assert eng.scheduler() is sched
        sched.run()
        eng.freeze(kv_bits=1)
        assert eng.frozen and eng.cfg.kv_bits == 1
        assert eng.scheduler() is not sched
