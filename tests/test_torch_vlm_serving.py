"""llama-3.2-vision-11b (the vlm family) served by the port's engine against
the JAX package's, at smoke size: greedy tokens of the chunked, whole-prompt
and paged engines at kv_bits 0 and 1 (paged with the prefix cache on, which
the vlm family ignores: no hits), each request with its own image; the
paged engine's tokens equal the contiguous one's; images are checked at
submit; `generate_static` refuses the family (it passes no image).

Params and traffic come from tests/_torch_families.py (every leaf drawn
non-zero, the cross gates N(0, 1)); image embeddings are N(0, 1). Tokens
are held to JAX's through `test_torch_vlm.hold_to_jax`: equal, or parting
only where an attention output's sign is below float32 resolution (exact
ties), each printed. The module runs torch on one thread with denormals
flushed to zero (`test_torch_whole_prompt._flush_denormals`).
"""
import numpy as np
import pytest

from repro.kernels import tune
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.serving.engine import Request, RequestError, ServingEngine

import _torch_families as F
from test_torch_vlm import ARCH, hold_to_jax, images
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)


def traffic(seed):
    """F.traffic's four requests (prompts of 6 and 18, budgets 2-6), each
    with its own image."""
    reqs = F.traffic(seed)
    return [(p, b, img) for (p, b), img in zip(reqs, images(seed + 1,
                                                            len(reqs)))]


# engine case -> the options of both engines
ENGINES = {
    "chunked kv1": dict(kv_bits=1, prefill_chunk=4),
    "chunked kv0": dict(kv_bits=0, prefill_chunk=4),
    "whole kv0": dict(kv_bits=0),
    "whole kv1": dict(kv_bits=1),
    "paged prefix kv1": dict(kv_bits=1, prefill_chunk=4, page_size=4,
                             prefix_cache=True),
    "paged kv0": dict(kv_bits=0, prefill_chunk=4, page_size=4),
}


def port_engine(cfg, params, **kw):
    return ServingEngine(cfg, params, freeze=True, slots=2, max_len=F.MAX_LEN,
                         **kw)


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_tokens_equal_jax(case, monkeypatch):
    """`ServingEngine(cfg, masters, freeze=True, ...)` with an image per
    request: greedy tokens equal the JAX engine's on the same masters (or
    part only at exact ties, `hold_to_jax`); the prefix cache serves no
    vlm prompt."""
    jcfg, cfg, jp, _, pp, _ = F.params(ARCH)
    kw = ENGINES[case]
    reqs = traffic(5)
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jp, freeze=True, slots=2, max_len=F.MAX_LEN,
                         **kw).generate([JaxRequest(p, max_new_tokens=b,
                                                    img_emb=img)
                                         for p, b, img in reqs])
    engines = []

    def run():
        engines.append(port_engine(cfg, pp, **kw))
        return engines[-1].generate([Request(p, max_new_tokens=b,
                                             img_emb=img)
                                     for p, b, img in reqs])

    def check(got):
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))
    hold_to_jax(run, check, monkeypatch, f"engine {case}")
    stats = engines[0].scheduler().stats
    assert stats["prefix_hits"] == 0 and stats["prefill_tokens_saved"] == 0
    assert stats["completed"] == len(reqs)


def test_paged_equals_contiguous_and_images_matter():
    """The paged kv_bits=1 engine with the prefix cache gives the
    contiguous engine's tokens exactly on prompts that share an 11-token
    prefix (no page is shared: the tree is off); a request's tokens follow
    its image."""
    _, cfg, _, _, pp, _ = F.params(ARCH)
    shared = F.shared_traffic(1)
    imgs = images(9, len(shared))
    reqs = [Request(p, max_new_tokens=b, img_emb=img)
            for (p, b), img in zip(shared, imgs)]
    kw = dict(kv_bits=1, prefill_chunk=4)
    base = port_engine(cfg, pp, **kw).generate(reqs)
    eng = port_engine(cfg, pp, page_size=4, prefix_cache=True, **kw)
    for c, want in zip(eng.serve(reqs), base, strict=True):
        np.testing.assert_array_equal(c.tokens, want)
        assert c.cached_tokens == 0
    st = eng.scheduler().stats
    assert st["prefix_hits"] == 0
    assert st["prefill_tokens"] == sum(r.prompt.size for r in reqs)
    other = port_engine(cfg, pp, **kw).generate(
        [Request(r.prompt, max_new_tokens=r.max_new_tokens,
                 img_emb=img) for r, img in zip(reqs, images(10, len(reqs)))])
    assert any(not np.array_equal(a, b) for a, b in zip(other, base))


def test_images_are_checked_at_submit():
    """A vlm request without an image, or with one of another shape, is
    rejected at submit (RequestError), as in the JAX scheduler; an image
    for another family too; `generate_static` refuses the vlm family (it
    passes no image, where the JAX path fails)."""
    _, cfg, _, _, pp, _ = F.params(ARCH)
    eng = port_engine(cfg, pp, kv_bits=1, prefill_chunk=4)
    sched = eng.scheduler()
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(RequestError, match="needs img_emb"):
        sched.submit(Request(prompt, max_new_tokens=2))
    with pytest.raises(RequestError, match="img_emb shape"):
        sched.submit(Request(prompt, max_new_tokens=2,
                             img_emb=np.zeros((cfg.n_img_tokens, 31))))
    with pytest.raises(RequestError, match="img_emb shape"):
        sched.submit(Request(prompt, max_new_tokens=2,
                             img_emb=np.zeros((1, cfg.n_img_tokens,
                                               cfg.d_vision))))
    assert sched.idle
    with pytest.raises(ValueError, match="generate_static"):
        eng.generate_static([Request(prompt, max_new_tokens=2,
                                     img_emb=images(0, 1)[0])])
    _, dcfg, _, _, dp, _ = F.params("qwen2-72b")
    with pytest.raises(RequestError, match="vlm-only"):
        port_engine(dcfg, dp).scheduler().submit(
            Request(prompt, max_new_tokens=2, img_emb=images(0, 1)[0]))
