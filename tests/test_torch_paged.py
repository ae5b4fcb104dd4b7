"""The port's paged 1-bit KV pool and prefix cache against the JAX package,
on frozen smoke phi3-medium-14b params (2 layers, d 64, hd 16, float32):
the paged attention's plain versions (kernels 7 and 9 run them on the CPU),
the paged transformer, and the paged, prefix-cached serving engine.

Tolerances. Integer score dots, cache and pool words, page tables, token
ids and every count: exact. Attention outputs against the JAX oracles
`repro.kernels.ref.*_paged_ref`: atol = rtol = 1e-5, as in
tests/test_torch_attention.py (XLA's CPU exp differs from torch's by an ulp
in about a tenth of the values, and the JAX oracle sums in float32 where the
port sums exactly). Against the port's contiguous plain version on the
gathered panel: bit for bit. V scales rtol 1e-6 and logits atol 1e-4, rtol
1e-5, as in tests/test_torch_transformer.py.

The JAX side runs inside `tune.gspmd_safe()` (its packed kernels on their
jnp oracles; two paged Pallas interpret cases fail at take-up, ROADMAP Queue
C). The engine traffic and the transformer prompts come from seeds whose
port runs meet no exact cancellation of the weighted V terms, where the JAX
oracle's float32 residue and the port's exact 0 part (ROADMAP Queue C;
tests/test_torch_serving.py proves each such tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.bitpack import pack_bits as jax_pack_bits, packed_dot
from repro.kernels import ref as jref
from repro.kernels import tune
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, tensor
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, decode_attention_packed_paged,
)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_packed, prefill_attention_packed_paged,
)
from repro_torch.models import transformer as T
from repro_torch.models.api import PAGED, cache_batch_axes, get_model
from repro_torch.serving.engine import Request, RequestError, ServingEngine

from _torch_parity import jax_to_np, to_port

ARCH = "phi3-medium-14b"
ATOL = RTOL = 1e-5
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).scaled(kv_bits=1)
    cfg = smoke_config(ARCH).scaled(kv_bits=1)
    jm = jax_get_model(jcfg)
    jp = jm.freeze(jm.init(jax.random.PRNGKey(0)))
    masters = jax_get_model(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, to_port(jax_to_np(jp)), masters


# ---------------------------------------------------------------------------
# Paged attention (the plain versions of kernels 7 and 9)
# ---------------------------------------------------------------------------
def _pools(rng, pool, ps, hkv, hd, b, n_pages, lens):
    """uint32 K/V pools from the JAX pack, and a page table giving row i
    ceil(lens[i] / ps) distinct pages in shuffled order, the sentinel
    `pool` beyond (rows of length 0 get no page at all)."""
    k, v = (np.asarray(jax_pack_bits(jnp.asarray(
        rng.normal(size=(pool, ps, hkv, hd)).astype(np.float32))))
        for _ in range(2))
    free = list(rng.permutation(pool))
    table = np.full((b, n_pages), pool, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-int(n) // ps)):
            table[i, j] = free.pop()
    vs = rng.uniform(0.5, 1.0, (b, hkv)).astype(np.float32)
    return k, v, table, vs


def _jax_dots(q, k_panel):
    """The JAX package's integer dots of q against a gathered panel,
    (B, Hkv, S, G, T)."""
    b, s, hq, hd = q.shape
    hkv = k_panel.shape[2]
    qb = jax_pack_bits(jnp.asarray(q).reshape(b, s, hkv, hq // hkv, hd)
                       .transpose(0, 2, 1, 3, 4))
    kb = jnp.asarray(k_panel).transpose(0, 2, 1, 3)
    return np.asarray(packed_dot(qb[:, :, :, :, None, :],
                                 kb[:, :, None, None, :, :], hd))


# (B, ps, NP, pool, Hkv, G, hd, lengths, window): page sizes 4, 8 and 16,
# hd off the word size, GQA, a window, and rows of length 0 (all sentinel)
PAGED_CASES = [(3, 4, 6, 20, 2, 2, 16, (1, 13, 24), 0),
               (2, 8, 4, 9, 1, 4, 20, (31, 0), 5),
               (4, 16, 3, 14, 3, 1, 40, (48, 17, 0, 33), 0)]
CASE_ARGS = "b,ps,n_pages,pool,hkv,g,hd,lens,window"


@pytest.mark.parametrize(CASE_ARGS, PAGED_CASES)
def test_paged_decode_plain_matches_jax(b, ps, n_pages, pool, hkv, g, hd,
                                        lens, window):
    rng = np.random.default_rng(ps * hd + b)
    k, v, table, vs = _pools(rng, pool, ps, hkv, hd, b, n_pages, lens)
    q = rng.integers(-4, 5, (b, 1, hkv * g, hd)).astype(np.float32)
    lens_np = np.asarray(lens, np.int32)
    want = np.asarray(jref.decode_attention_packed_paged_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(lens_np), window=window))
    args = (torch.from_numpy(q), tensor(k, "cpu"), tensor(v, "cpu"),
            torch.from_numpy(vs), torch.from_numpy(table))
    got, dots = decode_attention_packed_paged(
        *args, torch.from_numpy(lens_np), window=window, return_dots=True)
    # every row, those of length 0 too: both weigh every position of the
    # gathered row alike there, sentinel pages clipped to page P-1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    panel = jref.gather_pages(jnp.asarray(k), jnp.asarray(table))
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, panel)[:, :, 0])
    # the port's gather is the JAX one's, sentinel clip included
    np.testing.assert_array_equal(
        ref.gather_pages(args[1], args[4]).numpy().view(np.uint32),
        np.asarray(panel))


@pytest.mark.parametrize(CASE_ARGS, PAGED_CASES)
def test_paged_prefill_plain_matches_jax(b, ps, n_pages, pool, hkv, g, hd,
                                         lens, window):
    rng = np.random.default_rng(ps * hd + b + 1)
    s = 5
    lens = tuple(max(n, s) for n in lens)
    k, v, table, vs = _pools(rng, pool, ps, hkv, hd, b, n_pages, lens)
    q = rng.integers(-4, 5, (b, s, hkv * g, hd)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    q_pos = kv_len - s
    want = np.asarray(jref.prefill_attention_packed_paged_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(kv_len), jnp.asarray(q_pos),
        window=window))
    got, dots = prefill_attention_packed_paged(
        torch.from_numpy(q), tensor(k, "cpu"), tensor(v, "cpu"),
        torch.from_numpy(vs), torch.from_numpy(table),
        torch.from_numpy(kv_len), torch.from_numpy(q_pos), window=window,
        return_dots=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    panel = jref.gather_pages(jnp.asarray(k), jnp.asarray(table))
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, panel))


def test_paged_prefill_plain_past_the_old_cap_matches_jax():
    """A 2,048-position table (past ~1,770, where a (32, T) score panel
    would not fit shared memory; the wrapper takes any T): a chunk at the end of one row and in the middle of
    another, shuffled pages, sentinel entries in the shorter row's tail."""
    rng = np.random.default_rng(2048)
    b, ps, n_pages, pool, hkv, g, hd, s = 2, 64, 32, 52, 1, 2, 16, 4
    k, v, table, vs = _pools(rng, pool, ps, hkv, hd, b, n_pages, (2048, 1200))
    q = rng.integers(-4, 5, (b, s, hkv * g, hd)).astype(np.float32)
    kv_len = np.asarray((2048, 1200), np.int32)
    q_pos = kv_len - s
    want = np.asarray(jref.prefill_attention_packed_paged_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(kv_len), jnp.asarray(q_pos)))
    got, dots = prefill_attention_packed_paged(
        torch.from_numpy(q), tensor(k, "cpu"), tensor(v, "cpu"),
        torch.from_numpy(vs), torch.from_numpy(table),
        torch.from_numpy(kv_len), torch.from_numpy(q_pos), return_dots=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    panel = jref.gather_pages(jnp.asarray(k), jnp.asarray(table))
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, panel))


@pytest.mark.parametrize(CASE_ARGS, PAGED_CASES)
def test_paged_plain_is_contiguous_on_the_gathered_panel(
        b, ps, n_pages, pool, hkv, g, hd, lens, window):
    """Bit for bit: paging is addressing only."""
    rng = np.random.default_rng(ps + hd + b)
    k, v, table, vs = _pools(rng, pool, ps, hkv, hd, b, n_pages, lens)
    k, v, table = tensor(k, "cpu"), tensor(v, "cpu"), torch.from_numpy(table)
    vs = torch.from_numpy(vs)
    kg, vg = ref.gather_pages(k, table), ref.gather_pages(v, table)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(b, 1, hkv * g, hd))
                         .astype(np.float32))
    for got, want in zip(
            decode_attention_packed_paged(q, k, v, vs, table, lens_t,
                                          window=window, return_dots=True),
            decode_attention_packed(q, kg, vg, vs, lens_t, window=window,
                                    return_dots=True)):
        assert torch.equal(got, want)
    q = torch.from_numpy(rng.normal(size=(b, 3, hkv * g, hd))
                         .astype(np.float32))
    qp = (lens_t - 3).clamp(min=0)
    for got, want in zip(
            prefill_attention_packed_paged(q, k, v, vs, table, qp + 3, qp,
                                           window=window, return_dots=True),
            prefill_attention_packed(q, kg, vg, vs, qp + 3, qp,
                                     window=window, return_dots=True)):
        assert torch.equal(got, want)


def test_paged_operands_are_checked():
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(5, 4, 2, 1, dtype=torch.int32)
    vs = torch.ones(2, 2)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="page_table"):
        decode_attention_packed_paged(q, k, k, vs, table[:1], 1)
    with pytest.raises(ValueError, match="int32 words"):
        decode_attention_packed_paged(q, k, k[:, :2], vs, table, 1)


# ---------------------------------------------------------------------------
# The paged transformer
# ---------------------------------------------------------------------------
def _chunks(prompt, c=4):
    for lo in range(0, len(prompt), c):
        nv = min(c, len(prompt) - lo)
        ch = np.zeros((1, c), np.int32)
        ch[0, :nv] = prompt[lo:lo + nv]
        yield ch, lo, nv


def test_paged_transformer_matches_jax(models):
    """Both packages start from the same paged cache state (`convert`): two
    slots with shuffled pages, slot 1's prompt admitted chunk by chunk, then
    decode steps with slot 0 inactive. Pool words, page table and V scales
    after each step, and the logits, against the JAX transformer."""
    jcfg, cfg, jp, pp, _ = models
    jc = JT.init_cache(jcfg, 2, 32, page_size=4, pool_pages=12)
    table = np.full((2, 8), 12, np.int32)
    table[1, :5] = [7, 2, 11, 0, 5]
    jc["page_table"] = jnp.asarray(table)
    pc = cache_from_numpy({k: np.asarray(a) for k, a in jc.items()},
                          device="cpu")
    prompt = np.random.default_rng(36).integers(0, cfg.vocab, 10)
    for ch, lo, nv in _chunks(prompt):
        with tune.gspmd_safe():
            jl, jc = JT.transformer_prefill_chunk(jp, jcfg, jnp.asarray(ch),
                                                  jc, 1, lo, nv)
        pl, pc = T.transformer_prefill_chunk(pp, cfg, torch.from_numpy(ch),
                                             pc, 1, lo, nv)
        _assert_cache(jc, pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    token, pos = np.array([9, 4], np.int32), np.array([-1, 10], np.int32)
    for _ in range(3):
        with tune.gspmd_safe():
            jl, jc = JT.transformer_decode(jp, jcfg, jnp.asarray(token), jc,
                                           jnp.asarray(pos))
        pl, pc = T.transformer_decode(pp, cfg, torch.from_numpy(token), pc,
                                      torch.from_numpy(pos))
        _assert_cache(jc, pc)
        np.testing.assert_allclose(pl[1].numpy(), np.asarray(jl)[1],
                                   **LOGIT_TOL)
        token[1] = int(np.asarray(jl)[1].argmax())
        pos[1] += 1


def _assert_cache(jc, pc):
    jn = {k: np.asarray(a) for k, a in jc.items()}
    pn = cache_to_numpy(pc)
    assert pn.keys() == jn.keys()
    for name in ("k", "v", "page_table"):
        np.testing.assert_array_equal(pn[name], jn[name])
    np.testing.assert_allclose(pn["v_scale"], jn["v_scale"], rtol=1e-6)


@pytest.mark.parametrize("active_row", [0, 1])
def test_sentinel_row_cannot_race_an_active_write(models, active_row):
    """A freed slot's all-sentinel table row clips to page P-1. In one
    decode step the active slot writes (page P-1, row 0); the inactive
    slot's own position maps to that same clipped address. Its write goes
    to the sink page instead, so the active row's words land, in either
    row order, and no page any table names changes otherwise."""
    _, cfg, _, pp, _ = models
    pool = 6
    cache = T.init_cache(cfg, 2, 16, device="cpu", page_size=4,
                         pool_pages=pool)
    idle = 1 - active_row
    cache["page_table"][active_row] = torch.tensor([0, 1, pool - 1, pool],
                                                   dtype=torch.int32)
    for name in ("k", "v"):
        cache[name].random_(-2**31, 2**31 - 1)
    before = {k: v.clone() for k, v in cache.items()}
    token = torch.tensor([3, 8])
    pos = torch.full((2,), -1, dtype=torch.int32)
    pos[active_row] = 8                         # page index 2, row 0
    _, cache = T.transformer_decode(pp, cfg, token, cache, pos)
    # the words the active row wrote: the same step on a contiguous cache
    contig = T.init_cache(cfg, 2, 16, device="cpu")
    _, contig = T.transformer_decode(pp, cfg, token, contig, pos)
    for name in ("k", "v"):
        got, old = cache[name], before[name]
        assert torch.equal(got[:, pool - 1, 0], contig[name][:, active_row, 8])
        changed = (got != old).flatten(2).any(-1)          # (L, P)
        changed[:, pool - 1] = False
        assert not changed.any()
        # the sink page (behind each layer's pool) took the idle row's write
        sink = T._with_sink(got[0])[pool]
        assert sink.any()
    assert torch.equal(cache["v_scale"], before["v_scale"])


def test_init_cache_paged_shapes_and_batch_axes():
    cfg = smoke_config(ARCH).scaled(kv_bits=1)
    c = T.init_cache(cfg, 3, 40, device="cpu", page_size=8, pool_pages=11)
    assert c["k"].shape == (2, 11, 8, 2, 1) and c["k"].dtype == torch.int32
    assert c["page_table"].shape == (3, 5)
    assert (c["page_table"] == 11).all()
    assert c["v_scale"].shape == (2, 3, 2)
    assert cache_batch_axes(get_model(cfg), 40, page_size=8) == \
        {"k": PAGED, "v": PAGED, "page_table": 0, "v_scale": 1}
    jc = JT.init_cache(jax_smoke(ARCH).scaled(kv_bits=1), 3, 40,
                       page_size=8, pool_pages=11)
    assert {k: v.shape for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in c.items()}
    assert T.init_cache(cfg, 3, 40, device="cpu",
                        page_size=8)["k"].shape[1] == 15
    with pytest.raises(ValueError, match="sink"):
        T._with_sink(torch.zeros(4, 8, 2, 1, dtype=torch.int32))


def test_paged_cache_round_trips():
    """A paged cache carries across and back: pools as uint32 words, the
    page table as int32, V scales as float32; the port's pools get their
    sink pages."""
    rng = np.random.default_rng(8)
    cache = {"k": rng.integers(0, 2**32, (2, 5, 4, 2, 1), dtype=np.uint64)
             .astype(np.uint32),
             "v": np.full((2, 5, 4, 2, 1), 0xFFFFFFFF, np.uint32),
             "page_table": np.array([[3, 0, 5], [5, 5, 5]], np.int32),
             "v_scale": rng.random((2, 2, 2)).astype(np.float32)}
    port = cache_from_numpy(cache, device="cpu")
    assert T._with_sink(port["k"][1]).shape[0] == 6
    back = cache_to_numpy(port)
    for name in cache:
        np.testing.assert_array_equal(back[name], cache[name])
        assert back[name].dtype == cache[name].dtype


# ---------------------------------------------------------------------------
# The paged, prefix-cached engine
# ---------------------------------------------------------------------------
def shared_traffic(seed, vocab=128, prefix=11):
    """Five requests through two slots: four share an 11-token prefix (two
    full pages of 4) and add 1-7 tokens of their own, one shares nothing."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix)
    out = []
    for i in range(5):
        own = rng.integers(0, vocab, int(rng.integers(1, 8)))
        prompt = own if i == 3 else np.concatenate([shared, own])
        out.append((prompt.astype(np.int32), int(rng.integers(2, 6))))
    return out


def paged_engine(cfg, params, **kw):
    return ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=4,
                         slots=2, max_len=32, **kw)


def test_paged_prefix_engine_matches_jax(models):
    """Greedy tokens, prefix hits, tokens saved, prefill tokens, each
    completion's cached tokens, and the pool after the drain (only the
    tree's pages allocated) equal the JAX engine's on the same traffic."""
    jcfg, cfg, _, _, masters = models
    pp = to_port(jax_to_np(masters))
    reqs = shared_traffic(1)
    with tune.gspmd_safe():
        jeng = JaxEngine(jax_smoke(ARCH), masters, freeze=True, kv_bits=1,
                         prefill_chunk=4, slots=2, max_len=32, page_size=4,
                         prefix_cache=True)
        want = jeng.serve([JaxRequest(p, max_new_tokens=b) for p, b in reqs])
    eng = paged_engine(cfg, pp, page_size=4, prefix_cache=True)
    got = eng.serve([Request(p, max_new_tokens=b) for p, b in reqs])
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.cached_tokens == b.cached_tokens
        assert a.status == b.status == "completed"
    js, ps = jeng.scheduler(), eng.scheduler()
    for key in ("prefix_hits", "prefill_tokens_saved", "prefill_tokens",
                "tokens_out", "completed"):
        assert ps.stats[key] == js.stats[key], key
    assert ps.stats["prefix_hits"] >= 2
    assert ps.page_stats() == js.page_stats()
    assert ps._pager.allocated == ps._ptree.n_pages
    ps._pager.check()


@pytest.mark.parametrize("page_size,prefix_cache",
                         [(4, True), (4, False), (8, True), (8, False)])
def test_paged_engine_tokens_equal_contiguous(models, page_size,
                                              prefix_cache):
    """Paged, with and without the prefix cache, at two page sizes: the
    port's tokens equal its contiguous engine's exactly; the prompt tokens
    split exactly into prefilled and served from the tree."""
    _, cfg, _, pp, _ = models
    for seed in (1, 2):
        reqs = [Request(p, max_new_tokens=b) for p, b in shared_traffic(seed)]
        base = paged_engine(cfg, pp).generate(reqs)
        eng = paged_engine(cfg, pp, page_size=page_size,
                           prefix_cache=prefix_cache, interleave_steps=2)
        comps = eng.serve(reqs)
        for c, want in zip(comps, base, strict=True):
            np.testing.assert_array_equal(c.tokens, want)
            assert c.cached_tokens % page_size == 0
            assert 0.0 < c.ttft <= c.ttft_wall + 1e-6
        st = eng.scheduler().stats
        assert st["prefill_tokens"] + st["prefill_tokens_saved"] == \
            sum(r.prompt.size for r in reqs)
        assert (st["prefix_hits"] > 0) == prefix_cache
        sched = eng.scheduler()
        sched._pager.check()
        assert sched._pager.allocated == \
            (sched._ptree.n_pages if prefix_cache else 0)


def test_pool_pressure_evicts_and_oversized_requests_raise(models):
    """A pool too small to keep every retired prefix: admissions evict
    cold tree pages, requests wait for pages in their place, the pool's
    invariants hold and the tokens equal the contiguous engine's. A
    request that needs more pages than the pool has is refused at submit."""
    _, cfg, _, pp, _ = models
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, 128, int(rng.integers(3, 12))),
                    max_new_tokens=3) for _ in range(8)]
    base = ServingEngine(cfg, pp, freeze=True, kv_bits=1, prefill_chunk=4,
                         slots=2, max_len=16).generate(reqs)
    eng = ServingEngine(cfg, pp, freeze=True, kv_bits=1, prefill_chunk=4,
                        slots=2, max_len=16, page_size=4, pool_pages=5,
                        prefix_cache=True)
    for got, want in zip(eng.generate(reqs), base, strict=True):
        np.testing.assert_array_equal(got, want)
    sched = eng.scheduler()
    assert sched._ptree.evicted > 0
    sched._pager.check()
    assert sched._ptree.audit() == []
    tiny = ServingEngine(cfg, pp, freeze=True, kv_bits=1, prefill_chunk=4,
                         slots=2, max_len=16, page_size=4, pool_pages=2)
    with pytest.raises(RequestError, match="4 pages > pool_pages=2"):
        tiny.scheduler().submit(Request(np.arange(10), max_new_tokens=5))


def test_engine_reports_the_page_pool(models):
    _, cfg, _, pp, _ = models
    eng = paged_engine(cfg, pp, page_size=4, prefix_cache=True)
    before = eng.resident_cache_bytes()
    eng.generate([Request(p, max_new_tokens=b)
                  for p, b in shared_traffic(2)[:2]])
    cb = eng.resident_cache_bytes()
    # 2 slots x 8 pages, plus each layer's sink page, K and V, 4 B words
    words = cfg.n_kv_heads * 1
    assert cb["packed"] == 2 * cfg.n_layers * (16 + 1) * 4 * words * 4 \
        + 2 * 8 * 4
    assert cb["float"] == cfg.n_layers * 2 * cfg.n_kv_heads * 4
    assert before["packed"] == cb["packed"]
    pool = cb["page_pool"]
    assert pool["pages"] == pool["allocated"] + pool["free"] == 16
    assert pool["pinned_by_prefix"] == pool["allocated"] > 0
    assert pool["prefix_tree"]["lookups"] == 2 and pool["page_size"] == 4


def test_paging_options_are_checked(models):
    _, cfg, _, pp, _ = models
    with pytest.raises(ValueError, match="page_size"):
        paged_engine(cfg, pp, prefix_cache=True)
    with pytest.raises(ValueError, match="divisible"):
        paged_engine(cfg, pp, page_size=6, prefix_cache=True)
    with pytest.raises(ValueError, match="page_size"):
        paged_engine(cfg, pp, pool_pages=4)
    with pytest.raises(NotImplementedError, match="fault plans"):
        paged_engine(cfg, pp, page_size=4, fault_plan=object())
