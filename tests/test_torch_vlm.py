"""llama-3.2-vision-11b (the vlm family) in the port against the JAX
package, at smoke size (10 layers in 2 groups of a cross block and 4 self
blocks, d 64, 4 heads over 2 KV heads of 16, 8 image tokens of width 32,
float32): configs, the frozen tree (the gate stays float), the init's
layout, logits (and that the image moves them), whole-prompt prefill into
slot 1 of 2, chunks with the image on the first only and decode steps
with an inactive row, at kv_bits 0 and 1, contiguous and paged, with every
cache leaf (K/V, the image rows xk / xv, the V scales); and the plain
kernel 8 without the causal mask (the cross-attention of a chunk) against
the JAX oracle.

Params come from tests/_torch_families.py (every leaf drawn non-zero, the
gates N(0, 1)); image embeddings are N(0, 1). Tolerances are that module's:
logits atol 1e-4, rtol 1e-5; words exactly; float cache leaves within 1e-6
of their largest magnitude. The module runs torch on one thread with
denormals flushed to zero, XLA's float mode
(`test_torch_whole_prompt._flush_denormals`).

Exact ties. The cross-attention's queries and image keys are popcount
dots, integers, so positions of equal score are common; where their V
values cancel, an attention output is 0 in exact arithmetic, or smaller
than the last bit of the cancelling terms, and each package's float32
sums leave their own residue around it, of either sign, which the next
sign-pack reads. `hold_to_jax`
runs the port with the JAX package's attention outputs on the port's own
inputs (float: `swap_in_jax_float_attention`; packed:
`test_torch_serving._swap_in_jax_attention`), holds that run to JAX, and
requires every sign the two attentions disagree on to be such a tie
(printed); with no tie it holds the port's own run to JAX as well.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import list_archs as jax_list_archs
from repro.kernels import ref as jref
from repro.kernels import tune
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, list_archs
from repro_torch.convert import cache_from_numpy, cache_to_numpy
from repro_torch.core.packed import PackedWeight
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels import ref as port_ref
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.api import cache_batch_axes, get_model
from repro_torch.serving.engine import ServingEngine

import _torch_families as F
from _torch_parity import assert_rel
from test_torch_attention import ATOL, RTOL, _cache, _jax_dots, _port, _query
from test_torch_serving import _swap_in_jax_attention
from test_torch_whole_prompt import _flush_denormals  # noqa: F401 (autouse)

ARCH = "llama-3.2-vision-11b"


def images(seed, b, cfg=None):
    """(b, n_img_tokens, d_vision) float32 image embeddings, N(0, 1)."""
    cfg = cfg or F.smoke_config(ARCH)
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)


def same_cache(jc, pn, kv_bits):
    """Every leaf of the port's cache (numpy, `cache_to_numpy`) equals
    JAX's: words and page tables exactly, floats within 1e-6 of their
    largest magnitude."""
    jn = {k: np.asarray(v) for k, v in jc.items()}
    assert set(pn) == set(jn)
    for name in jn:
        assert pn[name].shape == jn[name].shape, name
        if name == "page_table" or (kv_bits == 1 and name in
                                    ("k", "v", "xk", "xv")):
            np.testing.assert_array_equal(pn[name], jn[name], err_msg=name)
        else:
            assert_rel(pn[name], jn[name], rel=1e-6, what=name)


def _float_tie(q, k, v, valid, elem) -> bool:
    """Whether the sign of float-attention output element (b, s, h, d) is
    below float32 resolution: its exact value (float64 softmax of the exact
    scores, times V) lies within the error bound of a float32 sum of its T
    terms, (T + 4) * 2^-23 * sum_t |p_t v_t|. The common case is an exact
    tie, equal scores whose V values cancel, with what remains of the sum
    below the last bit of the cancelling terms."""
    b, s, h, d = elem
    g = q.shape[2] // k.shape[2]
    live = valid[b, s]
    scores = k[b, live, h // g].double() @ q[b, s, h].double() \
        * A._scale(q.shape[-1])
    terms = torch.softmax(scores, 0) * v[b, live, h // g, d].double()
    bound = (live.sum() + 4) * 2.0 ** -23 * terms.abs().sum()
    return bool(terms.sum().abs() <= bound)


def swap_in_jax_float_attention(mp, ties: list) -> None:
    """Make the port's transformer take every float attention output (the
    flash attention of a whole sequence, chunk and decode attention over a
    float cache, contiguous or paged) from the JAX package's functions on
    the port's own inputs. Each element whose sign the port's gives
    otherwise, in a row with a valid position, must have a sign below
    float32 resolution (`_float_tie`); it is appended to `ties` as (call,
    element, port value, JAX value)."""
    calls = [0]

    def hold(what, mine, theirs, q, k, v, valid):
        theirs = torch.from_numpy(np.array(theirs)).to(mine.dtype)
        differ = (mine >= 0) != (theirs >= 0)
        differ &= valid.any(-1)[:, :, None, None]
        for elem in map(tuple, differ.nonzero().tolist()):
            assert _float_tie(q, k, v, valid, elem), \
                f"{what}: element {elem} parts from JAX without a tie"
            ties.append((f"{what} call {calls[0]}", elem, float(mine[elem]),
                         float(theirs[elem])))
        calls[0] += 1
        return theirs

    def j(x):
        return jnp.asarray(x.numpy())

    def flash(q, k, v, causal=True, window=0, chunk=512, q_offset=0):
        mine = A.flash_attention(q, k, v, causal, window, chunk, q_offset)
        theirs = JA.flash_attention(j(q), j(k), j(v), causal, window, chunk,
                                    q_offset)
        s, t = q.shape[1], k.shape[1]
        valid = A._chunk_mask(torch.arange(s) + q_offset, torch.arange(t),
                              causal, window).expand(q.shape[0], s, t)
        return hold("flash", mine, theirs, q, k, v, valid)

    def chunk(q, kc, vc, kv_len, q_pos, *, window=0, causal=True):
        mine = A.chunk_attention(q, kc, vc, kv_len, q_pos, window=window,
                                 causal=causal)
        theirs = JA.chunk_attention(
            j(q), j(kc), j(vc), jnp.asarray(np.asarray(kv_len)),
            jnp.asarray(np.asarray(q_pos)), window=window, causal=causal)
        valid = port_ref.chunk_valid_mask(q.shape[0], q.shape[1],
                                          kc.shape[1], kv_len, q_pos, window,
                                          causal)
        return hold("chunk", mine, theirs, q, kc, vc, valid)

    def decode(q, kc, vc, cache_len, *, window=0):
        mine = A.decode_attention(q, kc, vc, cache_len, window=window)
        lens = torch.as_tensor(cache_len, dtype=torch.int32) \
            .expand(q.shape[0])
        theirs = JA.decode_attention(j(q), j(kc), j(vc),
                                     jnp.asarray(lens.numpy()), window=window)
        valid = port_ref.chunk_valid_mask(q.shape[0], 1, kc.shape[1], lens,
                                          lens - 1, window, True)
        return hold("decode", mine, theirs, q, kc, vc, valid)

    def gathered(fn):
        def call(q, kp, vp, pt, *args, **kw):
            return fn(q, port_ref.gather_pages(kp, pt),
                      port_ref.gather_pages(vp, pt), *args, **kw)
        return call

    mp.setattr(T, "flash_attention", flash)
    mp.setattr(T, "chunk_attention", chunk)
    mp.setattr(T, "decode_attention", decode)
    mp.setattr(T, "chunk_attention_paged", gathered(chunk))
    mp.setattr(T, "decode_attention_paged", gathered(decode))


def _gathered_packed(fn):
    """A paged packed attention call as `fn`, the contiguous one, on the
    gathered pages (the JAX package's paged oracles gather too)."""
    def call(q, kp, vp, vs, pt, *args, **kw):
        return fn(q, port_ref.gather_pages(kp, pt),
                  port_ref.gather_pages(vp, pt), vs, *args, **kw)
    return call


def hold_to_jax(run, check, monkeypatch, what):
    """Run the port (`run()`), then run it again with every attention
    output, float and packed, contiguous and paged, taken from the JAX
    package's on the port's inputs, and `check` that run against JAX; every sign the attentions
    disagree on must be an exact tie (printed). With no tie, `check` the
    port's own run too."""
    got = run()
    ties = []
    with monkeypatch.context() as mp:
        swap_in_jax_float_attention(mp, ties)
        _swap_in_jax_attention(mp, ties)
        for name in ("decode_attention_packed", "prefill_attention_packed"):
            mp.setattr(T, f"{name}_paged", _gathered_packed(getattr(T, name)))
        check(run())
    for tie in ties:
        print(f"{what}: exact tie {tie}")
    if not ties:
        check(got)
    return ties


def test_config_fields_equal_jax():
    """Fields equal JAX's, full and smoke; the group layout; the port's
    registry holds every arch of the JAX package's."""
    F.check_config(ARCH)
    full, smoke = get_config(ARCH), F.smoke_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.head_dim, full.d_ff, full.vocab,
            full.xattn_group, full.n_img_tokens, full.d_vision,
            full.rope_theta) == ("vlm", 40, 4096, 32, 8, 128, 14336, 128256,
                                 5, 1600, 1280, 5e5)
    assert T.vlm_layout(full) == (8, 4) and T.vlm_layout(smoke) == (2, 4)
    assert (smoke.n_layers, smoke.n_heads, smoke.n_kv_heads,
            smoke.n_img_tokens, smoke.d_vision) == (10, 4, 2, 8, 32)
    assert list_archs() == sorted(jax_list_archs())


def test_frozen_tree_equals_jax():
    """Words and every float leaf equal JAX's freeze; the self blocks keep
    their (g, xattn_group - 1) axes, the cross K/V their K of d_vision, and
    the gate stays a float32 (g, 1) leaf, unfrozen."""
    jcfg, _, _, jf, pp, pf = F.params(ARCH)
    F._assert_tree_equal(jf, pf)
    g, p_self = T.vlm_layout(jcfg)
    hd, hkv = jcfg.head_dim, jcfg.n_kv_heads
    wq = pf["groups"]["self"]["attn"]["wq"]
    assert isinstance(wq, PackedWeight)
    assert wq.packed.shape == (g, p_self, jcfg.n_heads * hd,
                               jcfg.d_model // 32)
    wk = pf["groups"]["cross"]["attn"]["wk"]
    assert wk.packed.shape == (g, hkv * hd, jcfg.d_vision // 32)
    assert wk.k == jcfg.d_vision
    gate = pf["groups"]["cross"]["attn"]["gate"]
    assert not isinstance(gate, PackedWeight) and gate.dtype == torch.float32
    assert gate.shape == (g, 1) and (gate != 0).all()
    assert torch.equal(gate, pp["groups"]["cross"]["attn"]["gate"])
    view = T.pick(pf["groups"]["self"], 1, 3)["attn"]["wq"]
    assert torch.equal(view.packed, wq.packed[1, 3])


def test_init_layout_equals_jax():
    """The port's init has the JAX init's leaves and shapes (gates 0, as
    there); `init_frozen` (one block at a time) has `freeze(init)`'s
    tree: the same words' shapes and float leaves."""
    jcfg, cfg = F.jax_smoke(ARCH), F.smoke_config(ARCH)
    shapes = jax.eval_shape(
        functools.partial(JT.init_transformer_params, cfg=jcfg),
        jax.random.PRNGKey(0))
    model = get_model(cfg)
    masters = model.init(torch.Generator().manual_seed(1), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               masters)[0]}
    assert got == {jax.tree_util.keystr(path): tuple(s.shape)
                   for path, s in flat_j}
    assert (masters["groups"]["cross"]["attn"]["gate"] == 0).all()

    def layout(tree):
        return jax.tree.map(
            lambda x: (tuple(x.packed.shape), x.k) if isinstance(
                x, PackedWeight) else (tuple(x.shape), x.dtype), tree,
            is_leaf=lambda x: isinstance(x, PackedWeight))
    frozen = model.init_frozen(torch.Generator().manual_seed(2),
                               device="cpu")
    assert layout(frozen) == layout(model.freeze(masters))


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_init_cache_layout_equals_jax(kv_bits):
    """The cache's leaves, shapes and batch axes equal the JAX package's,
    contiguous and paged (the self K/V (g, xattn_group - 1, ...), the image
    rows per slot in both); every self layer's pool, the last included,
    has its sink page behind it, and the engine counts those pages."""
    from repro.models.api import cache_batch_axes as jax_cache_batch_axes
    from repro.models.api import get_model as jax_get_model
    jcfg = F.jax_smoke(ARCH).scaled(kv_bits=kv_bits)
    cfg = F.smoke_config(ARCH).scaled(kv_bits=kv_bits)
    model = get_model(cfg)
    g, p_self = T.vlm_layout(cfg)
    for kw in ({}, dict(page_size=4, pool_pages=11)):
        pc = model.init_cache(3, 40, device="cpu", **kw)
        jc = JT.init_cache(jcfg, 3, 40, **kw)
        assert {k: tuple(v.shape) for k, v in pc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert cache_batch_axes(model, 40, **kw) == jax_cache_batch_axes(
            jax_get_model(jcfg), 40, **kw)
        if kw:
            for gi, j in ((0, 0), (g - 1, p_self - 1)):
                assert T._with_sink(pc["k"][gi, j]).shape[0] == 12
    eng = ServingEngine(cfg, F.params(ARCH)[5], slots=3, max_len=40,
                        prefill_chunk=4, page_size=4, pool_pages=11)
    leaves = sum(x.numel() * x.element_size()
                 for x in model.init_cache(3, 40, device="meta", page_size=4,
                                           pool_pages=11).values())
    page = pc["k"][0, 0, 0]                     # one page of one pool
    sinks = 2 * g * p_self * page.numel() * page.element_size()
    assert eng.resident_cache_bytes()["total"] == leaves + sinks


def test_logits_equal_jax_and_move_with_the_image(monkeypatch):
    """`transformer_logits` with an image: masters and frozen params give
    equal logits in the port, and JAX's within tolerance (`hold_to_jax`);
    another image gives other logits."""
    jcfg, cfg, _, jf, pp, pf = F.params(ARCH)
    toks = torch.from_numpy(F.prompt(3, 2, 13)).long()
    model = get_model(cfg)
    logits = jax.jit(functools.partial(JT.transformer_logits, cfg=jcfg))
    seen = []
    for seed in (4, 5):
        img = images(seed, 2)
        with tune.gspmd_safe():
            jl, _ = logits(jf, tokens=jnp.asarray(toks.numpy()),
                           img_emb=jnp.asarray(img))

        def run(img=img):
            pm, _ = model.logits(pp, toks, img_emb=torch.from_numpy(img))
            pfl, _ = model.logits(pf, toks, img_emb=torch.from_numpy(img))
            assert torch.equal(pm, pfl)
            return pfl
        hold_to_jax(run, lambda got, jl=jl: F.close_logits(got, jl),
                    monkeypatch, f"logits, image {seed}")
        seen.append(np.asarray(jl))
    assert np.abs(seen[0] - seen[1]).max() > 1e-2


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_prefill_into_slot_1_of_2_equals_jax(kv_bits, monkeypatch):
    """Whole-prompt prefill of one 13-token prompt and its image into slot
    1 of a 2-slot cache: its logits, and each leaf's slot-1 rows equal
    those of JAX's new one-row cache (the image rows and their V scale
    too); slot 0 stays zero."""
    _, _, _, jf, _, pf = F.params(ARCH)
    jcfg = F.jax_smoke(ARCH).scaled(kv_bits=kv_bits)
    cfg = F.smoke_config(ARCH).scaled(kv_bits=kv_bits)
    toks, img = F.prompt(1, 1, 13), images(6, 1)
    with tune.gspmd_safe():
        jl, jc = jax.jit(functools.partial(
            JT.transformer_prefill, cfg=jcfg, max_len=F.MAX_LEN))(
            jf, tokens=jnp.asarray(toks), img_emb=jnp.asarray(img))
    jn = {k: np.asarray(v) for k, v in jc.items()}
    model = get_model(cfg)
    axes = cache_batch_axes(model, F.MAX_LEN)
    assert set(axes) == set(jn)

    def run():
        pc = model.init_cache(2, F.MAX_LEN, device="cpu")
        return model.prefill(pf, torch.from_numpy(toks).long(), cache=pc,
                             slot=1, img_emb=torch.from_numpy(img))

    def check(out):
        pl, pc = out
        F.close_logits(pl, jl)
        pn = cache_to_numpy(pc)
        assert set(pn) == set(jn)
        for name, ax in axes.items():
            got = np.take(pn[name], [1], axis=ax)
            if kv_bits == 1 and name in ("k", "v", "xk", "xv"):
                np.testing.assert_array_equal(got, jn[name], err_msg=name)
            else:
                assert_rel(got, jn[name], rel=1e-6, what=name)
            assert not np.take(pn[name], 0, axis=ax).any(), name
    hold_to_jax(run, check, monkeypatch, f"prefill kv_bits={kv_bits}")


def _table():
    """A shuffled page table of two slots over a pool of 12 pages of 4
    (the last entries the sentinel 12)."""
    table = np.full((2, 8), 12, np.int32)
    table[0, :4] = [3, 9, 1, 6]
    table[1, :5] = [7, 2, 11, 0, 5]
    return table


def _chunk_steps(prompts, imgs):
    """(slot, chunk (1, 4), pos, n_valid, image or None) of two slots'
    admissions in chunks of 4, the image with each first chunk."""
    for slot, p in enumerate(prompts):
        for lo in range(0, len(p), 4):
            nv = min(4, len(p) - lo)
            ch = np.zeros((1, 4), np.int32)
            ch[0, :nv] = p[lo:lo + nv]
            yield slot, ch, lo, nv, imgs[slot:slot + 1] if lo == 0 else None


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits", [0, 1])
def test_chunks_and_decode_equal_jax(kv_bits, paged, monkeypatch):
    """Two slots admitted chunk by chunk (chunks of 4, the last padded),
    the image with each request's first chunk only, then two decode steps
    with slot 0 at its next positions and slot 1 inactive (pos -1): the
    last chunks' logits, the active decode row's, and every cache leaf
    after each request and each step (contiguous, or the paged pools from
    one shuffled table, whose image rows stay per slot)."""
    _, _, _, jf, _, pf = F.params(ARCH)
    jcfg = F.jax_smoke(ARCH).scaled(kv_bits=kv_bits)
    cfg = F.smoke_config(ARCH).scaled(kv_bits=kv_bits)
    rng = np.random.default_rng(27)
    prompts = (rng.integers(0, cfg.vocab, 6), rng.integers(0, cfg.vocab, 10))
    imgs = images(8, 2)
    if paged:
        jc = JT.init_cache(jcfg, 2, F.MAX_LEN, page_size=4, pool_pages=12)
        jc["page_table"] = jnp.asarray(_table())
    else:
        jc = JT.init_cache(jcfg, 2, F.MAX_LEN)
    start = {k: np.asarray(a) for k, a in jc.items()}
    want = []            # (logits row, cache) after each request and step
    for slot, ch, lo, nv, img in _chunk_steps(prompts, imgs):
        with tune.gspmd_safe():
            jl, jc = JT.transformer_prefill_chunk(
                jf, jcfg, jnp.asarray(ch), jc, slot, lo, nv,
                img_emb=None if img is None else jnp.asarray(img))
        if lo + nv == len(prompts[slot]):
            want.append((np.asarray(jl)[0], dict(jc)))
    token, pos = np.array([5, 7], np.int32), np.array([6, -1], np.int32)
    tokens = []
    for _ in range(2):
        tokens.append(token.copy())
        with tune.gspmd_safe():
            jl, jc = JT.transformer_decode(jf, jcfg, jnp.asarray(token), jc,
                                           jnp.asarray(pos))
        want.append((np.asarray(jl)[0], dict(jc)))
        token[0] = int(np.asarray(jl)[0].argmax())
        pos[0] += 1

    def snapshot(pc):          # numpy copies: the port writes in place
        return {k: a.copy() for k, a in cache_to_numpy(pc).items()}

    def run():
        pc = cache_from_numpy(start, device="cpu")
        out = []
        for slot, ch, lo, nv, img in _chunk_steps(prompts, imgs):
            pl, pc = T.transformer_prefill_chunk(
                pf, cfg, torch.from_numpy(ch), pc, slot, lo, nv,
                img_emb=None if img is None else torch.from_numpy(img))
            if lo + nv == len(prompts[slot]):
                out.append((pl[0].numpy(), snapshot(pc)))
        for i, tok in enumerate(tokens):
            pl, pc = T.transformer_decode(
                pf, cfg, torch.from_numpy(tok), pc,
                torch.tensor([6 + i, -1], dtype=torch.int32))
            out.append((pl[0].numpy(), snapshot(pc)))
        return out

    def check(got):
        assert len(got) == len(want)
        for (pl, pn), (jl, jcache) in zip(got, want):
            np.testing.assert_allclose(pl, jl, **F.LOGIT_TOL)
            same_cache(jcache, pn, kv_bits)
    hold_to_jax(run, check, monkeypatch,
                f"chunks + decode kv_bits={kv_bits} paged={paged}")


NON_CAUSAL = [  # (B, S, T, Hkv, G, hd, kv_len)
    (2, 4, 8, 2, 2, 16, 8), (1, 5, 40, 2, 4, 20, 33), (3, 1, 37, 1, 2, 33,
                                                       None)]


@pytest.mark.parametrize("b,s,t,hkv,g,hd,kv_len", NON_CAUSAL)
def test_plain_kernel8_non_causal_equals_jax(b, s, t, hkv, g, hd, kv_len):
    """The plain kernel 8 with causal=False (the cross-attention of a
    chunk: every query row sees all kv_len positions whatever q_pos)
    against the JAX oracle: dots exactly, outputs within the attention
    tests' tolerance; one query row equals the plain decode over the same
    length bit for bit, and moving q_pos changes nothing."""
    rng = np.random.default_rng(s * t + hd)
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, s, hkv * g, hd))
    lens = (np.full(b, kv_len, np.int32) if kv_len is not None
            else rng.integers(1, t + 1, b).astype(np.int32))
    q_pos = np.zeros(b, np.int32)
    want = np.asarray(jref.prefill_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(lens), jnp.asarray(q_pos), causal=False))
    got, dots = pa.prefill_attention_packed(
        *_port(q, k, v, vs), torch.from_numpy(lens), 0, causal=False,
        return_dots=True)
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, k))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    moved = pa.prefill_attention_packed_plain(
        *_port(q, k, v, vs), torch.from_numpy(lens),
        torch.from_numpy(rng.integers(0, t, b).astype(np.int32)),
        causal=False)
    assert torch.equal(moved, got)
    for i in range(s):
        one = pa.prefill_attention_packed_plain(
            *_port(np.ascontiguousarray(q[:, i:i + 1]), k, v, vs),
            torch.from_numpy(lens), 0, causal=False)
        dec = da.decode_attention_packed_plain(
            *_port(np.ascontiguousarray(q[:, i:i + 1]), k, v, vs),
            torch.from_numpy(lens))
        assert torch.equal(one, dec) and torch.equal(one, got[:, i:i + 1])


def test_images_are_checked():
    """The vlm family needs an image of (B, n_img_tokens, d_vision) where
    the JAX package reads one (logits, whole-prompt prefill); a chunk takes
    one or none; other families take none."""
    _, cfg, _, _, _, pf = F.params(ARCH)
    toks = torch.from_numpy(F.prompt(1, 1, 5)).long()
    with pytest.raises(ValueError, match="needs img_emb"):
        T.transformer_prefill(pf, cfg, toks, max_len=8)
    with pytest.raises(ValueError, match="needs img_emb"):
        T.transformer_logits(pf, cfg, toks)
    with pytest.raises(ValueError, match="img_emb shape"):
        T.transformer_prefill(pf, cfg, toks, max_len=8,
                              img_emb=torch.zeros(1, 8, 31))
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="img_emb shape"):
        T.transformer_prefill_chunk(pf, cfg, toks, cache, 0, 0, 5,
                                    img_emb=torch.zeros(2, 8, 32))
    dense = F.smoke_config("qwen2-72b")
    with pytest.raises(ValueError, match="vlm-only"):
        T.transformer_logits(F.params("qwen2-72b")[5], dense, toks,
                             img_emb=torch.zeros(1, 8, 32))
