"""The recurrentgemma hybrid (RG-LRU + local attention over a ring of
`local_window` K/V rows) in the port against the JAX package, on the smoke
recurrentgemma-2b (8 layers: two groups of rec, rec, attn and a tail of two
rec layers; d 64, lru width 64, 4 heads over 1 KV head of 16, window 8,
float32): configs, the RG-LRU scan and blocks, whole-prompt prefill, decode
and chunked prefill of the state (ring and recurrent states), greedy tokens
of the engine and of `generate_static`, the convert round trip, and the
tied head's cast at freeze.

Tolerances:
  * `_seg_scan` and `chunked_diag_scan` run JAX's `associative_scan`
    recursion op for op: equal to JAX run eagerly, bit for bit;
  * the RG-LRU coefficients and blocks: 1e-6 of each tensor's largest
    magnitude (measured: at most 2e-7), the states of whole-model calls
    2e-6 (the Mamba stack's bound, tests/test_torch_ssm.py): the float32
    gate products are matmuls that XLA and torch sum in other orders, and
    sigmoid, softplus and exp round by an ulp apart;
  * packed ring words and the conv history (outputs of binarized matmuls):
    exactly; float ring rows and V scales 1e-6 of their largest magnitude;
  * logits atol 1e-4, rtol 1e-5, as tests/test_torch_whole_prompt.py.

Greedy tokens must equal the JAX engine's. At kv_bits=1 a token may part
only where packed attention's weighted +-1 V terms cancel exactly (ROADMAP
Queue C): the port sums them exactly and outputs 0, the JAX core keeps a
float32 residue. Each kv_bits=1 run is repeated with every packed attention
output (the ring decode and the ring chunk) taken from the JAX core on the
port's own inputs, which must give JAX's tokens, and every sign the two
disagree on must be such a tie (run with -s to print them).

The port runs with denormals flushed on one thread (XLA's CPU float mode,
as tests/test_torch_whole_prompt.py): the float attention's outputs over V
rows of zeros are sums of denormal terms. The JAX side runs inside
`tune.gspmd_safe()` (its packed GEMMs on their jnp oracles) with its Pallas
decode kernel swapped for `repro.kernels.ref.decode_attention_packed_ref`
inside the test; blocks are held to JAX run eagerly (`jax.disable_jit()`:
XLA's jit contracts multiply-adds into FMAs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.layers import QuantMode as JaxQuantMode
from repro.kernels import ref as jax_ref
from repro.kernels import tune
from repro.models import ssm as JS
from repro.models import ssm_lm as JL
from repro.models.api import cache_batch_axes as jax_cache_batch_axes
from repro.models.api import get_model as jax_get_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import (
    cache_from_numpy, cache_to_numpy, to_numpy_tree, words_to_numpy,
)
from repro_torch.core.bitpack import unpack_bits
from repro_torch.core.layers import QuantMode
from repro_torch.core.packed import PackedWeight
from repro_torch.kernels import ref as port_ref
from repro_torch.models import ssm as S
from repro_torch.models import ssm_lm as L
from repro_torch.models.api import (
    ATTENTION_FAMILIES, cache_batch_axes, get_model,
)
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import assert_rel, jax_to_np, np_leaves, to_port

ARCH = "recurrentgemma-2b"
BLOCK_REL = 1e-6
STATE_REL = 2e-6
FLOAT_REL = 1e-6
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
MAX_LEN = 40


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals():
    """The port in XLA's float mode (denormals flushed to zero) on this
    module's thread alone (the flag is per thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_decode_on_its_oracle(monkeypatch):
    """The JAX side's packed decode attention on its jnp oracle (the Pallas
    kernel in interpret mode is slow and is not the reference here)."""
    monkeypatch.setattr(JL, "decode_attention_packed",
                        jax_ref.decode_attention_packed_ref)


@functools.lru_cache(maxsize=None)
def _params():
    """(JAX masters, JAX frozen, port masters, port frozen)."""
    jm = jax_get_model(jax_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    jf = jm.freeze(jp)
    pf = get_model(smoke_config(ARCH)).freeze(to_port(jax_to_np(jp)))
    return jp, jf, to_port(jax_to_np(jp)), pf


@functools.lru_cache(maxsize=None)
def _jax_fn(name, cfg):
    """JAX's `name` (rg_prefill, rg_decode, rg_prefill_chunk) jitted for
    `cfg` (one compile per shape; the state tests hold JAX's jitted serving
    calls, the block tests JAX run eagerly)."""
    fn = getattr(JL, name)
    return jax.jit(lambda p, *args: fn(p, cfg, *args))


def _cfgs(kv_bits=0):
    return (jax_smoke(ARCH).scaled(kv_bits=kv_bits),
            smoke_config(ARCH).scaled(kv_bits=kv_bits))


def _prompt(seed, b, s, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _hold_state(port: dict, want: dict, what=""):
    """Every leaf of the port's state against the JAX state's: words and
    the conv history exactly, float ring rows and V scales FLOAT_REL, the
    rec layers' h STATE_REL."""
    got = cache_to_numpy(port)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert g.shape == w.shape, (what, name)
        if w.dtype == np.uint32 or name.endswith("conv"):
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=f"{what} {name}")
        else:
            rel = STATE_REL if name.endswith("_h") else FLOAT_REL
            assert_rel(g, w, rel, f"{what} {name}")


# ---------------------------------------------------------------------------
# Configs and layout
# ---------------------------------------------------------------------------
def test_configs_match_jax():
    for port_cfg, jax_cfg in ((get_config(ARCH), jax_get_config(ARCH)),
                              (smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        assert port_cfg.activation_dtype == getattr(
            torch, jnp.dtype(jax_cfg.activation_dtype).name)
        assert L.rg_layout(port_cfg) == JL.rg_layout(jax_cfg)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.local_window, full.lru_width) == \
        (26, 2560, 10, 1, 256, 2048, 2560)
    assert full.tie_embeddings and full.mlp == "geglu"
    assert L.rg_layout(full) == (8, 2) and L.rg_layout(smoke_config(ARCH)) \
        == (2, 2)


def test_params_state_and_axes_match_jax():
    """Param tree, init rules (matrices N(0, 0.02^2), vectors 0), the
    state's leaves and their slot axes, and `init_frozen`'s frozen tree."""
    jp, jf, pp, pf = _params()
    jcfg, cfg = _cfgs(1)
    mine = L.init_rg_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    for a, b in zip(np_leaves(to_numpy_tree(mine)), np_leaves(jax_to_np(jp)),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a == 0).all() == (b == 0).all()
        if not (b == 0).all():
            assert 0.015 < a.std() < 0.025
    frozen = get_model(cfg).init_frozen(torch.Generator().manual_seed(0),
                                        device="cpu")
    for a, b in zip(np_leaves(to_numpy_tree(frozen)),
                    np_leaves(to_numpy_tree(pf)), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert isinstance(frozen["groups"]["rec"]["mix"]["w_x"], PackedWeight)
    assert frozen["groups"]["rec"]["mix"]["w_x"].packed.shape == (2, 2, 64, 2)
    assert not isinstance(frozen["groups"]["rec"]["mix"]["w_rec_gate"],
                          PackedWeight)
    for kv_bits in (0, 1):
        jcfg, cfg = _cfgs(kv_bits)
        st = L.rg_init_state(cfg, 3, device="cpu")
        want = JL.rg_init_state(jcfg, 3)
        assert {k: tuple(v.shape) for k, v in st.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        model = get_model(cfg)
        assert cache_batch_axes(model, MAX_LEN) == jax_cache_batch_axes(
            jax_get_model(jcfg), MAX_LEN)
    assert "hybrid" not in ATTENTION_FAMILIES


# ---------------------------------------------------------------------------
# The RG-LRU: scan and blocks
# ---------------------------------------------------------------------------
def _scan_inputs(seed, b, n, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 1.0, (b, n, w)).astype(np.float32)
    x = rng.normal(size=(b, n, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 32])
def test_seg_scan_equals_jax_eager(n):
    a, b, h0 = _scan_inputs(n, 2, n, 24)
    with jax.disable_jit():
        want = JS._seg_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = S._seg_scan(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(h0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length,chunk", [(21, 16), (21, 64), (32, 16)])
def test_chunked_diag_scan_equals_jax_eager(length, chunk):
    """Chunks of min(chunk, L), the last padded with a = 1, b = 0 (L %
    chunk != 0), the state carried across chunks."""
    a, b, h0 = _scan_inputs(length + chunk, 2, length, 24)
    with jax.disable_jit():
        ys, hf = JS.chunked_diag_scan(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(h0), chunk,
                                      lambda hc, _: hc)
    got, gh = S.chunked_diag_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(h0), chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ys))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(hf))


def _rec_mix(layer):
    """The masters of rec layer `layer` of group 0 on both sides."""
    jp, _, pp, _ = _params()
    return (jax.tree.map(lambda a: a[0, layer], jp["groups"]["rec"])["mix"],
            L.pick(pp["groups"]["rec"], 0, layer)["mix"])


@pytest.mark.parametrize("part", ["coeffs", "block", "chunk", "step"])
def test_rglru_matches_jax_eager(part):
    """`_rglru_coeffs`, `rglru_block` (conv state and h), `rglru_block_chunk`
    from a state with n_valid < C, and `rglru_block_step`, on converted
    masters (the binarized matmuls exact in both), within BLOCK_REL of JAX
    run eagerly (its scan bodies are compiled, as `lax.scan` always
    compiles them)."""
    jcfg, cfg = _cfgs()
    jmix, pmix = _rec_mix(1)
    jmode, mode = JaxQuantMode(jcfg.quant), QuantMode(cfg.quant)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 13, 64)).astype(np.float32)
    conv = rng.normal(size=(2, 3, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    with tune.gspmd_safe():
        if part == "coeffs":
            want = JS._rglru_coeffs(jmix, jx)
            got = S._rglru_coeffs(pmix, px)
        elif part == "block":
            y, (cs, hf) = JS.rglru_block(jmix, jx, jcfg, jmode, train=False,
                                         key=None, return_state=True, chunk=8)
            want = (y, cs, hf)
            gy, (gcs, ghf) = S.rglru_block(pmix, px, cfg, mode, chunk=8)
            got = (gy, gcs, ghf)
        elif part == "chunk":
            want = JS.rglru_block_chunk(jmix, jx[:1], jnp.asarray(conv[:1]),
                                        jnp.asarray(h0[:1]), 9, jcfg, jmode,
                                        chunk=4)
            got = S.rglru_block_chunk(pmix, px[:1], torch.from_numpy(conv[:1]),
                                      torch.from_numpy(h0[:1]), 9, cfg, mode,
                                      chunk=4)
        else:
            want = JS.rglru_block_step(jmix, jx[:, :1], jnp.asarray(conv),
                                       jnp.asarray(h0), jcfg, jmode)
            got = S.rglru_block_step(pmix, px[:, :1], torch.from_numpy(conv),
                                     torch.from_numpy(h0), cfg, mode)
    for g, w in zip(got, want, strict=True):
        assert_rel(_np(g), _np(w), BLOCK_REL, part)


# ---------------------------------------------------------------------------
# The state: whole prompt, decode, chunks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("s", [5, 13])
def test_rg_prefill_matches_jax(kv_bits, s):
    """Whole prompts of 5 (shorter than the window) and 13 tokens (the ring
    keeps the last 8 at t % 8) into a new state, and in place into slots
    [1, 3) of a 4-slot state holding other values: every leaf of those
    slots equals JAX's (the slot's whole ring is written: zeros where the
    prompt is shorter), the other slots keep theirs."""
    _, jf, _, pf = _params()
    jcfg, cfg = _cfgs(kv_bits)
    toks = _prompt(s, 2, s)
    with tune.gspmd_safe():
        jl, jc = _jax_fn("rg_prefill", jcfg)(jf, jnp.asarray(toks))
    pl, pc = L.rg_prefill(pf, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _hold_state(pc, jc, f"prefill S={s}")
    st = L.rg_init_state(cfg, 4, device="cpu")
    for t in st.values():
        t.copy_(torch.randint(-9, 9, t.shape).to(t.dtype))
    before = {k: v.clone() for k, v in st.items()}
    L.rg_prefill(pf, cfg, torch.from_numpy(toks).long(), cache=st, slot=1)
    axes = cache_batch_axes(get_model(cfg), MAX_LEN)
    for name, t in st.items():
        ax = axes[name]
        np.testing.assert_array_equal(
            cache_to_numpy({name: t.narrow(ax, 1, 2)})[name],
            cache_to_numpy({name: pc[name]})[name], err_msg=name)
        for keep in (0, 3):
            assert torch.equal(t.narrow(ax, keep, 1),
                               before[name].narrow(ax, keep, 1)), name


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_rg_decode_matches_jax_and_skips_inactive_rows(kv_bits):
    """Two decode steps after 11- and 5-token prompts (the ring wraps for
    row 0): row 0 at its position, row 1 inactive (pos -1) in the second
    step. Active rows' logits and state equal JAX's; the inactive row
    writes no ring slot and no state; the V scale is not updated."""
    _, jf, _, pf = _params()
    jcfg, cfg = _cfgs(kv_bits)
    toks = _prompt(11, 2, 11)
    with tune.gspmd_safe():
        _, jc = _jax_fn("rg_prefill", jcfg)(jf, jnp.asarray(toks))
        _, pc = L.rg_prefill(pf, cfg, torch.from_numpy(toks).long())
        for step, pos in enumerate(([11, 11], [12, -1])):
            tok = np.array([3 + step, 7], np.int32)
            before = {k: v.clone() for k, v in pc.items()}
            jl, jc = _jax_fn("rg_decode", jcfg)(
                jf, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
            pl, pc = L.rg_decode(pf, cfg, torch.from_numpy(tok).long(), pc,
                                 torch.tensor(pos, dtype=torch.int32))
            live = [i for i, p in enumerate(pos) if p >= 0]
            np.testing.assert_allclose(pl.numpy()[live],
                                       np.asarray(jl)[live], **LOGIT_TOL)
            _hold_state(pc, jc, f"decode step {step}")
    axes = cache_batch_axes(get_model(cfg), MAX_LEN)
    for name, t in pc.items():
        assert torch.equal(t.narrow(axes[name], 1, 1),
                           before[name].narrow(axes[name], 1, 1)), name
    if kv_bits:
        assert torch.equal(pc["attn_v_scale"], before["attn_v_scale"])


@pytest.mark.parametrize("kv_bits", [0, 1])
@pytest.mark.parametrize("chunk", [4, 16])
def test_rg_prefill_chunk_matches_jax(kv_bits, chunk, monkeypatch):
    """A 19-token prompt into slot 1 of 2 in chunks of 4 (shorter than the
    window) and 16 (longer: the ring's 'later wins' advance), the first
    chunk on a slot holding a previous occupant's state: after every chunk
    the logits and the whole state equal JAX's (ring words exactly). At
    kv_bits=1 the port takes the chunk's attention outputs from the JAX
    core on its own inputs, each sign it would give otherwise an exact tie
    (`_swap_in_jax_attention`): this test holds the ring and the states."""
    _, jf, _, pf = _params()
    jcfg, cfg = _cfgs(kv_bits)
    ties = []
    if kv_bits:
        _swap_in_jax_attention(monkeypatch, ties)
    prompt = _prompt(19, 1, 19)[0]
    with tune.gspmd_safe():
        _, jc = _jax_fn("rg_prefill", jcfg)(jf, jnp.asarray(_prompt(2, 2,
                                                                   10)))
    pc = cache_from_numpy({k: np.asarray(v) for k, v in jc.items()},
                          device="cpu")
    lo = 0
    while lo < len(prompt):
        n = min(chunk, len(prompt) - lo)
        ch = np.zeros((1, chunk), np.int32)
        ch[0, :n] = prompt[lo:lo + n]
        with tune.gspmd_safe():
            jl, jc = _jax_fn("rg_prefill_chunk", jcfg)(
                jf, jnp.asarray(ch), jc, 1, lo, n)
        pl, pc = L.rg_prefill_chunk(pf, cfg, torch.from_numpy(ch).long(), pc,
                                    1, lo, n)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _hold_state(pc, jc, f"chunk at {lo}")
        lo += n
    for where, elem, theirs in ties:
        print(f"chunk {chunk}: exact tie in the {where}, element {elem}: "
              f"port 0.0, JAX {theirs!r}")


# ---------------------------------------------------------------------------
# Greedy tokens against the JAX engine
# ---------------------------------------------------------------------------
def _traffic(seed=5, vocab=128):
    """Four requests, prompts of 19 and 11 tokens (longer than the window,
    8; two lengths, so whole-prompt admission compiles two JAX prefills),
    budgets that carry decode past it; more requests than the engine's two
    slots."""
    rng = np.random.default_rng(seed)
    lens, budgets = (19, 11, 19, 11), (4, 6, 9, 3)
    return [(rng.integers(0, vocab, n).astype(np.int32), b)
            for n, b in zip(lens, budgets)]


def _is_exact_tie(q, k, v, valid, b, s, h, d) -> bool:
    """Whether output element (b, s, h, d) of packed attention sums to 0 in
    exact arithmetic: its +1 and -1 V terms have equal multisets of
    dots."""
    g = q.shape[2] // k.shape[2]
    dots = port_ref.packed_attention_dots(q, k)[b, h // g, s, h % g]
    bit = unpack_bits(v[b, :, h // g], q.shape[-1])[:, d]
    live = valid[b, s]
    return sorted(dots[live & (bit > 0)].tolist()) == \
        sorted(dots[live & (bit < 0)].tolist())


_jax_chunk_core = jax.jit(jax_ref.packed_masked_attention_ref)
_jax_decode_core = jax.jit(jax_ref.decode_attention_packed_ref)


def _swap_in_jax_attention(mp, ties: list) -> None:
    """Make the port's hybrid take every packed attention output (the ring
    chunk's core and the ring decode) from the JAX core on the port's own
    inputs. Each sign the port's own output differs on, in a row with a
    valid position, must be an exact tie at which the port outputs 0; it
    is appended to `ties`."""
    def operands(q, k, v, vs):
        return (jnp.asarray(q.numpy()), jnp.asarray(words_to_numpy(k)),
                jnp.asarray(words_to_numpy(v)), jnp.asarray(vs.numpy()))

    def compare(mine, theirs, q, k, v, valid, where):
        differ = (mine >= 0) != (theirs >= 0)
        differ &= valid.any(-1)[:, :, None, None]
        for elem in differ.nonzero().tolist():
            assert float(mine[tuple(elem)]) == 0.0 and \
                _is_exact_tie(q, k, v, valid, *elem), \
                f"{where}: element {elem} parts from JAX without a tie"
            ties.append((where, tuple(elem), float(theirs[tuple(elem)])))
        return theirs

    def chunk(q, k, v, vs, valid):
        theirs = torch.from_numpy(np.array(_jax_chunk_core(
            *operands(q, k, v, vs), jnp.asarray(valid.numpy()))))
        return compare(port_ref.packed_masked_attention_ref(q, k, v, vs,
                                                            valid),
                       theirs, q, k, v, valid, "ring chunk")

    def decode(q, k, v, vs, cache_len):
        lens = cache_len.to(torch.int32)
        theirs = torch.from_numpy(np.array(_jax_decode_core(
            *operands(q, k, v, vs), jnp.asarray(lens.numpy()))))
        valid = port_ref.chunk_valid_mask(q.shape[0], 1, k.shape[1], lens,
                                          lens - 1, 0, True)
        return compare(port_ref.decode_attention_packed_ref(q, k, v, vs,
                                                            lens),
                       theirs, q, k, v, valid, "ring decode")

    mp.setattr(L, "packed_masked_attention_ref", chunk)
    mp.setattr(L, "decode_attention_packed", decode)


def _hold_to_jax(run, want, kv_bits, monkeypatch, what):
    """The port's tokens (`run()`) against JAX's: equal at kv_bits=0; at
    kv_bits=1 equal, or parting only at exact ties (each printed), proven
    by the run with JAX's attention swapped in giving JAX's tokens."""
    got = run()
    want = [np.asarray(w) for w in want]
    if kv_bits == 0:
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        return
    ties = []
    with monkeypatch.context() as mp:
        _swap_in_jax_attention(mp, ties)
        swapped = run()
    for a, b in zip(swapped, want, strict=True):
        np.testing.assert_array_equal(a, b)
    parted = [i for i, (a, b) in enumerate(zip(got, want))
              if not np.array_equal(a, b)]
    if not ties:
        assert not parted
    for where, elem, theirs in ties:
        print(f"{what}: exact tie in the {where}, element (row, query, head, "
              f"d) {elem}: port 0.0, JAX {theirs!r}")
    print(f"{what}: requests parting from JAX: {parted}")


# case -> (kv_bits, prefill_chunk): whole prompt, and chunks shorter (4)
# and longer (16) than the window, at kv_bits 0 and 1
ENGINE_CASES = {f"{'whole' if c is None else f'chunk {c}'} kv{kv}": (kv, c)
                for kv in (0, 1) for c in (None, 4, 16)}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_match_jax(case, monkeypatch):
    """`ServingEngine(cfg, params, freeze=True, ...)`: greedy tokens equal
    the JAX engine's on the same masters (kv_bits=1: see `_hold_to_jax`).
    Whole-prompt admission reaches no kernel-6 decode before its first
    token; every case decodes past the window."""
    kv_bits, chunk = ENGINE_CASES[case]
    jp, _, pp, _ = _params()
    jcfg, cfg = _cfgs()
    kw = dict(freeze=True, slots=2, max_len=MAX_LEN, kv_bits=kv_bits,
              prefill_chunk=chunk)
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jp, **kw).generate(
            [JaxRequest(p, max_new_tokens=b) for p, b in _traffic()])
    _hold_to_jax(lambda: ServingEngine(cfg, pp, **kw).generate(
        [Request(p, max_new_tokens=b) for p, b in _traffic()]),
        want, kv_bits, monkeypatch, case)


@pytest.mark.parametrize("kv_bits", [0, 1])
def test_generate_static_matches_jax(kv_bits, monkeypatch):
    """Three prompts of 10 tokens, budgets 1-6 (decode past the window):
    tokens equal the JAX engine's `generate_static`; a recurrent state has
    no max_len cap there (as in the JAX package)."""
    jp, _, pp, _ = _params()
    jcfg, cfg = _cfgs()
    prompts, budgets = _prompt(6, 3, 10), (6, 1, 4)
    kw = dict(freeze=True, kv_bits=kv_bits, max_len=12)
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jp, **kw).generate_static(
            [JaxRequest(p, max_new_tokens=b)
             for p, b in zip(prompts, budgets)])
    eng = ServingEngine(cfg, pp, **kw)

    def run():
        got = eng.generate_static([Request(p, max_new_tokens=b)
                                   for p, b in zip(prompts, budgets)])
        assert [len(t) for t in got] == list(budgets)
        return got
    _hold_to_jax(run, want, kv_bits, monkeypatch, f"static kv{kv_bits}")


def test_engine_options_and_bytes():
    """Paging and the prefix cache are ignored for the hybrid, as in the
    JAX package; the state's bytes do not grow with max_len (packed ring:
    int32 words; the rest float); whole-prompt admission gives chunked
    admission's tokens at kv_bits=0."""
    _, _, pp, _ = _params()
    _, cfg = _cfgs()
    reqs = [Request(p, max_new_tokens=b) for p, b in _traffic()[:3]]
    base = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=MAX_LEN,
                         prefill_chunk=4)
    paged = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=MAX_LEN,
                          prefill_chunk=4, page_size=8, prefix_cache=True)
    whole = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=MAX_LEN)
    for a, b, c in zip(base.generate(reqs), paged.generate(reqs),
                       whole.generate(reqs), strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert paged.scheduler().page_stats() is None
    small = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=16,
                          kv_bits=1).resident_cache_bytes()
    big = ServingEngine(cfg, pp, freeze=True, slots=2, max_len=4096,
                        kv_bits=1).resident_cache_bytes()
    assert small == big
    g, tail = L.rg_layout(cfg)
    assert small["packed"] == 2 * g * 2 * cfg.local_window * 1 * 4
    w = cfg.lru_width
    assert small["float"] == 4 * (g * 2 + tail) * 2 * (3 * w + w) \
        + g * 2 * 4


# ---------------------------------------------------------------------------
# Convert and the tied head
# ---------------------------------------------------------------------------
def test_convert_round_trip_of_params_and_state():
    """Hybrid params (masters and frozen: stacked (g, n_rec, ...) leaves,
    uint32 words) and states (packed ring words, float rings, a bf16 conv
    history) carry to the port and back unchanged."""
    jp, jf, pp, pf = _params()
    for tree, port in ((jp, pp), (jf, to_port(jax_to_np(jf)))):
        for a, b in zip(np_leaves(to_numpy_tree(port)),
                        np_leaves(jax_to_np(tree)), strict=True):
            np.testing.assert_array_equal(a, b)
    assert pf["groups"]["rec"]["ffn"]["w_up"].packed.shape[:2] == (2, 2)
    jcfg, cfg = _cfgs(1)
    with tune.gspmd_safe():
        _, filled = _jax_fn("rg_prefill", jcfg)(jf, jnp.asarray(
            _prompt(4, 2, 11)))
    for jc in (filled, JL.rg_init_state(jcfg.scaled(dtype="bfloat16",
                                                    kv_bits=0), 2)):
        jn = {k: np.asarray(v) for k, v in jc.items()}
        port = cache_from_numpy(jn, device="cpu")
        for name in jn:
            assert port[name].dtype == (torch.int32 if jn[name].dtype ==
                                        np.uint32 else getattr(
                                            torch, jn[name].dtype.name))
        back = cache_to_numpy(port)
        for name in jn:
            np.testing.assert_array_equal(back[name],
                                          jn[name].astype(back[name].dtype))
    bf = JL.rg_init_state(jcfg.scaled(dtype="bfloat16", kv_bits=0), 1)
    vals = np.random.default_rng(8).normal(size=bf["rec_conv"].shape)
    conv = jnp.asarray(vals, jnp.bfloat16)
    port = cache_from_numpy({"rec_conv": np.asarray(conv)}, device="cpu")
    assert port["rec_conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(cache_to_numpy(port)["rec_conv"],
                                  np.asarray(conv.astype(jnp.float32)))


def test_frozen_tied_logits_equal_the_uncast_head():
    """`freeze` casts the tied embedding (the head) to the activation dtype
    once: in bf16, the logits, prefill and decode equal those of the same
    frozen params with the float32 embedding, bit for bit (a cast commutes
    with the lookup's gather, and `head` casts the head to that dtype)."""
    _, _, pp, _ = _params()
    cfg = smoke_config(ARCH).scaled(dtype="bfloat16", kv_bits=1)
    model = get_model(cfg)
    frozen = model.freeze(dict(pp))
    assert frozen["embed"].dtype == torch.bfloat16 and "lm_head" not in frozen
    uncast = dict(frozen, embed=pp["embed"])
    toks = torch.from_numpy(_prompt(9, 2, 12)).long()
    a, _ = model.logits(frozen, toks)
    b, _ = model.logits(uncast, toks)
    assert torch.equal(a, b)
    la, ca = model.prefill(frozen, toks)
    lb, cb = model.prefill(uncast, toks)
    assert torch.equal(la, lb)
    tok = toks[:, -1]
    da, _ = model.decode(frozen, tok, ca, 12)
    db, _ = model.decode(uncast, tok, cb, 12)
    assert torch.equal(da, db)
