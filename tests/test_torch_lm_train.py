"""The port's LM training path against the JAX package's, at smoke size
(float32): the float attention's backward, `transformer_loss` and its
gradients for the dense (phi3-medium-14b, qwen2-72b's QKV bias,
nemotron-4-15b's LayerNorm and squared-ReLU), moe (dbrx-132b at capacity
factors 8 and 1), audio (musicgen-large: sinusoidal positions, GELU) and
vlm (llama-3.2-vision-11b) families, one `make_train_step` step of each
(S-AdaMax, clip), gradient accumulation, stochastic binarization with
JAX's own draws, remat with a generator, `Model.loss` on a frozen tree and
`param_count`.

Params are the JAX package's init (`convert.from_numpy_tree` carries them
across), batches 2 x 24 tokens from a numpy seed (the vlm's image
embeddings N(0, 1)). The JAX steps are jitted once per config in a module
fixture.

Tolerances. The residual stream's binarized products are exact integers
in both packages; the norms, rope, softmax, the float attention and the
head round a few ulps apart, and the backward sums those into gradients
in other orders: losses are held to 1e-5 relative, gradients to GRAD_REL
= 5e-5 of each tensor's largest magnitude (the largest measured, 1.9e-5,
is the vlm gate's). Attention's own backward (dq, dk, dv) is held to 1e-5
of each tensor's largest magnitude in float32; in bfloat16 to 2^-7, where
p and ds are rounded to bfloat16 from float32 sums taken in another order
(one ulp of a term) and the outputs are bfloat16 (half an ulp each).
Params after a step are held through the moments (`_torch_moments`).

Denormals: XLA's CPU backend flushes them to zero and torch keeps them; a
float attention output that is a sum of denormal terms is 0 (a +1 sign)
in JAX and a denormal of either sign in torch, so the module runs the port
with `torch.set_flush_denormal(True)` on one thread
(tests/test_torch_whole_prompt.py).

Exact ties: musicgen-large has no rope, so its integer queries and keys
give equal scores, and an attention output can be 0 in exact arithmetic;
each package's float32 sums leave a residue of either sign there (ROADMAP
Queue C), which the next binarized matmul turns into opposite signs. Its
loss and gradients are therefore taken with the JAX package's attention
(forward and backward) swapped into the port (`_jax_attention`), and every
sign the port's own attention output disagrees on is proved to lie within
float32's rounding bound of 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moments import first_step_scale, held_through_moments
from _torch_parity import assert_rel, jax_to_np, np_leaves, to_port
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.ap2 import ap2_exponent as j_ap2_exponent
from repro.core.packed import freeze_params as j_freeze
from repro.models import attention as JA
from repro.models.api import get_model as jax_get_model
from repro.models.api import param_count as j_param_count
from repro.optim.base import Optimizer as JOptimizer
from repro.train.step import default_optimizer as j_default_optimizer
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core import ap2 as tap2
from repro_torch.models import attention as TA
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model, param_count
from repro_torch.optim.base import (
    Optimizer, tree_leaves, tree_map, tree_unflatten_like,
)
from repro_torch.train.step import (
    clip_binary_weights, default_optimizer, make_train_step,
)

GRAD_REL, LOSS_REL, LR = 5e-5, 1e-5, 1e-3
CASES = {"phi3": ("phi3-medium-14b", {}),
         "qwen2": ("qwen2-72b", {}),
         "nemotron": ("nemotron-4-15b", {}),
         "dbrx_cf8": ("dbrx-132b", {}),
         "dbrx_cf1": ("dbrx-132b", {"capacity_factor": 1.0}),
         "musicgen": ("musicgen-large", {}),
         "vlm": ("llama-3.2-vision-11b", {})}
JAX_ATTENTION = {"musicgen"}


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_emb"] = rng.normal(size=(b, cfg.n_img_tokens, cfg.d_vision)
                                    ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX cfg, port cfg, numpy masters, numpy batch)."""
    arch, over = CASES[name]
    jcfg, cfg = jax_smoke(arch).scaled(**over), smoke_config(arch).scaled(**over)
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jax_to_np(jp), _batch(cfg)


def _stash_grads(opt, jax_side: bool):
    """`opt` whose state also carries the gradients it was given, so one
    make_train_step call yields the loss, the gradients and the step."""
    if jax_side:
        return JOptimizer(init=lambda p: (opt.init(p), None),
                          update=lambda g, s, p: (
                              lambda out: (out[0], (out[1], g)))(
                                  opt.update(g, s[0], p)))

    def update(g, s, p, donate=False):
        upd, st = opt.update(tree_map(torch.clone, g), s[0], p)
        return upd, (st, g)
    return Optimizer(init=lambda p: (opt.init(p), None), update=update)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's loss, metrics and gradients and one make_train_step step
    (params, S-AdaMax state), by case, from one jitted step."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _, np_p, np_b = _case(name)
            opt = _stash_grads(j_default_optimizer(jcfg, LR), True)
            p = jax.tree.map(jnp.asarray, np_p)
            b = {k: jnp.asarray(v) for k, v in np_b.items()}
            p2, (st2, g), m = jax.jit(j_make_train_step(
                jax_get_model(jcfg), opt))(p, opt.init(p), b, None)
            cache[name] = {"metrics": jax_to_np(m), "grads": jax_to_np(g),
                           "params": jax_to_np(p2), "opt": jax_to_np(st2)}
        return cache[name]
    return get


@pytest.fixture(scope="module")
def port_steps():
    """The port's make_train_step step by case (the JAX attention swapped
    in where the module doc says), with its gradients, computed once;
    returns (params, opt state, gradients, metrics, ties met)."""
    cache = {}

    def get(name):
        if name not in cache:
            _, cfg, np_p, np_b = _case(name)
            ties = []
            with pytest.MonkeyPatch.context() as mp:
                if name in JAX_ATTENTION:
                    _jax_attention(mp, ties)
                opt = _stash_grads(default_optimizer(cfg, LR), False)
                params = to_port(np_p)
                p2, (st2, g), m = make_train_step(get_model(cfg), opt)(
                    params, opt.init(params),
                    {k: _t(v) for k, v in np_b.items()})
            cache[name] = (p2, st2, g, {k: float(v) for k, v in m.items()},
                           ties)
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# the JAX attention swapped into the port (exact ties, the module doc)
# ---------------------------------------------------------------------------
class _JaxFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset, ties):
        out, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(
            a, b, c, causal, window, chunk, q_offset),
            *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)))
        ctx.vjp = vjp
        theirs = np.asarray(out)
        mine = TA.flash_attention(q.detach(), k.detach(), v.detach(), causal,
                                  window, chunk, q_offset).numpy()
        part = (mine >= 0) != (theirs >= 0)
        if part.any():
            # each output sums T terms p v, each rounded by 2^-24 at most
            bound = k.shape[1] * 2.0 ** -23 * float(np.abs(v.detach()).max())
            assert np.abs(mine[part]).max() <= bound, "a sign beyond a tie"
            assert np.abs(theirs[part]).max() <= bound, "a sign beyond a tie"
            ties.append(int(part.sum()))
        return torch.from_numpy(np.array(theirs))

    @staticmethod
    def backward(ctx, g):
        grads = ctx.vjp(jnp.asarray(g.numpy()))
        return (*(torch.from_numpy(np.array(x)) for x in grads),
                None, None, None, None, None)


def _jax_attention(mp, ties):
    mp.setattr(T, "flash_attention", lambda q, k, v, causal=True, window=0,
               chunk=512, q_offset=0: _JaxFlash.apply(
                   q, k, v, causal, window, chunk, q_offset, ties))


def _unflatten(like, leaves):
    return tree_unflatten_like(like, [x.detach() for x in leaves])


def _leaves_close(got, want, rel, what):
    for i, (b, a) in enumerate(zip(np_leaves(got), np_leaves(want),
                                   strict=True)):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} leaf {i}")
        else:
            assert_rel(b, a, rel=rel, what=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# the float attention's backward
# ---------------------------------------------------------------------------
ATTN = {"causal": dict(s=20, t=20, causal=True, window=0, chunk=8),
        "window": dict(s=20, t=20, causal=True, window=5, chunk=8),
        "cross": dict(s=12, t=9, causal=False, window=0, chunk=4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(ATTN))
def test_flash_attention_vjp_matches_jax(shape, dtype):
    a = ATTN[shape]
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=sz).astype(np.float32) for sz in (
        (2, a["s"], 4, 16), (2, a["t"], 2, 16), (2, a["t"], 2, 16),
        (2, a["s"], 4, 16)))
    jd = getattr(jnp, dtype)
    args = (a["causal"], a["window"], a["chunk"], 0)
    jout, vjp = jax.vjp(lambda x, y, z: JA.flash_attention(x, y, z, *args),
                        *(jnp.asarray(x, jd) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jd))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_(True)
                  for x in (q, k, v))
    tout = TA.flash_attention(tq, tk, tv, *args)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv),
                                 torch.from_numpy(do).to(td))
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    f32 = (lambda x: np.asarray(jnp.asarray(x, jnp.float32)))
    assert_rel(tout.detach().float().numpy(), f32(jout), rel=rel, what="out")
    for what, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == td
        assert_rel(got.float().numpy(), f32(want), rel=rel, what=what)


def test_flash_attention_backward_keeps_no_chunk_scores():
    """Autograd sees one node for the whole attention: its saved tensors are
    q, k, v, out and the (B, Hkv, G, S) log-sum-exp, not a chunk's scores."""
    q = torch.randn(1, 40, 4, 16, requires_grad=True)
    k, v = (torch.randn(1, 40, 2, 16, requires_grad=True) for _ in range(2))
    out = TA.flash_attention(q, k, v, True, 0, 8, 0)
    saved = out.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved] == [
        (1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16), (1, 40, 4, 16),
        (1, 2, 2, 40)]


# ---------------------------------------------------------------------------
# transformer_loss and its gradients; one train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_transformer_loss_and_gradients_match_jax(jax_refs, port_steps, name):
    ref = jax_refs(name)
    _, _, grads, metrics, ties = port_steps(name)
    assert set(metrics) == set(ref["metrics"]) == {"nll", "lb_loss", "loss"}
    for k in metrics:
        assert metrics[k] == pytest.approx(float(ref["metrics"][k]),
                                           rel=LOSS_REL, abs=1e-7)
    grads = to_numpy_tree(grads)
    _leaves_close(grads, ref["grads"], GRAD_REL, "grads")
    if _case(name)[1].n_experts:
        assert metrics["lb_loss"] > 0
        router = np.asarray(grads["blocks"]["ffn"]["router"])
        assert np.abs(router).max() > 0       # lb_loss reaches the router
    if ties:
        print(f"{name}: attention outputs at exact ties: {ties}")


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_jax(jax_refs, port_steps, name):
    ref = jax_refs(name)
    p2, st2, _, _, _ = port_steps(name)
    got_st = to_numpy_tree(st2)
    assert int(got_st["step"]) == int(ref["opt"]["step"]) == 1
    _leaves_close(got_st["m"], ref["opt"]["m"], GRAD_REL, "opt m")
    _leaves_close(got_st["u"], ref["opt"]["u"], GRAD_REL, "opt u")
    ju, tu = np_leaves(ref["opt"]["u"]), np_leaves(got_st["u"])
    counts = held_through_moments(
        np_leaves(to_numpy_tree(p2)), np_leaves(ref["params"]),
        np_leaves(got_st["m"]), np_leaves(ref["opt"]["m"]),
        [tap2.ap2_exponent(1.0 / (_t(u) + 1e-8)).numpy() for u in tu],
        [np.asarray(j_ap2_exponent(1.0 / (jnp.asarray(u) + 1e-8)))
         for u in ju], GRAD_REL, first_step_scale(LR))
    # every binarized projection stays in [-1, 1]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(p2), tree_leaves(clip_binary_weights(p2))))
    print(f"{name}: params off by more than {GRAD_REL}: {counts}")


# ---------------------------------------------------------------------------
# stochastic binarization, remat, accumulation
# ---------------------------------------------------------------------------
def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))


def _jax_layer_noise(key, cfg, b, s):
    """JAX's draws of one dense layer (fold_in(key, 0), then the splits of
    _self_block, self_attn, _qkv, ffn and qmatmul) by the port's sites."""
    split = jax.random.split
    d, hq, hd, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.head_dim, \
        cfg.d_ff
    shapes = {"wq": (d, hq), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (hq, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    k1, k2 = split(jax.random.fold_in(key, 0))
    kq, ko = split(k1)
    keys = dict(zip(("wq", "wk", "wv"), split(kq, 3)))
    keys["wo"] = ko
    keys.update(zip(("w_gate", "w_up", "w_down"), split(k2, 3)))
    noise = {}
    for name, kk in keys.items():
        kw, ka = split(kk)
        site = f"blocks.0.{'attn' if name[1] != '_' else 'ffn'}.{name}"
        noise[f"{site}.qact"] = _uniform(ka, (b, s, shapes[name][0]))
        noise[f"{site}.w"] = _uniform(kw, shapes[name])
    return noise


def test_bbp_with_jax_draws_matches_jax():
    """One layer in mode 'bbp', JAX's draws fed to the port by site: the
    loss and every gradient."""
    jcfg = jax_smoke("phi3-medium-14b").scaled(n_layers=1, quant="bbp")
    cfg = smoke_config("phi3-medium-14b").scaled(n_layers=1, quant="bbp")
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(1))
    toks = _batch(cfg, seed=3)["tokens"]
    key = jax.random.PRNGKey(5)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_get_model(jcfg).loss(p, {"tokens": jnp.asarray(toks)},
                                           key=key), has_aux=True))(jp)
    noise = {k: _t(v) for k, v in
             _jax_layer_noise(key, cfg, *toks.shape).items()}
    params = to_port(jax_to_np(jp))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = get_model(cfg).loss(params, {"tokens": _t(toks)}, noise=noise)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_REL, abs=0)
    _leaves_close(to_numpy_tree(_unflatten(params, grads)), jax_to_np(jg),
                  GRAD_REL, "bbp grads")


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "llama-3.2-vision-11b"])
def test_remat_replays_the_generators_draws(arch):
    """Mode 'bbp' from a generator: the loss and gradients with each block
    (vlm: group) recomputed in the backward equal those without, bit for
    bit, and the generator ends where it would without remat."""
    runs = []
    for remat in (True, False):
        cfg = smoke_config(arch).scaled(quant="bbp", remat=remat)
        params = get_model(cfg).init(torch.Generator().manual_seed(2),
                                     device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        gen = torch.Generator().manual_seed(9)
        batch = {k: _t(v) for k, v in _batch(cfg, seed=4).items()}
        loss, _ = get_model(cfg).loss(params, batch, gen=gen)
        grads = torch.autograd.grad(loss, leaves)
        runs.append((loss.detach(), grads, torch.rand(3, generator=gen)))
    (la, ga, ra), (lb, gb, rb) = runs
    assert torch.equal(la, lb) and torch.equal(ra, rb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb, strict=True))


def _capture_opt_jax():
    return JOptimizer(init=lambda p: None,
                      update=lambda g, s, p: (jax.tree.map(jnp.zeros_like, g),
                                              g))


def _capture_opt_port():
    return Optimizer(init=lambda p: None,
                     update=lambda g, s, p, donate=False: (
                         tree_map(torch.zeros_like, g), g))


def test_gradient_accumulation_matches_jax():
    """accum=2 (two microbatches of 2 rows, float32 sums / 2) against JAX's
    accum=2, and against one batch of 4 rows (accum=1; a dense stack, whose
    loss is a mean over rows: a MoE's capacity and load-balance loss are
    per call)."""
    jcfg, cfg, np_p, _ = _case("phi3")
    np_b = _batch(cfg, seed=6, b=4)
    jp = jax.tree.map(jnp.asarray, np_p)
    jb = {k: jnp.asarray(v) for k, v in np_b.items()}
    _, jg, jm = jax.jit(j_make_train_step(jax_get_model(jcfg),
                                          _capture_opt_jax(), accum=2))(
        jp, None, jb, None)
    grads = {}
    for accum in (1, 2):
        _, g, m = make_train_step(get_model(cfg), _capture_opt_port(),
                                  accum=accum)(
            to_port(np_p), None, {k: _t(v) for k, v in np_b.items()})
        grads[accum] = to_numpy_tree(g)
        if accum == 2:
            assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=LOSS_REL, abs=0)
    _leaves_close(grads[2], jax_to_np(jg), GRAD_REL, "accum=2 grads")
    _leaves_close(grads[1], grads[2], GRAD_REL, "accum=1 vs 2")


# ---------------------------------------------------------------------------
# Model.loss on frozen trees; param_count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_loss_refuses_a_frozen_tree(arch):
    cfg = smoke_config(arch)
    model = get_model(cfg)
    frozen = model.freeze(model.init(torch.Generator().manual_seed(0),
                                     device="cpu"))
    with pytest.raises(ValueError, match="frozen"):
        model.loss(frozen, {"tokens": torch.zeros((1, 8), dtype=torch.int64)})


@pytest.mark.parametrize("name", ["phi3", "nemotron", "dbrx_cf8", "vlm"])
def test_param_count_matches_jax(name):
    jcfg, cfg, np_p, _ = _case(name)
    jp = jax.tree.map(jnp.asarray, np_p)
    params = to_port(np_p)
    assert param_count(params) == j_param_count(jp)
    from repro_torch.core.packed import (
        attach_ffn_act_thresholds, freeze_params,
    )
    from repro.core.packed import attach_ffn_act_thresholds as j_attach
    jf, tf = j_freeze(jp), freeze_params(params)
    if cfg.mlp == "sq_relu":
        jf, tf = j_attach(jf, "sq_relu"), attach_ffn_act_thresholds(tf)
    assert param_count(tf) == j_param_count(jf)
