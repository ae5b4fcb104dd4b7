"""The port's training path of the SSM families against the JAX package's,
at smoke size (float32): falcon-mamba-7b (`mamba_loss`: the Mamba block's
sequential, remat'd chunk scan) and recurrentgemma-2b (`rg_loss`: the
RG-LRU's associative-scan recursion, local attention, GeGLU MLPs, the tied
head), their gradients and one `make_train_step` step; the training scan
alone against JAX's `_mamba_chunk_scan` with its VJP; kernel 10's wrapper
refusing inputs that require a gradient; remat with a generator.

Params are the JAX package's init, batches 2 x 24 tokens from a numpy
seed; tolerances and the denormal flush are tests/test_torch_lm_train.py's
(the largest gradient difference measured here is 5.2e-6 of its tensor).
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
from repro.models import ssm as JS
from repro.models.api import get_model as jax_get_model
from repro.train.step import default_optimizer as j_default_optimizer
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core import ap2 as tap2
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import ssm as TS
from repro_torch.models.api import get_model
from repro_torch.optim.base import tree_leaves
from repro_torch.train.step import default_optimizer, make_train_step
from test_torch_lm_train import (
    GRAD_REL, LOSS_REL, LR, _batch, _leaves_close, _stash_grads, _t,
)

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(arch):
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jax_to_np(jp), _batch(cfg)


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    jcfg, _, np_p, np_b = _case(arch)
    opt = _stash_grads(j_default_optimizer(jcfg, LR), True)
    p = jax.tree.map(jnp.asarray, np_p)
    p2, (st2, g), m = jax.jit(j_make_train_step(jax_get_model(jcfg), opt))(
        p, opt.init(p), {"tokens": jnp.asarray(np_b["tokens"])}, None)
    return {"metrics": jax_to_np(m), "grads": jax_to_np(g),
            "params": jax_to_np(p2), "opt": jax_to_np(st2)}


@functools.lru_cache(maxsize=None)
def _port_step(arch):
    _, cfg, np_p, np_b = _case(arch)
    opt = _stash_grads(default_optimizer(cfg, LR), False)
    params = to_port(np_p)
    p2, (st2, g), m = make_train_step(get_model(cfg), opt)(
        params, opt.init(params), {"tokens": _t(np_b["tokens"])})
    return p2, st2, g, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("h0", [False, True])
def test_mamba_chunk_scan_and_its_gradient_match_jax(h0):
    """20 steps in chunks of 8 (a ragged last chunk, which JAX pads with dt
    = 0), from zero state or from h0: y, the final state and the gradients
    of every input."""
    rng = np.random.default_rng(11)
    b, t, d, n = 2, 20, 12, 4
    dt = rng.uniform(0.001, 0.2, (b, t, d)).astype(np.float32)
    xi, bm, cm = (rng.normal(size=sz).astype(np.float32)
                  for sz in ((b, t, d), (b, t, n), (b, t, n)))
    a_log = np.log(rng.uniform(0.5, 4.0, (d, n))).astype(np.float32)
    h_0 = rng.normal(size=(b, d, n)).astype(np.float32) if h0 else None
    gy = rng.normal(size=(b, t, d)).astype(np.float32)
    gh = rng.normal(size=(b, d, n)).astype(np.float32)

    def jfn(a_log, dt, xi, bm, cm, *h):
        return JS._mamba_chunk_scan({"A_log": a_log}, dt, xi, bm, cm, 8,
                                    h0=h[0] if h else None)
    args = [a_log, dt, xi, bm, cm] + ([h_0] if h0 else [])
    (jy, jh), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = TS.mamba_chunk_scan(*targs[:5], 8, *(targs[5:]))
    tgrads = torch.autograd.grad((y, h), targs,
                                 (torch.from_numpy(gy), torch.from_numpy(gh)))
    assert_rel(y.detach().numpy(), jy, rel=1e-6, what="y")
    assert_rel(h.detach().numpy(), jh, rel=1e-6, what="h")
    for i, (got, want) in enumerate(zip(tgrads, jgrads, strict=True)):
        assert_rel(got.numpy(), want, rel=1e-5, what=f"grad {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_loss_and_gradients_match_jax(arch):
    ref = _jax_step(arch)
    _, _, grads, metrics = _port_step(arch)
    assert set(metrics) == set(ref["metrics"]) == {"nll", "loss"}
    for k in metrics:
        assert metrics[k] == pytest.approx(float(ref["metrics"][k]),
                                           rel=LOSS_REL, abs=0)
    _leaves_close(to_numpy_tree(grads), ref["grads"], GRAD_REL, "grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_one_train_step_matches_jax(arch):
    ref = _jax_step(arch)
    p2, st2, _, _ = _port_step(arch)
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
    print(f"{arch}: params off by more than {GRAD_REL}: {counts}")


def test_rg_gates_are_clipped_and_trained():
    """w_input_gate / w_rec_gate: float32 products in the recurrence, never
    binarized, but clipped with the binary weights (Algorithm 1's clip set,
    `train.step._CLIP_KEYS`), and they get gradients."""
    p2, _, grads, _ = _port_step("recurrentgemma-2b")
    for key in ("w_input_gate", "w_rec_gate"):
        assert float(grads["groups"]["rec"]["mix"][key].abs().max()) > 0
        assert float(p2["groups"]["rec"]["mix"][key].abs().max()) <= 1.0


def test_selective_scan_refuses_inputs_that_require_a_gradient():
    """Kernel 10 has no backward: its wrapper raises rather than return a
    result cut off from the graph (on any device; the train path takes
    `mamba_chunk_scan`)."""
    b, t, d, n = 1, 4, 8, 4
    dt = torch.rand(b, t, d, requires_grad=True)
    args = (torch.randn(b, t, d), torch.randn(b, t, n), torch.randn(b, t, n),
            -torch.rand(d, n))
    with pytest.raises(RuntimeError, match="no backward"):
        tss.selective_scan(dt, *args)
    with torch.no_grad():
        tss.selective_scan(dt, *args)          # inference is served


def test_mamba_training_never_calls_kernel_10(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the train path called kernel 10's wrapper")
    monkeypatch.setattr(TS, "selective_scan", refuse)
    cfg = smoke_config("falcon-mamba-7b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = get_model(cfg).loss(params, {"tokens": torch.zeros(
        (1, 9), dtype=torch.int64)})
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_remat_replays_the_generators_draws(arch):
    runs = []
    for remat in (True, False):
        cfg = smoke_config(arch).scaled(quant="bbp", remat=remat)
        params = get_model(cfg).init(torch.Generator().manual_seed(2),
                                     device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        gen = torch.Generator().manual_seed(9)
        loss, _ = get_model(cfg).loss(
            params, {"tokens": _t(_batch(cfg, seed=4)["tokens"])}, gen=gen)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves),
                     torch.rand(3, generator=gen)))
    (la, ga, ra), (lb, gb, rb) = runs
    assert torch.equal(la, lb) and torch.equal(ra, rb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb, strict=True))
