"""The port's optimizers against the JAX package's: AdaMax, S-AdaMax, the
right-shift LR schedule, the weight clip and global-norm clipping, over
param trees shaped like the paper CNN's (dicts, lists, BN records), and the
optimizer state carried across by `repro_torch.convert`.

Tolerances. Step counts are held exactly. Moments m and u are one multiply
and add of the same float32 operands (XLA may contract them into a fused
multiply-add, torch does not), held to 1e-5 relative to the largest
magnitude of each tensor. Updates likewise, except where an AP2 factor
differs between the two packages: S-AdaMax snaps lr / (1 - b1^t) and
1 / (u + eps) to powers of two, so an ulp of difference in u or in b1^t
(XLA's and torch's float32 pow differ by an ulp at some t) doubles or
halves the factor where round(log2) falls between the two inputs. Every
such element is proven to lie there (`ap2_straddles`); none is waved
through by a wider tolerance. The schedule: JAX builds 2^-k with jnp.exp2,
which is not exact for k >= 13 on the CPU; the port's is the exact power
of two, and JAX's is held to it at 1e-5 relative there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    ap2_straddles, assert_rel, jax_to_np, np_cnn, np_leaves, np_to_jax,
    to_port,
)
from repro.optim import base as jbase
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.optim import base as tbase

# both optim packages re-export the function shift_adamax under the
# module's name, so the modules are taken from the module table
jsa = importlib.import_module("repro.optim.shift_adamax")
tsa = importlib.import_module("repro_torch.optim.shift_adamax")

SMALL = dict(widths=(4, 4, 8, 8, 8, 8), fc=16, img=8)


def _tree(seed):
    """A numpy param tree of the small CNN, and the rng that made it."""
    rng = np.random.default_rng(seed)
    params, _ = np_cnn(rng, **SMALL)
    return params, rng


def _like(tree, rng, fn):
    if isinstance(tree, dict):
        return {k: _like(v, rng, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, rng, fn) for v in tree]
    return fn(rng, np.asarray(tree).shape)


def _grads(rng, params):
    """Gradients spread over six decades, with exact zeros."""
    def fn(r, shape):
        g = r.normal(size=shape) * 10.0 ** r.integers(-4, 2, shape)
        g.reshape(-1)[::17] = 0.0
        return g.astype(np.float32)
    return _like(params, rng, fn)


def _state(rng, params, step):
    m = _like(params, rng, lambda r, s: (r.normal(size=s) * 0.1
                                         ).astype(np.float32))
    u = _like(params, rng, lambda r, s: np.abs(r.normal(size=s) * 0.3
                                               ).astype(np.float32))
    return {"m": m, "u": u, "step": np.array(step, np.int32)}


def _run_both(kind, lr, params, grads, state, steps):
    """`steps` updates on both sides from the same grads and state; returns
    the numpy updates and states of each step."""
    jopt, topt = getattr(jsa, kind)(lr), getattr(tsa, kind)(lr)
    jst, tst = np_to_jax(state), from_numpy_tree(state, device="cpu")
    jg, tg = np_to_jax(grads), to_port(grads)
    out = []
    for _ in range(steps):
        ju, jst = jopt.update(jg, jst, np_to_jax(params))
        tu, tst = topt.update(tg, tst, to_port(params))
        out.append((jax_to_np(ju), to_numpy_tree(tu), jax_to_np(jst),
                    to_numpy_tree(tst)))
    return out


def _check_updates(kind, ju, tu, jst, tst):
    """Updates equal at 1e-5 relative, except elements proven to sit at an
    AP2 boundary (see the module doc); returns how many those were."""
    assert int(tst["step"]) == int(jst["step"])
    jm, tm = np_leaves(jst["m"]), np_leaves(tst["m"])
    juu, tuu = np_leaves(jst["u"]), np_leaves(tst["u"])
    boundary = 0
    for i, (a, b) in enumerate(zip(np_leaves(ju), np_leaves(tu))):
        assert_rel(tm[i], jm[i], what=f"m leaf {i}")
        assert_rel(tuu[i], juu[i], what=f"u leaf {i}")
        if kind == "adamax":
            assert_rel(b, a, what=f"update leaf {i}")
            continue
        scale = np.abs(a).max()
        off = np.abs(a.astype(np.float64) - b) > 1e-5 * scale
        if off.any():
            proven = ap2_straddles(1.0 / (juu[i][off] + 1e-8),
                                   1.0 / (tuu[i][off] + 1e-8))
            assert proven.all(), (f"update leaf {i}: {int((~proven).sum())} "
                                  f"elements differ off an AP2 boundary")
            boundary += int(off.sum())
    return boundary


@pytest.mark.parametrize("kind", ["adamax", "shift_adamax"])
@pytest.mark.parametrize("step0", [0, 9, 640])
def test_adamax_updates_match_jax(kind, step0):
    params, rng = _tree(0)
    grads = _grads(rng, params)
    state = _state(rng, params, step0)
    lr = 2.0 ** -6
    runs = _run_both(kind, lr, params, grads, state, 3)
    for i, (ju, tu, jst, tst) in enumerate(runs):
        _check_updates(kind, ju, tu, jst, tst)
        assert int(tst["step"]) == step0 + i + 1


@pytest.mark.parametrize("kind", ["adamax", "shift_adamax"])
def test_adamax_from_init_with_the_schedule_matches_jax(kind):
    params, rng = _tree(1)
    jopt = getattr(jsa, kind)(jsa.shift_lr_schedule(2 ** -6, 50))
    topt = getattr(tsa, kind)(tsa.shift_lr_schedule(2 ** -6, 50))
    jst, tst = jopt.init(np_to_jax(params)), topt.init(to_port(params))
    for a, b in zip(np_leaves(jax_to_np(jst)), np_leaves(to_numpy_tree(tst)),
                    strict=True):
        np.testing.assert_array_equal(b, a)
    for _ in range(4):
        grads = _grads(rng, params)
        ju, jst = jopt.update(np_to_jax(grads), jst, np_to_jax(params))
        tu, tst = topt.update(to_port(grads), tst, to_port(params))
        _check_updates(kind, jax_to_np(ju), to_numpy_tree(tu), jax_to_np(jst),
                       to_numpy_tree(tst))
    assert int(tst.step) == 4


def test_shift_lr_schedule_is_exact_and_matches_jax():
    steps = np.arange(0, 2500, 7, dtype=np.int32)
    for base, every in ((2 ** -6, 50), (0.01, 100), (2 ** -7, 3)):
        jsched = jsa.shift_lr_schedule(base, every)
        tsched = tsa.shift_lr_schedule(base, every)
        want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
        got = tsched(torch.from_numpy(steps)).numpy()
        exp = np.round(np.log2(base)) - steps // every
        np.testing.assert_array_equal(got, np.exp2(exp).astype(np.float32))
        exact = (steps // every) < 13       # where jnp.exp2 is exact here
        np.testing.assert_array_equal(got[exact], want[exact])
        # past it jnp.exp2(-k) is off by up to ~2e-6 relative on this CPU;
        # below 2^-126 XLA flushes to 0 where the port keeps the subnormal
        normal = exp >= -126
        np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5, atol=0)


def test_weight_clip_and_global_norm_match_jax():
    params, rng = _tree(2)
    grads = _grads(rng, params)
    jg, tg = np_to_jax(grads), to_port(grads)
    assert float(tbase.global_norm(tg)) == pytest.approx(
        float(jbase.global_norm(jg)), rel=1e-6)
    for max_norm in (1e-3, 1e6):
        jc, jn = jbase.clip_by_global_norm(jg, max_norm)
        tc, tn = tbase.clip_by_global_norm(tg, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for a, b in zip(np_leaves(jax_to_np(jc)), np_leaves(to_numpy_tree(tc))):
            assert_rel(b, a)
    is_w = (lambda path: any(getattr(k, "key", None) == "w" for k in path))
    jopt = jbase.chain_weight_clip(jsa.adamax(0.5), predicate=is_w)
    topt = tbase.chain_weight_clip(tsa.adamax(0.5),
                                   predicate=lambda path: "w" in path)
    jp, tp = np_to_jax(params), to_port(params)
    ju, _ = jopt.update(jg, jopt.init(jp), jp)
    tu, _ = topt.update(tg, topt.init(tp), tp)
    jnew = jax_to_np(jbase.apply_updates(jp, ju))
    tnew = to_numpy_tree(tbase.apply_updates(tp, tu))
    for a, b in zip(np_leaves(jnew), np_leaves(tnew)):
        assert_rel(b, a)
    assert max(np.abs(leaf).max() for leaf in np_leaves(tnew["convs"][0]["w"])
               ) <= 1.0


def test_adamax_state_converts_both_ways():
    params, rng = _tree(3)
    jst = jsa.shift_adamax(0.01).init(np_to_jax(params))
    jst = jsa.AdaMaxState(m=np_to_jax(_grads(rng, params)),
                          u=np_to_jax(_grads(rng, params)),
                          step=jnp.asarray(12, jnp.int32))
    as_np = jax_to_np(jst)
    tst = from_numpy_tree(as_np, device="cpu")
    assert isinstance(tst, tsa.AdaMaxState)
    assert isinstance(tst.m["convs"][0]["bn"], type(to_port(params)["convs"][0]["bn"]))
    assert tst.step.dtype == torch.int32 and int(tst.step) == 12
    back = to_numpy_tree(tst)
    assert set(back) == {"m", "u", "step"}
    for a, b in zip(np_leaves(as_np), np_leaves(back)):
        np.testing.assert_array_equal(b, a)
    again = jax_to_np(np_to_jax(back))
    for a, b in zip(np_leaves(as_np), np_leaves(again)):
        np.testing.assert_array_equal(b, a)
