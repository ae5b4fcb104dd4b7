"""The port's training primitives against the JAX package's: the STE
binarizers, stochastic binarization fed JAX's own draws, the train-time
quantized matmul, and batch norm / shift-BN in training mode.

Tolerances. Signs, +-1 values, STE masks and BN counts are held exactly.
The binarizers' values and gradients are held exactly too: a gradient there
is the upstream gradient times 0, 1/2 or 1. qmatmul's values and gradients
are exact sums here (the inputs are 8-bit pixels, multiples of 1/128, and
the upstream gradients small integers, so every float32 sum is exact in any
order). BN outputs, states and gradients are float sums over the batch taken
in another order by XLA and torch: held to 1e-5 relative to the largest
magnitude of each tensor. Stochastic draws: the JAX package's
`jax.random.uniform` draws are recomputed here and fed to the port as
`noise`; the port's own generator is checked statistically.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel, np_to_jax, quantized, random_bn, to_port
from repro.core import shift_bn as jsbn
from repro_torch.core import binarize as tb
from repro_torch.core import layers as tl
from repro_torch.core import shift_bn as tsbn

# the JAX package's core/__init__ re-exports functions named like these
# modules, so they are taken from the module table
jb = importlib.import_module("repro.core.binarize")
jl = importlib.import_module("repro.core.layers")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _edge_values(rng, shape):
    """Values in [-2, 2] with the STE's and HT's edges hit exactly."""
    x = rng.uniform(-2, 2, shape).astype(np.float32)
    x.reshape(-1)[:8] = [-1.0, 1.0, 0.0, -0.0, -2.0, 2.0, 0.5, -0.999]
    return x


def _grads(jfn, tfn, x, c):
    """Values and gradients of sum(f(x) * c) on both sides."""
    jv, jg = jax.value_and_grad(lambda v: jnp.sum(jfn(v) * c))(jnp.asarray(x))
    xt = _t(x, grad=True)
    out = tfn(xt)
    (out * _t(c)).sum().backward()
    return (np.asarray(jfn(jnp.asarray(x))), out.detach().numpy(),
            np.asarray(jg), xt.grad.numpy())


@pytest.mark.parametrize("name", ["hard_tanh", "binarize_det", "binary_act"])
def test_deterministic_binarizers_and_their_ste_match_jax(name):
    rng = np.random.default_rng(0)
    x = _edge_values(rng, 300)
    c = rng.integers(-3, 4, 300).astype(np.float32)
    jv, tv, jg, tg = _grads(getattr(jb, name), getattr(tb, name), x, c)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tg, jg)
    if name == "hard_tanh":
        # jnp.clip's gradient at exactly +-1 is 1/2 (a tie of max / min)
        assert tg[0] == 0.5 * c[0] and tg[1] == 0.5 * c[1]


@pytest.mark.parametrize("act", [False, True])
def test_stochastic_binarization_with_jax_draws_matches_jax(act):
    rng = np.random.default_rng(1)
    x = _edge_values(rng, (40, 17))
    c = rng.integers(-3, 4, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    if act:
        jfn = lambda v: jb.binary_act(v, stochastic=True, key=key)  # noqa: E731
        tfn = lambda v: tb.binary_act(v, stochastic=True, noise=_t(u))  # noqa: E731
    else:
        jfn = lambda v: jb.binarize_stoch(v, key)  # noqa: E731
        tfn = lambda v: tb.binarize(v, stochastic=True, noise=_t(u))  # noqa: E731
    jv, tv, jg, tg = _grads(jfn, tfn, x, c)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tg, jg)
    assert set(np.unique(tv)) <= {-1.0, 1.0}


def test_stochastic_binarization_from_a_generator_has_hard_sigmoid_odds():
    grid = torch.linspace(-1.25, 1.25, 11)
    n = 20000
    x = grid.repeat(n, 1)
    b = tb.binarize(x, stochastic=True, gen=torch.Generator().manual_seed(3))
    p_hat = (b > 0).double().mean(0)
    p = tb.hard_sigmoid(grid).double()
    sigma = torch.sqrt(p * (1 - p) / n).clamp(min=1e-12)
    # within 5 standard errors; saturated inputs are deterministic
    assert bool(((p_hat - p).abs() <= 5 * sigma + 1e-12).all()), (p_hat, p)
    again = tb.binarize(x, stochastic=True,
                        gen=torch.Generator().manual_seed(3))
    assert torch.equal(b, again)
    with pytest.raises(ValueError, match="generator or a noise"):
        tb.binarize(x, stochastic=True)


@pytest.mark.parametrize("mode", ["bbp", "bc", "bbp_det"])
def test_train_qmatmul_with_jax_draws_matches_jax(mode):
    rng = np.random.default_rng(2)
    x = quantized(rng, (6, 40))
    x[0, :4] = [1.0, -1.0, 0.0, 0.5]
    w = rng.uniform(-1.2, 1.2, (40, 9)).astype(np.float32)
    c = rng.integers(-3, 4, (6, 9)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw, ka = jax.random.split(key)
    noise = {"act": _t(jax.random.uniform(ka, x.shape, dtype=jnp.float32)),
             "w": _t(jax.random.uniform(kw, w.shape, dtype=jnp.float32))}
    jm, tm = jl.QuantMode(mode), tl.QuantMode(mode)

    def jloss(xv, wv):
        return jnp.sum(jl.qmatmul(xv, wv, jm, train=True, key=key) * c)

    jv = np.asarray(jl.qmatmul(jnp.asarray(x), jnp.asarray(w), jm, train=True,
                               key=key))
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    out = tl.qmatmul(xt, wt, tm, train=True,
                     noise=None if mode == "bbp_det" else noise)
    (out * _t(c)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), jv)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jgw))


def test_train_qmatmul_draws_activation_then_weight_from_a_generator():
    rng = np.random.default_rng(3)
    x = _t(rng.uniform(-1, 1, (5, 12)).astype(np.float32))
    w = _t(rng.uniform(-1, 1, (12, 4)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    got = tl.qmatmul(x, w, tl.QuantMode.BBP, train=True, gen=g)
    g2 = torch.Generator().manual_seed(5)
    ua = torch.rand(x.shape, generator=g2)
    uw = torch.rand(w.shape, generator=g2)
    want = tl.qmatmul(x, w, tl.QuantMode.BBP, train=True,
                      noise={"act": ua, "w": uw})
    assert torch.equal(got, want)
    # at inference the same call is deterministic
    det = tl.qmatmul(x, w, tl.QuantMode.BBP)
    assert torch.equal(det, tb.binary_act(x) @ tb.binarize(w))


@pytest.mark.parametrize("kind", ["shift", "exact"])
@pytest.mark.parametrize("shape", [(16, 24), (4, 5, 5, 6)])
def test_bn_train_mode_matches_jax(kind, shape):
    rng = np.random.default_rng(4)
    c = shape[-1]
    p, s = random_bn(rng, c)
    s["count"] = np.array(3, np.int32)
    x = (rng.normal(size=shape) * 5 + rng.normal(size=c) * 2).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jfn = jsbn.shift_batch_norm if kind == "shift" else jsbn.batch_norm
    tfn = tsbn.shift_batch_norm if kind == "shift" else tsbn.batch_norm

    def jloss(xv, pv):
        out, _ = jfn(pv, np_to_jax(s), xv, train=True)
        return jnp.sum(out * g)

    jout, jst = jfn(np_to_jax(p), np_to_jax(s), jnp.asarray(x), train=True)
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), np_to_jax(p))
    tp = to_port(p)
    tp = tsbn.BNParams(tp.gamma.requires_grad_(), tp.beta.requires_grad_())
    xt = _t(x, True)
    out, st = tfn(tp, to_port(s), xt, train=True)
    (out * _t(g)).sum().backward()
    assert_rel(out.detach().numpy(), np.asarray(jout), what="output")
    assert_rel(st.mean.numpy(), np.asarray(jst.mean), what="running mean")
    assert_rel(st.var.numpy(), np.asarray(jst.var), what="running var")
    assert int(st.count) == int(jst.count) == 4
    assert not st.mean.requires_grad and not st.var.requires_grad
    assert_rel(xt.grad.numpy(), np.asarray(jgx), what="grad x")
    assert_rel(tp.beta.grad.numpy(), np.asarray(jgp.beta), what="grad beta")
    assert_rel(tp.gamma.grad.numpy(), np.asarray(jgp.gamma), what="grad gamma")
    if kind == "shift":
        # AP2(gamma) is a shift: no gradient reaches gamma, in either package
        assert not np.asarray(jgp.gamma).any()
        assert not tp.gamma.grad.any()


def test_bn_inference_is_the_default_and_leaves_the_state():
    rng = np.random.default_rng(5)
    p, s = random_bn(rng, 8)
    x = _t(rng.normal(size=(3, 8)).astype(np.float32))
    for fn in (tsbn.batch_norm, tsbn.shift_batch_norm):
        st = to_port(s)
        _, out_state = fn(to_port(p), st, x)
        assert out_state is st


def test_saturation_fraction_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.uniform(-1, 1, 500).astype(np.float32)
    w[:50] = 1.0
    w[50:70] = -0.9995
    assert float(tb.saturation_fraction(_t(w))) == pytest.approx(
        float(jb.saturation_fraction(jnp.asarray(w))), abs=0)
