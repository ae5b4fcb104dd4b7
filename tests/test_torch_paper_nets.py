"""The port's paper networks against the JAX package's, end to end.

Weights, BN params and running stats and inputs are made with numpy from
a seed and fed to both packages (`repro_torch.convert` carries them across;
frozen JAX trees cross the same way). On the CPU the port's frozen binary
layers run the kernels' plain versions.

Tolerance. In 'bbp' mode scores, hidden words and thresholds must be equal
(tolerance 0): inputs are multiples of 1/128 in [-1, 1] (8-bit pixels), so
the float input layer's sums against +-1 weights are exact in float32 in
any order; after it there are only sign bits, integer popcount dots, a bias
add and power-of-two scalings, each one rounding of identical operands. The
'bc' and 'float' MLP baselines multiply arbitrary float32 activations after
the input layer; XLA and torch sum those products in different orders, so
they are held to rtol = atol = 1e-5 (a 33-term float32 sum of terms <= 1 is
off by at most ~33 * 2^-24 ~ 2e-6 relative to its terms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_to_np, np_cnn, np_mlp, np_to_jax, quantized, to_port, words,
)
from repro.models import paper_nets as jpn
from repro_torch.kernels import binary_gemm as bg
from repro_torch.models import paper_nets as tpn

SMALL_CNN = dict(widths=(4,) * 6, fc=48, img=8)


def _capture_jax_hidden(monkeypatch):
    """Record the PackedActivations JAX's bit-resident chain passes between
    layers (its forwards do not return them)."""
    seen = []
    orig = jpn.packed_qmatmul_fused

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(np.asarray(out.packed))
        return out

    monkeypatch.setattr(jpn, "packed_qmatmul_fused", spy)
    return seen


@pytest.mark.parametrize("mode", ["bbp", "bc", "float"])
def test_mlp_master_matches_jax(mode):
    rng = np.random.default_rng(0)
    p = np_mlp(rng, 20, 33)
    x = quantized(rng, (4, 20))
    want = np.asarray(jpn.mlp_forward(np_to_jax(p), jnp.asarray(x), mode=mode))
    got = tpn.mlp_forward(to_port(p), torch.from_numpy(x), mode=mode).numpy()
    if mode == "bbp":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _mlp_frozen_case(monkeypatch, in_dim, hidden, batch, seed):
    rng = np.random.default_rng(seed)
    p = np_mlp(rng, in_dim, hidden)
    x = quantized(rng, (batch, in_dim))
    jp, tp = np_to_jax(p), to_port(p)
    want = np.asarray(jpn.mlp_forward(jp, jnp.asarray(x)))
    jf, tf = jpn.freeze_mlp(jp), tpn.freeze_mlp(tp)
    for jl, tl in zip(jf["layers"], tf["layers"]):
        np.testing.assert_array_equal(words(tl["w"].packed),
                                      np.asarray(jl["w"].packed))
        assert tl["w"].fold == jl["w"].fold
        if jl["w"].thresh is not None:
            np.testing.assert_array_equal(tl["w"].thresh.numpy(),
                                          np.asarray(jl["w"].thresh))
    jax_hidden = _capture_jax_hidden(monkeypatch)
    np.testing.assert_array_equal(
        np.asarray(jpn.mlp_forward(jf, jnp.asarray(x))), want)
    xt = torch.from_numpy(x)
    for tree in (tf, to_port(jax_to_np(jf))):
        for path in ("auto", "ref"):
            hidden = []
            got = tpn.mlp_forward(tree, xt, kernel_path=path, hidden=hidden)
            np.testing.assert_array_equal(got.numpy(), want)
            assert len(hidden) == len(jax_hidden) == 2
            for th, jh in zip(hidden, jax_hidden):
                np.testing.assert_array_equal(words(th.packed), jh)
    np.testing.assert_array_equal(tpn.mlp_forward(tp, xt).numpy(), want)


def test_mlp_frozen_matches_jax(monkeypatch):
    _mlp_frozen_case(monkeypatch, 20, 33, 4, seed=1)


def test_mlp_frozen_full_width_matches_jax(monkeypatch):
    """bnn-mnist at its published widths, 784-1024x3-10, batch 4."""
    _mlp_frozen_case(monkeypatch, 784, 1024, 4, seed=2)


@pytest.mark.parametrize("bn_kind", ["shift", "exact"])
def test_cnn_master_and_frozen_match_jax(bn_kind, monkeypatch):
    rng = np.random.default_rng(3)
    p, s = np_cnn(rng, **SMALL_CNN)
    x = quantized(rng, (2, 8, 8, 3))
    jp, js, tp, ts = np_to_jax(p), np_to_jax(s), to_port(p), to_port(s)
    want, _ = jpn.cnn_forward(jp, js, jnp.asarray(x), mode="bbp",
                              bn_kind=bn_kind)
    want = np.asarray(want)
    xt = torch.from_numpy(x)
    got, bn_out = tpn.cnn_forward(tp, ts, xt, bn_kind=bn_kind)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bn_out["fc1"] is ts["fc1"]

    jf = jpn.freeze_cnn(jp, js, bn_kind=bn_kind)
    tf = tpn.freeze_cnn(tp, ts, bn_kind=bn_kind)
    for name in ("fc1", "fc2"):
        assert tf[name]["w"].fold == jf[name]["w"].fold == f"{bn_kind}-bn"
        np.testing.assert_array_equal(tf[name]["w"].thresh.numpy(),
                                      np.asarray(jf[name]["w"].thresh))
        np.testing.assert_array_equal(tf[name]["w"].flip.numpy(),
                                      np.asarray(jf[name]["w"].flip))
    for jc, tc in zip(jf["convs"], tf["convs"]):
        assert tc["w"].kind == "conv"
        np.testing.assert_array_equal(words(tc["w"].packed),
                                      np.asarray(jc["w"].packed))
    jax_hidden = _capture_jax_hidden(monkeypatch)
    jgot, _ = jpn.cnn_forward(jf, js, jnp.asarray(x), mode="bbp",
                              bn_kind=bn_kind)
    np.testing.assert_array_equal(np.asarray(jgot), want)
    for tree in (tf, to_port(jax_to_np(jf))):
        for path in ("auto", "ref"):
            hidden = []
            got, _ = tpn.cnn_forward(tree, ts, xt, bn_kind=bn_kind,
                                     kernel_path=path, hidden=hidden)
            np.testing.assert_array_equal(got.numpy(), want)
            assert len(hidden) == len(jax_hidden) == 2
            for th, jh in zip(hidden, jax_hidden):
                np.testing.assert_array_equal(words(th.packed), jh)


def test_cnn_frozen_honors_passed_bn_state_and_kind():
    """The fused FC tail folds its thresholds from the bn params/state and
    bn_kind of this call: statistics recalibrated after freeze_cnn (or a
    different bn_kind) are honored, never the freeze-time bake."""
    rng = np.random.default_rng(4)
    p, s = np_cnn(rng, widths=(4,) * 6, fc=16, img=8)
    x = quantized(rng, (2, 8, 8, 3))
    jf = jpn.freeze_cnn(np_to_jax(p), np_to_jax(s), bn_kind="shift")
    s2 = {"convs": [dict(b, mean=b["mean"] + 0.5, var=b["var"] + 0.5)
                    for b in s["convs"]],
          **{n: dict(s[n], mean=s[n]["mean"] + 0.5, var=s[n]["var"] + 0.5)
             for n in ("fc1", "fc2")}}
    for kind in ("shift", "exact"):
        want, _ = jpn.cnn_forward(np_to_jax(p), np_to_jax(s2), jnp.asarray(x),
                                  mode="bbp", bn_kind=kind)
        got, _ = tpn.cnn_forward(to_port(jax_to_np(jf)), to_port(s2),
                                 torch.from_numpy(x), bn_kind=kind)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_forwards_launch_no_kernel():
    rng = np.random.default_rng(5)
    p = np_mlp(rng, 20, 33)
    bg.reset_launches()
    tpn.mlp_forward(tpn.freeze_mlp(to_port(p)),
                    torch.from_numpy(quantized(rng, (3, 20))))
    assert all(v == 0 for v in bg.launches.values())


def test_square_hinge_loss_matches_jax():
    rng = np.random.default_rng(6)
    scores = (rng.normal(size=(32, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 32)
    want = float(jpn.square_hinge_loss(jnp.asarray(scores), jnp.asarray(labels)))
    got = float(tpn.square_hinge_loss(torch.from_numpy(scores),
                                      torch.from_numpy(labels)))
    # a mean of 320 float32 squares: summation order differs, terms <= ~100
    assert got == pytest.approx(want, rel=1e-6)


def test_init_shapes_match_jax_and_are_seeded():
    import jax
    g = torch.Generator().manual_seed(0)
    tm = tpn.init_mlp(g, in_dim=20, hidden=33, device="cpu")
    jm = jpn.init_mlp(jax.random.PRNGKey(0), in_dim=20, hidden=33)
    for tl, jl in zip(tm["layers"], jm["layers"]):
        assert tl["w"].shape == jl["w"].shape and tl["b"].shape == jl["b"].shape
        assert tl["w"].abs().max() <= 1.0
    again = tpn.init_mlp(torch.Generator().manual_seed(0), in_dim=20,
                         hidden=33, device="cpu")
    assert torch.equal(again["layers"][2]["w"], tm["layers"][2]["w"])
    tc, tbn = tpn.init_cnn(torch.Generator().manual_seed(1), **SMALL_CNN,
                           device="cpu")
    jc, jbn = jpn.init_cnn(jax.random.PRNGKey(1), **SMALL_CNN)
    assert [c["w"].shape for c in tc["convs"]] == \
        [c["w"].shape for c in jc["convs"]]
    for name in ("fc1", "fc2", "out"):
        assert tc[name]["w"].shape == jc[name]["w"].shape
    np.testing.assert_array_equal(tbn["fc1"].var.numpy(),
                                  np.asarray(jbn["fc1"].var))
