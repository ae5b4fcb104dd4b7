"""Parity of the port's freeze-time pieces with the JAX package: AP2,
inference (shift-)BN, threshold folding, freeze_params and the resident
byte split.

Thresholds, flips, exponents and words are integers and must be equal
(tolerance 0). A mismatch would be an ULP difference of rsqrt, log2 or a
division between torch and XLA landing on an integer boundary: a parity
fault to report, never a tolerance to widen. Shift-BN outputs are compared
exactly too: every factor there is an exact power of two, so each output
is one rounding of the same subtraction and addition in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_to_np, np_to_jax, random_bn, to_port, uniform, words,
)
from repro.core.ap2 import ap2 as j_ap2, ap2_exponent as j_ap2_exponent
from repro.core.ap2 import is_power_of_two as j_is_power_of_two
from repro.core import packed as jpk
from repro.core import shift_bn as jsbn
from repro_torch.core import ap2 as tap2
from repro_torch.core import packed as tpk
from repro_torch.core import shift_bn as tsbn


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_ap2_matches_jax():
    rng = np.random.default_rng(0)
    z = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(-6, 6, 500),
                        [0.0, -0.0, 1.0, -1.0, 2.0 ** -20, 3.0, -0.75]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(tap2.ap2(_t(z)).numpy(),
                                  np.asarray(j_ap2(jnp.asarray(z))))
    np.testing.assert_array_equal(tap2.ap2_exponent(_t(z)).numpy(),
                                  np.asarray(j_ap2_exponent(jnp.asarray(z))))
    np.testing.assert_array_equal(tap2.is_power_of_two(_t(z)).numpy(),
                                  np.asarray(j_is_power_of_two(jnp.asarray(z))))
    np.testing.assert_array_equal(tap2.is_power_of_two(tap2.ap2(_t(z))).numpy(),
                                  np.ones_like(z, bool))


@pytest.mark.parametrize("kind", ["shift", "exact"])
def test_bn_inference_matches_jax(kind):
    rng = np.random.default_rng(1)
    p, s = random_bn(rng, 24)
    x = (rng.normal(size=(16, 24)) * 5).astype(np.float32)
    jfn = jsbn.shift_batch_norm if kind == "shift" else jsbn.batch_norm
    tfn = tsbn.shift_batch_norm if kind == "shift" else tsbn.batch_norm
    want, _ = jfn(np_to_jax(p), np_to_jax(s), jnp.asarray(x), train=False)
    got, st = tfn(to_port(p), to_port(s), _t(x))
    if kind == "shift":
        # power-of-two factors: each output is one rounding of the same
        # subtraction and addition on both sides, so the bits agree
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # XLA's rsqrt and torch's differ by up to 1 ULP (about a quarter of
        # the channels here); each side then rounds two products and a sum
        # (<= 1.5 ULP), so the sides may differ by 1 + 2 * 1.5 = 4 ULPs of
        # the larger operand of the final sum
        mag = np.abs((x - s["mean"]) / np.sqrt(s["var"] + 1e-4) * p["gamma"])
        mag = np.maximum(mag, np.abs(p["beta"])).astype(np.float32)
        diff = np.abs(got.numpy() - np.asarray(want))
        assert (diff <= 4 * np.spacing(mag)).all()
    assert st.var is not None


@pytest.mark.parametrize("kind", ["shift", "exact"])
def test_fold_bn_sign_threshold_matches_jax(kind):
    rng = np.random.default_rng(2)
    p, s = random_bn(rng, 257)
    p["gamma"][1] = -0.7
    args = [p["gamma"], p["beta"], s["mean"], s["var"]]
    jt, jf = jpk.fold_bn_sign_threshold(*map(jnp.asarray, args), kind=kind)
    tt, tf = tpk.fold_bn_sign_threshold(*map(_t, args), kind=kind)
    assert tt.dtype == torch.int32 and tf.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tt[0] == tpk.ALWAYS_THRESH == jpk.ALWAYS_THRESH


@pytest.mark.parametrize("kind", ["shift", "exact"])
def test_fold_matches_bn_sign_on_integer_dots(kind):
    """(dot >= t) XOR flip == sign(BN(dot)) >= 0 for the port's own BN."""
    rng = np.random.default_rng(3)
    p, s = random_bn(rng, 48)
    dots = rng.integers(-200, 201, (128, 48)).astype(np.float32)
    bn = tsbn.shift_batch_norm if kind == "shift" else tsbn.batch_norm
    y, _ = bn(to_port(p), to_port(s), _t(dots))
    t, f = tpk.fold_bn_sign_threshold(_t(p["gamma"]), _t(p["beta"]),
                                      _t(s["mean"]), _t(s["var"]), kind=kind)
    got = (_t(dots).to(torch.int64) >= t) ^ (f != 0)
    np.testing.assert_array_equal(got.numpy(), y.numpy() >= 0)


def test_fold_bias_and_act_match_jax():
    b = np.array([0.0, -1.0, 1.0, 0.3, -0.7, 2.5, -2.5, 1e-8], np.float32)
    jt, jf = jpk.fold_bias_sign_threshold(jnp.asarray(b))
    tt, tf = tpk.fold_bias_sign_threshold(_t(b))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jt, jf = jpk.fold_act_sign_threshold((2, 5), "sq_relu")
    tt, tf = tpk.fold_act_sign_threshold((2, 5), "sq_relu", device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    with pytest.raises(ValueError):
        tpk.fold_act_sign_threshold(3, "gelu", device="cpu")


def _tree(rng):
    return {"layers": [{"w": uniform(rng, (70, 33)), "b": uniform(rng, (33,))},
                       {"wq": uniform(rng, (2, 33, 40))}],
            "convs": [{"w": uniform(rng, (3, 3, 5, 7))}],
            "norm": uniform(rng, (33,)), "emb": uniform(rng, (10, 33))}


def test_freeze_params_words_match_jax():
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    jfz = jpk.freeze_params(np_to_jax(tree))
    tfz = tpk.freeze_params(to_port(tree))
    for path in (("layers", 0, "w"), ("layers", 1, "wq"), ("convs", 0, "w")):
        jw, tw = jfz, tfz
        for key in path:
            jw, tw = jw[key], tw[key]
        assert isinstance(tw, tpk.PackedWeight)
        assert (tw.kind, tw.k, tw.shape, tw.nbytes) == \
            (jw.kind, jw.k, jw.shape, jw.nbytes)
        np.testing.assert_array_equal(words(tw.packed), np.asarray(jw.packed))
        np.testing.assert_array_equal(tw.unpack().numpy(),
                                      np.asarray(jw.unpack()))
    # non-binary leaves pass through untouched
    assert isinstance(tfz["emb"], torch.Tensor) and tfz["emb"].ndim == 2
    assert isinstance(tfz["layers"][0]["b"], torch.Tensor)
    assert tpk.params_frozen(tfz) and not tpk.params_frozen(to_port(tree))
    back = tpk.unfreeze_params(tfz)
    np.testing.assert_array_equal(
        back["convs"][0]["w"].numpy(),
        np.where(tree["convs"][0]["w"] >= 0, 1.0, -1.0))


def test_resident_weight_bytes_matches_jax_and_is_32x():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    for frz in (False, True):
        jt, tt = np_to_jax(tree), to_port(tree)
        if frz:
            jt, tt = jpk.freeze_params(jt), tpk.freeze_params(tt)
        assert tpk.resident_weight_bytes(tt) == jpk.resident_weight_bytes(jt)
    dense = {"w": uniform(rng, (1024, 1024))}
    full = tpk.resident_weight_bytes(to_port(dense))["binary"]
    packed = tpk.resident_weight_bytes(
        tpk.freeze_params(to_port(dense)))["binary"]
    assert full == 32 * packed


def test_with_threshold_and_convert_roundtrip():
    """A frozen JAX weight with a fold crosses to the port intact."""
    rng = np.random.default_rng(6)
    w = uniform(rng, (50, 20))
    b = uniform(rng, (20,))
    jw = jpk.freeze_params({"w": jnp.asarray(w)})["w"]
    jw = jw.with_threshold(*jpk.fold_bias_sign_threshold(jnp.asarray(b)),
                           "bias")
    tw = to_port(jax_to_np({"w": jw}))["w"]
    assert isinstance(tw, tpk.PackedWeight) and tw.fold == "bias"
    np.testing.assert_array_equal(words(tw.packed), np.asarray(jw.packed))
    np.testing.assert_array_equal(tw.thresh.numpy(), np.asarray(jw.thresh))
    assert tw.nbytes == jw.nbytes and tw.shape == jw.shape
    with pytest.raises(ValueError):
        tw.with_threshold(tw.thresh[:3], tw.flip[:3], "bias")
