"""The port's binary GEMMs against the JAX package's oracles
(`repro.kernels.ref`, pure jnp; never Pallas interpret-mode output).

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions (and the ops around them) to the JAX semantics.
Every result is integer dots or packed words: tolerance 0.

tests/test_torch_cuda.py holds the Hopper kernels themselves to these plain
versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import words
from repro.core.bitpack import pack_bits as j_pack_bits
from repro.kernels import ref as jref
from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.core.packed import ALWAYS_THRESH, PackedActivation, freeze_params
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# ragged shapes of tests/test_bit_resident.py plus one word-aligned case
SHAPES = [
    (8, 32, 64),       # word-aligned
    (9, 100, 48),      # K not a multiple of 32
    (17, 64, 10),      # N < one word: output pad bits exercised
    (3, 37, 33),       # both ragged
    (130, 257, 129),   # several 64x64 tiles, everything odd
]


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0                  # sign(0) := +1
    w = rng.normal(size=(k, n)).astype(np.float32)
    thresh = rng.integers(-k, k + 1, n).astype(np.int32)
    flip = rng.integers(0, 2, n).astype(np.int32)
    return x, w, thresh, flip


def _jax_operands(x, w):
    return j_pack_bits(jnp.asarray(x)), j_pack_bits(jnp.asarray(w.T))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_plain_matches_jax_ref(m, k, n):
    x, w, _, _ = _case(m + k + n, m, k, n)
    ja, jb = _jax_operands(x, w)
    want = np.asarray(jref.binary_matmul_packed_ref(ja, jb, k))
    a, b = pack_bits(_t(x)), pack_bits(_t(w.T))
    np.testing.assert_array_equal(bg.binary_gemm_packed(a, b, k).numpy(), want)
    np.testing.assert_array_equal(
        tref.binary_matmul_packed_ref(a, b, k).numpy(), want)
    # the dense oracle agrees: the integers are the +-1 dot products
    np.testing.assert_array_equal(
        np.asarray(jref.binary_matmul_ref(jnp.asarray(x), jnp.asarray(w))),
        tref.binary_matmul_ref(_t(x), _t(w)).numpy())
    np.testing.assert_array_equal(want, tref.binary_matmul_ref(_t(x), _t(w)))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_rhs_plain_matches_jax_ref(m, k, n):
    x, w, _, _ = _case(2 * m + k + n, m, k, n)
    ja, jb = _jax_operands(x, w)
    want = np.asarray(jref.binary_matmul_packed_ref(ja, jb, k))
    got = bg.binary_gemm_packed_rhs(_t(x), pack_bits(_t(w.T)), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed_lhs", [True, False])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fused_plain_matches_jax_ref(m, k, n, packed_lhs):
    x, w, thresh, flip = _case(m * 7 + k + n, m, k, n)
    ja, jb = _jax_operands(x, w)
    want = np.asarray(jref.binary_matmul_fused_ref(
        ja, jb, jnp.asarray(thresh), jnp.asarray(flip), k))
    lhs = pack_bits(_t(x)) if packed_lhs else _t(x)
    got = bg.binary_gemm_fused(lhs, pack_bits(_t(w.T)), _t(thresh), _t(flip), k)
    assert got.shape == (m, packed_width(n))
    np.testing.assert_array_equal(words(got), want)
    np.testing.assert_array_equal(
        words(tref.binary_matmul_fused_ref(pack_bits(_t(x)), pack_bits(_t(w.T)),
                                           _t(thresh), _t(flip), k)), want)


def test_fused_output_pad_bits_are_plus_one():
    """Pad bits of the emitted word are 1 (+1), the wire format's pad that
    the next layer's weight pad bits cancel against."""
    x, w, thresh, flip = _case(5, 6, 40, 10)
    out = words(bg.binary_gemm_fused(pack_bits(_t(x)), pack_bits(_t(w.T)),
                                     _t(thresh), _t(flip), 40))
    assert ((out >> 10) == (1 << 22) - 1).all()


def test_plain_versions_chunk_rows(monkeypatch):
    """Row chunking of the plain versions changes nothing."""
    x, w, thresh, flip = _case(9, 130, 257, 129)
    b = pack_bits(_t(w.T))
    whole = bg.binary_gemm_fused(_t(x), b, _t(thresh), _t(flip), 257)
    dots = bg.binary_gemm_packed_rhs(_t(x), b, 257)
    monkeypatch.setattr(bg, "_PLAIN_CHUNK", 129 * 9 * 7)    # 7-row chunks
    np.testing.assert_array_equal(
        bg.binary_gemm_fused(_t(x), b, _t(thresh), _t(flip), 257), whole)
    np.testing.assert_array_equal(bg.binary_gemm_packed_rhs(_t(x), b, 257), dots)


def test_dispatch_and_ops_on_cpu_launch_nothing():
    x, w, thresh, flip = _case(3, 9, 100, 48)
    bg.reset_launches()
    pw = freeze_params({"w": _t(w)})["w"].with_threshold(_t(thresh), _t(flip),
                                                         "test")
    hb = ops.packed_matmul_fused(_t(x), pw)
    assert isinstance(hb, PackedActivation) and hb.k == 48
    ref_hb = ops.packed_matmul_fused(_t(x), pw, path="ref")
    np.testing.assert_array_equal(hb.packed, ref_hb.packed)
    d1 = ops.packed_matmul(_t(x), pw)
    d2 = ops.packed_matmul(PackedActivation.pack(_t(x)), pw)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(d1, ops.packed_matmul(_t(x), pw, path="ref"))
    assert all(v == 0 for v in bg.launches.values())


def test_wrappers_reject_bad_operands():
    x, w, thresh, flip = _case(4, 9, 100, 48)
    b = pack_bits(_t(w.T))
    with pytest.raises(ValueError):
        bg.binary_gemm_packed_rhs(_t(x).double(), b, 100)     # not float32
    with pytest.raises(ValueError):
        bg.binary_gemm_packed(pack_bits(_t(x))[:, :2], b, 100)  # KW mismatch
    with pytest.raises(ValueError):
        bg.binary_gemm_packed_rhs(_t(x).T.contiguous().T, b, 100)  # strided
    with pytest.raises(ValueError):
        bg.binary_gemm_fused(_t(x), b, _t(thresh)[:5], _t(flip), 100)
    with pytest.raises(TypeError):
        bg.binary_gemm_packed_rhs(_t(x), b.to(torch.int64), 100)


@pytest.mark.parametrize("b,h,wd,cin,cout,kh,kw", [
    (2, 5, 6, 3, 7, 3, 3), (1, 4, 4, 33, 5, 3, 3),
    (2, 5, 4, 3, 6, 2, 2),          # even kernel: SAME pads one more at the end
    (1, 6, 5, 4, 3, 1, 3)])
def test_packed_conv2d_matches_jax_conv_ref(b, h, wd, cin, cout, kh, kw):
    rng = np.random.default_rng(b * h + cin)
    x = rng.normal(size=(b, h, wd, cin)).astype(np.float32)
    w = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
    want = np.asarray(jref.binary_conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(tref.binary_conv2d_ref(_t(x), _t(w)).numpy(),
                                  want)
    pw = freeze_params({"w": _t(w)})["w"]
    for path in ("auto", "ref"):
        np.testing.assert_array_equal(
            ops.packed_conv2d(_t(x), pw, path=path).numpy(), want)
    np.testing.assert_array_equal(ops.binary_conv2d(_t(x), _t(w)).numpy(), want)


def test_always_thresh_matches_jax():
    from repro.core.packed import ALWAYS_THRESH as J_ALWAYS
    assert ALWAYS_THRESH == J_ALWAYS
