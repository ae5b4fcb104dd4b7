"""The port's sign-pack (kernels/pack.py, kernel A's plain version) against
the JAX package's `core.bitpack.pack_bits` and its Pallas `pack_bits_kernel`
(interpret mode), and the binary GEMMs' bf16 lhs. Words are compared as
uint32: tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitpack import pack_bits as jax_pack_bits
from repro.kernels.pack import pack_bits_kernel as jax_pack_kernel
from repro_torch.core.bitpack import pack_bits
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels.pack import launches, pack_bits_kernel, pack_bits_plain

from _torch_parity import words


def _special(rng, shape):
    """Normal values with exact zeros, -0.0 and NaN sprinkled in."""
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    flat[5::13] = np.nan
    return x


@pytest.mark.parametrize("shape", [(1, 1), (3, 31), (4, 32), (5, 33),
                                   (2, 3, 100), (7, 5120 // 64)])
def test_pack_plain_matches_jax(shape):
    x = _special(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jax_pack_bits(jnp.asarray(x)))
    got = pack_bits_kernel(torch.from_numpy(x))       # CPU tensor: plain
    np.testing.assert_array_equal(words(got), want)
    np.testing.assert_array_equal(words(pack_bits_plain(torch.from_numpy(x))),
                                  want)


def test_pack_signed_zero_nan_and_pad_bits():
    x = torch.tensor([[0.0, -0.0, float("nan"), -1.0, 2.0]])
    w = int(words(pack_bits_kernel(x))[0, 0])
    # bits: +0 -> 1, -0 -> 1, NaN -> 0, -1 -> 0, 2 -> 1, pad bits 5..31 -> 1
    assert w == (0b10011 | (0xFFFFFFFF << 5 & 0xFFFFFFFF))


def test_pack_plain_matches_jax_pallas_kernel():
    x = _special(np.random.default_rng(1), (9, 70))
    want = np.asarray(jax_pack_kernel(jnp.asarray(x), bm=8, bkw=2))
    np.testing.assert_array_equal(words(pack_bits_kernel(torch.from_numpy(x))),
                                  want)


def test_pack_bf16_equals_float32():
    x = _special(np.random.default_rng(2), (6, 77))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        words(pack_bits_kernel(xt.to(torch.bfloat16))),
        words(pack_bits_kernel(xt)))


def test_pack_counts_no_launch_on_cpu():
    before = launches["pack_bits"]
    pack_bits_kernel(torch.ones(4, 40))
    assert launches["pack_bits"] == before


def test_pack_rejects_other_dtypes():
    with pytest.raises(TypeError):
        pack_bits_kernel(torch.ones(2, 3, dtype=torch.float64))


@pytest.mark.parametrize("m,k,n", [(5, 37, 9), (8, 64, 33)])
def test_gemm_bf16_lhs_equals_float32(m, k, n):
    """The wo / w_down lhs is bf16 on the LM's path: its words, dots and
    fused words equal the float32 lhs's (the sign of a bf16 value is the
    sign of the float32 it rounds from, -0.0 included)."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy(_special(rng, (m, k))).nan_to_num(nan=-3.0)
    x.view(-1)[1::9] = -0.0
    xb = x.to(torch.bfloat16)
    b = pack_bits(torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)))
    thresh = torch.from_numpy(rng.integers(-k, k + 1, n).astype(np.int32))
    flip = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    np.testing.assert_array_equal(words(pack_bits(xb)), words(pack_bits(x)))
    np.testing.assert_array_equal(bg.binary_gemm_packed_rhs(xb, b, k),
                                  bg.binary_gemm_packed_rhs(x, b, k))
    np.testing.assert_array_equal(
        words(bg.binary_gemm_fused(xb, b, thresh, flip, k)),
        words(bg.binary_gemm_fused(x, b, thresh, flip, k)))
