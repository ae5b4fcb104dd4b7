"""Parity of repro_torch.core.bitpack with repro.core.bitpack. Words and
integer dots must be bit-exact (tolerance 0): packing is a compare and
shifts, the dot integer arithmetic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import words
from repro.core import bitpack as jbp
from repro_torch.core import bitpack as tbp

KS = [1, 31, 32, 33, 70, 100, 257]


def _signs_with_edges(rng, shape):
    """Normal draws with exact zeros and negative zeros mixed in: sign(0)
    and sign(-0.0) are both +1 (bit 1)."""
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    return x


@pytest.mark.parametrize("k", KS)
def test_pack_matches_jax(k):
    rng = np.random.default_rng(k)
    x = _signs_with_edges(rng, (5, 3, k))
    want = np.asarray(jbp.pack_bits(jnp.asarray(x)))
    got = tbp.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(words(got), want)


@pytest.mark.parametrize("k", KS)
def test_unpack_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    p = rng.integers(0, 2**32, (4, tbp.packed_width(k)), dtype=np.uint32)
    want = np.asarray(jbp.unpack_bits(jnp.asarray(p), k))
    got = tbp.unpack_bits(torch.from_numpy(p.view(np.int32)), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", KS)
def test_packed_dot_matches_jax(k):
    rng = np.random.default_rng(200 + k)
    a = _signs_with_edges(rng, (6, k))
    b = _signs_with_edges(rng, (6, k))
    ja, jb = jbp.pack_bits(jnp.asarray(a)), jbp.pack_bits(jnp.asarray(b))
    want = np.asarray(jbp.packed_dot(ja, jb, k))
    got = tbp.packed_dot(tbp.pack_bits(torch.from_numpy(a)),
                         tbp.pack_bits(torch.from_numpy(b)), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the dot is the +-1 dot product it stands for
    sa, sb = np.where(a >= 0, 1, -1), np.where(b >= 0, 1, -1)
    np.testing.assert_array_equal(got.numpy(), (sa * sb).sum(-1))


@pytest.mark.parametrize("k", [1, 10, 33, 63])
def test_pad_bits_are_one(k):
    x = -np.ones((3, k), np.float32)          # every real bit 0
    got = words(tbp.pack_bits(torch.from_numpy(x)))
    kw = tbp.packed_width(k)
    pad = kw * 32 - k
    assert got.shape == (3, kw)
    last = got[:, -1].astype(np.uint64)
    want_last = ((1 << pad) - 1) << (32 - pad) if pad else 0
    np.testing.assert_array_equal(last, np.full(3, want_last, np.uint64))


def test_nan_packs_to_zero_bit_as_jax():
    x = np.array([[np.nan, 1.0, -1.0, np.nan]], np.float32)
    np.testing.assert_array_equal(
        words(tbp.pack_bits(torch.from_numpy(x))),
        np.asarray(jbp.pack_bits(jnp.asarray(x))))


def test_int32_uint32_view_roundtrip():
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2**32, (9, 5), dtype=np.uint32)
    u[0, 0], u[0, 1] = 2**31, 2**32 - 1       # the sign bit and all bits
    t = torch.from_numpy(u.view(np.int32))
    np.testing.assert_array_equal(words(t), u)
    np.testing.assert_array_equal(t.numpy().view(np.uint32).view(np.int32),
                                  t.numpy())


def test_popcount_matches_numpy():
    rng = np.random.default_rng(8)
    u = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    u[:3] = [0, 2**32 - 1, 2**31]
    want = np.unpackbits(u.view(np.uint8)).reshape(-1, 32).sum(-1)
    got = tbp.popcount(torch.from_numpy(u.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5,), (3, 33), (2, 4, 64), (7, 0, 31)])
def test_packed_nbytes_matches_jax(shape):
    assert tbp.packed_nbytes(shape) == jbp.packed_nbytes(shape)
    assert tbp.packed_width(shape[-1]) == jbp.packed_width(shape[-1])
