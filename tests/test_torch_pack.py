"""The port's sign-pack (kernels/pack.py, kernel 5's plain version) against
the JAX package's `core.bitpack.pack_bits` and its Pallas `pack_bits_kernel`
(interpret mode), and the binary GEMMs' bf16 lhs; `pack_rows_into` (the new
K/V rows packed straight into their cache rows) against the JAX pack
followed by `.at[rows].set(words, mode="drop")`, the JAX package's own
cache write. Words are compared as uint32: tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitpack import pack_bits as jax_pack_bits
from repro.kernels.pack import pack_bits_kernel as jax_pack_kernel
from repro_torch.core.bitpack import pack_bits
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels.pack import (
    launches, pack_bits_kernel, pack_bits_plain, pack_rows_into,
    pack_rows_into_plain,
)
from repro_torch.models import transformer as T

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


def _jax_rows_into(srcs, pools, rows):
    """The JAX package's cache write: pack_bits, then `.at[rows].set(words,
    mode="drop")` into the pool seen as (rows, words) (row -1, like any row
    outside the pool, drops)."""
    out = []
    for x, pool in zip(srcs, pools):
        words = jax_pack_bits(jnp.asarray(x)).reshape(x.shape[0], -1)
        flat = jnp.asarray(pool).reshape(-1, words.shape[1])
        idx = np.where(rows < 0, flat.shape[0], rows)
        out.append(np.asarray(flat.at[idx].set(words, mode="drop"))
                   .reshape(pool.shape))
    return out


def _random_words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _rows_case(rng, n, hkv, hd, pool_shape, rows, dtype):
    """K and V rows with -0.0 and NaN, random old cache words, and the
    port's copies of them (uint32 words as int32, sources as `dtype`)."""
    srcs = [_special(rng, (n, hkv, hd)) for _ in range(2)]
    pools = [_random_words(rng, pool_shape) for _ in range(2)]
    port_srcs = [torch.from_numpy(x).to(dtype) for x in srcs]
    port_pools = [torch.from_numpy(p.view(np.int32).copy()) for p in pools]
    return srcs, pools, port_srcs, port_pools, torch.tensor(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode", "chunk", "off_word"])
def test_pack_rows_into_matches_jax_drop(case, dtype):
    """Decode (4 rows into a (B, T, Hkv, hdw) panel, two inactive: -1);
    a chunk of 6 rows at positions 3.. with n_valid 4 (pads -1); rows of
    K = 37 (off a word, K % 8 != 0). Every word of both pools, the rows
    not written included, equals the JAX write."""
    rng = np.random.default_rng(["decode", "chunk", "off_word"].index(case)
                                + 10 * (dtype == torch.bfloat16))
    if case == "decode":
        n, hd, shape = 4, 40, (4, 8, 2, 2)
        rows = [0 * 8 + 3, -1, 2 * 8 + 7, -1]
    elif case == "chunk":
        n, hd, shape = 6, 64, (1, 12, 2, 2)
        rows = [3, 4, 5, 6, -1, -1]
    else:
        n, hd, shape = 3, 37, (5, 2, 2)
        rows = [4, 0, 2]
    srcs, pools, psrcs, ppools, prows = _rows_case(rng, n, 2, hd, shape,
                                                   rows, dtype)
    if dtype == torch.bfloat16:      # the JAX side packs the same values
        srcs = [x.to(torch.float32).numpy() for x in psrcs]
    want = _jax_rows_into(srcs, pools, np.asarray(rows))
    before = launches["pack_bits"]
    pack_rows_into(psrcs, ppools, prows)                 # CPU: plain
    assert launches["pack_bits"] == before
    for got, ref in zip(ppools, want, strict=True):
        np.testing.assert_array_equal(words(got), ref)


def test_pack_rows_into_paged_with_sink():
    """Paged decode as the transformer writes it: the pools seen with their
    sink page, an active row at (page 2, row 1), inactive rows at the sink
    page; the pool (sink excluded) equals the JAX write of the active rows,
    and the sink took a write."""
    rng = np.random.default_rng(3)
    p, ps, hkv, hd = 5, 4, 2, 64
    srcs = [_special(rng, (3, hkv, hd)) for _ in range(2)]
    pools = [T.new_pool(1, p, ps, hkv, 2, device="cpu")[0] for _ in range(2)]
    for pool in pools:
        pool.random_(-2**31, 2**31 - 1)
    old = [words(pool) for pool in pools]
    rows = np.array([2 * ps + 1, p * ps + 0, p * ps + 0])
    pack_rows_into([torch.from_numpy(x) for x in srcs],
                   [T._with_sink(pool) for pool in pools],
                   torch.from_numpy(rows))
    want = _jax_rows_into(srcs, old, np.where(rows >= p * ps, -1, rows))
    for pool, ref in zip(pools, want, strict=True):
        np.testing.assert_array_equal(words(pool), ref)
        assert T._with_sink(pool)[p].any()


def test_pack_rows_into_one_source_and_rejects():
    x = torch.from_numpy(_special(np.random.default_rng(4), (2, 1, 33)))
    pool = torch.zeros(3, 1, 2, dtype=torch.int32)
    pack_rows_into([x], [pool], torch.tensor([2, 0]))
    np.testing.assert_array_equal(pool[[2, 0], 0], pack_bits_plain(x[:, 0]))
    assert not pool[1].any()
    with pytest.raises(ValueError, match="int64"):
        pack_rows_into([x], [pool], torch.tensor([2, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous rows"):
        pack_rows_into([x], [torch.zeros(3, 1, 3, dtype=torch.int32)],
                       torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="agree"):
        pack_rows_into([x, x[:1]], [pool, pool], torch.tensor([0, 1]))
    with pytest.raises(TypeError):
        pack_rows_into([x.double()], [pool], torch.tensor([0, 1]))
    plain = torch.zeros_like(pool)
    pack_rows_into_plain([x], [plain], torch.tensor([2, 0]))
    assert torch.equal(plain, pool)
