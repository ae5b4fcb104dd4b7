"""The port's tensor-parallel kernel wrappers (`repro_torch.kernels.sharded`)
against its unsharded dispatchers and the JAX package's oracles
(`repro.kernels.ref`), at `tests/test_sharded_kernels.py`'s shapes and
splits, on a (1, parts) mesh of repeated CPU devices: GEMM dots and words
bit for bit against both; attention outputs and their integer dots bit for
bit against the unsharded wrapper, and outputs within ATOL / RTOL of the
JAX oracle (`tests/test_torch_attention.py`'s: the port's plain attention
and JAX's sum their floats in other orders).

Inputs are numpy draws from a seed; the JAX side packs them and runs its
oracles jitted once per shape (eager, each op would compile on its own).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.bitpack import pack_bits
from repro.kernels import ref
from repro_torch.convert import tensor, words_to_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels import sharded as S
from repro_torch.kernels.binary_gemm import (dispatch_binary_gemm,
                                             dispatch_binary_gemm_fused)
from repro_torch.launch.mesh import make_serving_mesh

ATOL = RTOL = 1e-5
_pack = jax.jit(pack_bits)


def _mesh(parts):
    return make_serving_mesh(1, parts, devices=["cpu"] * parts)


def _t(x):
    """A numpy or JAX array as a port tensor (uint32 words as int32 bits)."""
    return tensor(np.asarray(x), "cpu")


def _words(rng, shape):
    """Sign words of a normal draw, as JAX packs them."""
    return np.asarray(_pack(rng.normal(size=shape).astype(np.float32)))


def _gemm_operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return rng, x, np.asarray(_pack(x)), np.asarray(_pack(w.T)), k


@pytest.mark.parametrize("m,k,n,parts", [(4, 96, 128, 2), (7, 130, 256, 4)])
@pytest.mark.parametrize("packed_lhs", [False, True])
def test_binary_gemm_tp_bit_exact(m, k, n, parts, packed_lhs):
    _, x, a_p, b_p, kk = _gemm_operands(m + k + n, m, k, n)
    lhs = a_p if packed_lhs else x
    want = np.asarray(jax.jit(ref.binary_matmul_packed_ref,
                              static_argnums=2)(a_p, b_p, kk))
    got = S.binary_gemm_tp(_t(lhs), _t(b_p), kk, mesh=_mesh(parts))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), dispatch_binary_gemm(_t(lhs), _t(b_p), kk).numpy())


@pytest.mark.parametrize("m,k,n,parts", [(4, 96, 128, 2), (5, 64, 256, 4)])
@pytest.mark.parametrize("packed_lhs", [False, True])
def test_binary_gemm_fused_tp_bit_exact(m, k, n, parts, packed_lhs):
    rng, x, a_p, b_p, kk = _gemm_operands(m * 7 + k + n, m, k, n)
    th = rng.integers(-5, 5, n).astype(np.int32)
    fl = rng.integers(0, 2, n).astype(np.int32)
    lhs = a_p if packed_lhs else x
    want = np.asarray(jax.jit(ref.binary_matmul_fused_ref,
                              static_argnums=4)(a_p, b_p, th, fl, kk))
    args = (_t(lhs), _t(b_p), _t(th), _t(fl), kk)
    got = S.binary_gemm_fused_tp(*args, mesh=_mesh(parts))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    np.testing.assert_array_equal(
        got.numpy(), dispatch_binary_gemm_fused(*args).numpy())


def test_fused_tp_rejects_unaligned_n_shard():
    """N=48 over 2 shards is 24 columns each, not a whole output word."""
    _, x, _, b_p, kk = _gemm_operands(0, 4, 64, 48)
    zeros = torch.zeros(48, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        S.binary_gemm_fused_tp(_t(x), _t(b_p), zeros, zeros, kk,
                               mesh=_mesh(2))


def _attention(oracle, kernel, tp, args, rest, parts, **kw):
    """The wrapper on `parts` shards against the unsharded wrapper (outputs
    and dots bit for bit) and the jitted JAX oracle (outputs within the
    tolerance)."""
    port = [_t(a) for a in (*args, *rest)]
    got, dots = tp(*port, mesh=_mesh(parts), return_dots=True, **kw)
    want, want_dots = kernel(*port, return_dots=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(dots.numpy(), want_dots.numpy())
    jax_out = jax.jit(lambda *a: oracle(*a, **kw))(*args, *rest)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=ATOL,
                               rtol=RTOL)


def _v(rng, b, hkv):
    return rng.uniform(0.1, 1.0, (b, hkv)).astype(np.float32)


@pytest.mark.parametrize("b,t,hq,hkv,hd,window,parts", [
    (3, 24, 8, 4, 32, 0, 2),     # GQA 2:1
    (2, 17, 4, 4, 20, 5, 4),     # MHA, odd hd, sliding window
])
def test_decode_attention_tp_bit_exact(b, t, hq, hkv, hd, window, parts):
    rng = np.random.default_rng(b * 31 + t)
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    kp, vp = _words(rng, (b, t, hkv, hd)), _words(rng, (b, t, hkv, hd))
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    _attention(ref.decode_attention_packed_ref, DA.decode_attention_packed,
               S.decode_attention_packed_tp, (q, kp, vp, _v(rng, b, hkv)),
               (lens,), parts, window=window)


def test_decode_attention_paged_tp_bit_exact():
    b, np_, ps, pool, hkv, g, hd = 3, 4, 8, 16, 2, 3, 32
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, 1, hkv * g, hd)).astype(np.float32)
    kp = _words(rng, (pool, ps, hkv, hd))
    vp = _words(rng, (pool, ps, hkv, hd))
    # distinct pages per row, some sentinel (== pool) tail entries
    pt = np.full((b, np_), pool, np.int32)
    perm = rng.permutation(pool)[:b * np_]
    for i in range(b):
        pt[i, :3] = perm[i * 3:i * 3 + 3]
    lens = rng.integers(1, 3 * ps + 1, b).astype(np.int32)
    _attention(ref.decode_attention_packed_paged_ref,
               DA.decode_attention_packed_paged,
               S.decode_attention_packed_paged_tp,
               (q, kp, vp, _v(rng, b, hkv)), (pt, lens), 2)


@pytest.mark.parametrize("parts", [2, 4])
def test_prefill_attention_tp_bit_exact(parts):
    b, s, t, hkv, g, hd = 2, 6, 32, 4, 2, 24
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, s, hkv * g, hd)).astype(np.float32)
    kp, vp = _words(rng, (b, t, hkv, hd)), _words(rng, (b, t, hkv, hd))
    pos = rng.integers(0, t - s, b).astype(np.int32)
    _attention(ref.prefill_attention_packed_ref, PA.prefill_attention_packed,
               S.prefill_attention_packed_tp, (q, kp, vp, _v(rng, b, hkv)),
               (pos + s, pos), parts)


def test_prefill_attention_paged_tp_bit_exact():
    b, s, np_, ps, pool, hkv, g, hd = 2, 4, 3, 8, 8, 2, 2, 16
    rng = np.random.default_rng(9)
    q = rng.normal(size=(b, s, hkv * g, hd)).astype(np.float32)
    kp = _words(rng, (pool, ps, hkv, hd))
    vp = _words(rng, (pool, ps, hkv, hd))
    pt = np.stack([np.arange(np_), np_ + np.arange(np_)]).astype(np.int32)
    pos = np.asarray([3, 9], np.int32)
    _attention(ref.prefill_attention_packed_paged_ref,
               PA.prefill_attention_packed_paged,
               S.prefill_attention_packed_paged_tp,
               (q, kp, vp, _v(rng, b, hkv)), (pt, pos + s, pos), 2)


def test_shard_geometry_validation():
    g = S.shard_geometry(128, 4, name="n", multiple=32)
    assert g.local == 32
    with pytest.raises(ValueError, match="divide"):
        S.shard_geometry(10, 4, name="hkv")
    with pytest.raises(ValueError, match="divide"):   # phi3's Hkv 10
        S.decode_attention_packed_tp(
            torch.zeros(1, 1, 40, 128), *[torch.zeros(
                1, 8, 10, 4, dtype=torch.int32)] * 2,
            torch.ones(1, 10), 1, mesh=_mesh(4))
    with pytest.raises(ValueError, match="axis"):
        S.shard_devices(_mesh(2), "tensor")
