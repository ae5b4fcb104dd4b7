"""The port's attention over a bit-resident KV cache (kernels/ref.py, the
plain versions of kernels B and C) against the JAX package's oracles
`repro.kernels.ref.{decode,prefill}_attention_packed_ref`.

Integer score dots are compared exactly. Outputs are compared in float32
with atol 1e-5 and rtol 1e-5: XLA's CPU exp differs from torch's by one ulp
in about a tenth of the values, and the JAX oracle sums the softmax and V in
float32 where the port sums them exactly (float64), so outputs differ by a
few ulps times the number of cache positions (at most 100 here) times
v_scale (at most 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitpack import pack_bits as jax_pack_bits, packed_dot
from repro.kernels import ref as jref
from repro_torch.convert import tensor
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, v_cache_scale,
)
from repro_torch.kernels.prefill_attention import prefill_attention_packed

ATOL = RTOL = 1e-5


def _cache(rng, b, t, hkv, hd):
    """Random packed K/V words (pad bits 1, as a pack leaves them) and V
    scales in (0.5, 1)."""
    kw = -(-hd // 32)

    def words_of():
        return np.asarray(jax_pack_bits(jnp.asarray(
            rng.normal(size=(b, t, hkv, hd)).astype(np.float32))))
    assert words_of().shape[-1] == kw
    return words_of(), words_of(), rng.uniform(0.5, 1.0, (b, hkv)).astype(np.float32)


def _query(rng, shape):
    """Integer-valued float queries with zeros (sign(0) := +1), like the
    rope'd popcount dots the model feeds in."""
    return rng.integers(-4, 5, shape).astype(np.float32)


def _port(q, k, v, vs):
    return (torch.from_numpy(q), tensor(k, "cpu"), tensor(v, "cpu"),
            torch.from_numpy(vs))


def _jax_dots(q, k):
    """The JAX oracles' integer dots, (B, Hkv, S, G, T)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qb = jax_pack_bits(jnp.asarray(q).reshape(b, s, hkv, hq // hkv, hd)
                       .transpose(0, 2, 1, 3, 4))
    kb = jnp.asarray(k).transpose(0, 2, 1, 3)
    return np.asarray(packed_dot(qb[:, :, :, :, None, :],
                                 kb[:, :, None, None, :, :], hd))


DECODE = [  # (B, T, Hkv, G, hd, window)
    (3, 37, 2, 2, 16, 0), (2, 64, 1, 4, 20, 5), (4, 40, 3, 1, 40, 0),
    (1, 33, 2, 8, 33, 7), (2, 100, 2, 2, 128, 0)]


@pytest.mark.parametrize("b,t,hkv,g,hd,window", DECODE)
def test_decode_plain_matches_jax(b, t, hkv, g, hd, window):
    rng = np.random.default_rng(t * hd + g)
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, 1, hkv * g, hd))
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[0] = 1                                  # one visible position
    want = np.asarray(jref.decode_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(lens), window=window))
    got, dots = decode_attention_packed(*_port(q, k, v, vs),
                                        torch.from_numpy(lens),
                                        window=window, return_dots=True)
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, k)[:, :, 0])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


PREFILL = [  # (B, S, T, Hkv, G, hd, window, causal)
    (1, 8, 32, 2, 2, 16, 0, True), (2, 5, 37, 1, 4, 20, 4, True),
    (3, 4, 40, 2, 1, 33, 0, False), (1, 16, 64, 2, 8, 64, 9, True)]


@pytest.mark.parametrize("b,s,t,hkv,g,hd,window,causal", PREFILL)
def test_prefill_plain_matches_jax(b, s, t, hkv, g, hd, window, causal):
    rng = np.random.default_rng(s * t + hd)
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, s, hkv * g, hd))
    q_pos = rng.integers(0, t - s + 1, b).astype(np.int32)
    kv_len = q_pos + s
    want = np.asarray(jref.prefill_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(kv_len), jnp.asarray(q_pos), window=window,
        causal=causal))
    got, dots = prefill_attention_packed(
        *_port(q, k, v, vs), torch.from_numpy(kv_len),
        torch.from_numpy(q_pos), window=window, causal=causal,
        return_dots=True)
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, k))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 3])
def test_prefill_one_row_equals_decode(window):
    """S = 1 at q_pos = kv_len - 1 is a decode step: equal, bit for bit."""
    rng = np.random.default_rng(7)
    b, t, hkv, g, hd = 3, 45, 2, 4, 24
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, 1, hkv * g, hd))
    lens = torch.tensor([1, 20, 45], dtype=torch.int32)
    args = _port(q, k, v, vs)
    dec = decode_attention_packed(*args, lens, window=window)
    pre = prefill_attention_packed(*args, lens, lens - 1, window=window)
    np.testing.assert_array_equal(dec.numpy(), pre.numpy())


def test_scalar_lengths_equal_row_lengths():
    rng = np.random.default_rng(8)
    k, v, vs = _cache(rng, 2, 30, 2, 16)
    q = _query(rng, (2, 6, 4, 16))
    args = _port(q, k, v, vs)
    a = prefill_attention_packed(*args, 17, 11)
    b = prefill_attention_packed(*args, torch.tensor([17, 17]),
                                 torch.tensor([11, 11]))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_zero_length_row_outputs_zero():
    """cache_len 0 (the scheduler's inactive rows): the row attends to
    nothing and outputs exactly 0, never NaN; other rows are unaffected."""
    rng = np.random.default_rng(9)
    k, v, vs = _cache(rng, 3, 20, 2, 16)
    q = _query(rng, (3, 1, 4, 16))
    args = _port(q, k, v, vs)
    out = decode_attention_packed(*args, torch.tensor([0, 5, 0],
                                                      dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert (out[[0, 2]] == 0).all()
    alone = decode_attention_packed(*(a[1:2] for a in args), 5)
    np.testing.assert_array_equal(out[1:2].numpy(), alone.numpy())


def test_exact_cancellation_outputs_zero():
    """Positions 0..3 hold dots (a, b, a, b) and V signs (+, +, -, -): the
    weighted V sum cancels exactly, and the plain version, which sums in
    float64, outputs exactly 0 (a +1 bit downstream) in any order, where a
    float32 sum in ascending order keeps a rounding residue."""
    hd = 32
    kbits = np.array([[1] * 32, [1] * 16 + [0] * 16,
                      [1] * 32, [1] * 16 + [0] * 16], np.float32) * 2 - 1
    k = torch.from_numpy(kbits).reshape(1, 4, 1, hd)
    vsign = np.array([1, 1, -1, -1], np.float32)[:, None] * np.ones(hd)
    v = torch.from_numpy(vsign.astype(np.float32)).reshape(1, 4, 1, hd)
    from repro_torch.core.bitpack import pack_bits
    q = torch.ones(1, 1, 1, hd)
    out = decode_attention_packed(q, pack_bits(k), pack_bits(v),
                                  torch.ones(1, 1), 4)
    assert (out == 0).all() and not torch.signbit(out).any()
    s = torch.tensor([32.0, 0.0]) * torch.tensor(1 / hd ** 0.5)
    e = torch.exp(s - s.max())
    assert ((e[0] + e[1]) - e[0]) - e[1] != 0      # the float32 residue


def test_v_cache_scale_matches_jax():
    from repro.kernels.decode_attention import v_cache_scale as jax_vcs
    x = np.random.default_rng(10).normal(size=(2, 7, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(v_cache_scale(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_vcs(jnp.asarray(x))),
                               rtol=1e-6)


def test_chunk_valid_mask_matches_jax():
    for causal in (True, False):
        for window in (0, 4):
            a = np.asarray(jref.chunk_valid_mask(
                3, 5, 20, jnp.asarray([5, 9, 20]), jnp.asarray([0, 4, 15]),
                window, causal))
            b = ref.chunk_valid_mask(3, 5, 20, torch.tensor([5, 9, 20]),
                                     torch.tensor([0, 4, 15]), window, causal)
            np.testing.assert_array_equal(a, b.numpy())


def test_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(11)
    k, v, vs = _cache(rng, 2, 8, 2, 16)
    q, kt, vt, vst = _port(_query(rng, (2, 1, 4, 16)), k, v, vs)
    with pytest.raises(ValueError):
        decode_attention_packed(q, kt, vt[:, :4], vst, 3)
    with pytest.raises(ValueError):
        decode_attention_packed(q, kt, vt, vst.double(), 3)
    with pytest.raises(TypeError):
        decode_attention_packed(q.double(), kt, vt, vst, 3)
    with pytest.raises(ValueError):
        decode_attention_packed(q[:, :, :3], kt, vt, vst, 3)
