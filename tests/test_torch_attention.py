"""The port's attention over a bit-resident KV cache (kernels/ref.py, the
plain versions of kernels 6 and 8) against the JAX package's oracles
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
from repro_torch.core.bitpack import unpack_bits
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_packed, v_cache_scale,
)
from repro_torch.kernels import prefill_attention as pa
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


# past T ~1,770, where a (32, T) score panel would not fit shared memory:
# narrow heads, a chunk at the end of a 2,048-position cache and one in its
# middle, with and without a window
LONG = [(1, 4, 2048, 1, 2, 16, 0), (2, 4, 2048, 1, 2, 16, 300)]


@pytest.mark.parametrize("b,s,t,hkv,g,hd,window", LONG)
def test_prefill_plain_past_the_old_cap_matches_jax(b, s, t, hkv, g, hd,
                                                    window):
    """The prefill wrapper takes any T (its kernel keeps no score panel);
    its plain version still equals the JAX oracle there."""
    rng = np.random.default_rng(t + hd + window)
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, s, hkv * g, hd))
    q_pos = np.full(b, t - s, np.int32)
    q_pos[-1] = t // 2
    kv_len = q_pos + s
    want = np.asarray(jref.prefill_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(kv_len), jnp.asarray(q_pos), window=window))
    got, dots = prefill_attention_packed(
        *_port(q, k, v, vs), torch.from_numpy(kv_len),
        torch.from_numpy(q_pos), window=window, return_dots=True)
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, k))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_decode_plain_past_the_old_cap_matches_jax():
    """The decode wrapper takes any T (one-row chunks of the panel-free
    body); its plain version equals the JAX oracle at T 16,384, past the
    old panel body's cap, rows of every length class and a window."""
    rng = np.random.default_rng(16384)
    b, t, hkv, g, hd = 3, 16384, 1, 4, 16
    k, v, vs = _cache(rng, b, t, hkv, hd)
    q = _query(rng, (b, 1, hkv * g, hd))
    lens = np.array([t, 9001, 1], np.int32)
    want = np.asarray(jref.decode_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(lens), window=700))
    got, dots = decode_attention_packed(*_port(q, k, v, vs),
                                        torch.from_numpy(lens), window=700,
                                        return_dots=True)
    np.testing.assert_array_equal(dots.numpy(), _jax_dots(q, k)[:, :, 0])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,s,t,hkv,g,hd,bq,split", [
    (1, 32, 512, 10, 4, 128, 8, 2),     # phi3 chunk, one slot: 40 blocks
    (4, 1, 512, 10, 4, 128, 1, 8),      # one-row chunks of 4 slots
    (1, 32, 4096, 10, 4, 128, 8, 4),    # no T cap
    (2, 32, 4096, 10, 4, 128, 8, 2),    # 80 blocks
    (4, 32, 512, 10, 4, 128, 8, 1),     # 160: a split would need 2 waves
    (4, 64, 2048, 10, 4, 128, 8, 1),
    (1, 32, 2048, 2, 4, 128, 8, 8),     # 8 blocks: the largest cluster
    (1, 32, 500, 2, 4, 128, 8, 1),      # 256 positions a block at least
    (1, 7, 45, 2, 1, 33, 7, 1),
    (1, 64, 512, 1, 32, 256, 1, 2),     # 32 heads, the widest head_dim
])
def test_attention_plan_rule(b, s, t, hkv, g, hd, bq, split):
    """The prefill launch rule on a 132-SM card: bq*G <= 32 query rows a
    block, T split in clusters of at most 8 blocks while the doubled grid
    fits one wave of 2 blocks per SM (3 for blocks of <= 8 rows), one
    launch, no limit on T."""
    plan = pa.attention_plan(b, s, t, hkv, g, hd, 132)
    assert (plan.bq, plan.split, plan.launches) == (bq, split, 1)
    assert plan.blocks == b * hkv * -(-s // bq) * split
    assert plan.bq * g <= 32 and plan.split in (1, 2, 4, 8)
    resident = 3 if plan.bq * g <= 8 else 2
    assert plan.split == 1 or plan.blocks <= resident * 132


@pytest.mark.parametrize("b,t,hkv,g,hd,split", [
    (4, 512, 10, 4, 128, 8),            # phi3 decode, 4 slots: 320 blocks
    (4, 4096, 10, 4, 128, 8),
    (4, 16384, 10, 4, 128, 8),          # no T cap
    (1, 512, 10, 4, 128, 8),
    (1, 4096, 10, 4, 128, 8),
    (4, 200, 10, 4, 128, 2),            # a tile a block at least
    (4, 100, 10, 4, 128, 1),
    (16, 4096, 10, 8, 128, 2),          # 320 blocks: 4 would need 2 waves
    (32, 2048, 10, 4, 128, 1),          # 320 blocks unsplit
])
def test_decode_plan_rule(b, t, hkv, g, hd, split):
    """The launch rule at S = 1 (a decode step) on a 132-SM card: one chunk
    row a block (G query rows, the narrow body), T split in clusters of at
    most 8 blocks while the doubled grid fits one wave of 3 narrow blocks
    per SM and each block keeps a 64-position tile, one launch."""
    plan = pa.attention_plan(b, 1, t, hkv, g, hd, 132)
    assert (plan.bq, plan.split, plan.launches) == (1, split, 1)
    assert plan.blocks == b * hkv * split
    assert plan.split == 1 or plan.blocks <= 3 * 132


def test_attention_plan_rejects_what_no_block_holds():
    for g, hd in ((33, 16), (4, 512)):
        with pytest.raises(ValueError, match="no prefill kernel"):
            pa.attention_plan(1, 8, 512, 1, g, hd, 132)


def test_block_positions_hold_every_valid_position():
    """A block's position range and its ranks' shares, as the kernel
    computes them: every position `ref.chunk_valid_mask` allows for the
    block's rows lies inside, the range is tight, and the shares tile it
    in order."""
    for t, s, kv_len, q_pos, window, causal in [
            (512, 32, 32, 0, 0, True), (512, 32, 128, 96, 0, True),
            (4096, 32, 4096, 4064, 0, True), (45, 7, 16, 9, 5, True),
            (70, 16, 56, 40, 0, False), (70, 16, 56, 40, 9, False),
            (40, 5, 0, 0, 0, True), (40, 5, 3, 0, 0, True),
            (64, 8, 100, 20, 4, True),
            # decode steps: one row at q_pos = kv_len - 1 (kv_len 0: -1)
            (512, 1, 512, 511, 0, True), (512, 1, 17, 16, 0, True),
            (4096, 1, 3000, 2999, 700, True), (40, 1, 5, 4, 9, True),
            (40, 1, 0, -1, 0, True), (40, 1, 0, -1, 3, True)]:
        valid = ref.chunk_valid_mask(1, s, t, kv_len, q_pos, window, causal)[0]
        bq = pa.block_rows(s, 4, 64)
        for i0 in range(0, s, bq):
            i1 = min(s, i0 + bq)
            lo, hi = pa.block_positions(kv_len, q_pos, i0, i1, t,
                                        window=window, causal=causal)
            seen = valid[i0:i1].any(dim=0).nonzero().flatten().tolist()
            assert all(lo <= x < hi for x in seen)
            if seen:
                assert (lo, hi) == (seen[0], seen[-1] + 1)
            else:
                assert lo == hi
            for split in (1, 2, 4, 8):
                shares = [pa.rank_positions(lo, hi, split, r)
                          for r in range(split)]
                assert shares[0][0] == lo and shares[-1][1] == hi
                assert all(a[1] == c[0] for a, c in zip(shares, shares[1:]))


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
    """cache_len 0 (the scheduler's inactive rows): no position is valid,
    and the row weighs every position of its T alike, as the JAX oracle's
    softmax over all-masked scores does: out = v_scale * mean_t sign(v_t),
    equal to the oracle's bits (the sums are exact integers), never NaN,
    never 0 unless the V signs cancel; other rows are unaffected. (A MoE's
    inactive rows take expert capacity, so these values count.)"""
    rng = np.random.default_rng(9)
    k, v, vs = _cache(rng, 3, 20, 2, 16)
    q = _query(rng, (3, 1, 4, 16))
    args = _port(q, k, v, vs)
    lens = np.array([0, 5, 0], np.int32)
    out = decode_attention_packed(*args, torch.from_numpy(lens))
    assert torch.isfinite(out).all()
    want = np.asarray(jref.decode_attention_packed_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vs),
        jnp.asarray(lens)))
    np.testing.assert_array_equal(out[[0, 2]].numpy(), want[[0, 2]])
    mean = unpack_bits(args[2], 16).mean(dim=1)       # (B, Hkv, hd) signs
    head = (torch.from_numpy(vs)[:, :, None] * mean)[0]   # (Hkv, hd)
    torch.testing.assert_close(out[0, 0].reshape(2, 2, 16),
                               head[:, None].expand(2, 2, 16))
    assert (out[[0, 2]] != 0).any()
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
