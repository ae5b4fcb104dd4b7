"""The port's float attention (`repro_torch.models.attention`: the flash
forward, the naive oracle, the masked chunk core, chunk and decode
attention against a float cache and their paged twins) against the JAX
package's functions of the same names, on the same numpy-seeded inputs.

Tolerances, of each output's largest magnitude: float32 1e-5 (the same
operations, summed in another order: matmul blocking, and the online
softmax's rescaling); bf16 2^-7 (one bf16 rounding of the output, and of q
and p where the JAX package rounds them too). The cases cover causal and
not, a window, q_offset, GQA, T not a multiple of the flash chunk, and
paged pools in shuffled order with sentinel tails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as A

from _torch_parity import assert_rel

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the JAX side jitted once per module (its eager op-by-op dispatch compiles
# every small op on its own, several times slower here)
_jflash = jax.jit(JA.flash_attention, static_argnums=(3, 4, 5, 6))
_jref = jax.jit(JA.attention_ref,
                static_argnames=("causal", "window", "q_offset"))
_jmasked = jax.jit(JA.masked_chunk_attention)
_jchunk = jax.jit(JA.chunk_attention, static_argnames=("window", "causal"))
_jchunk_paged = jax.jit(JA.chunk_attention_paged,
                        static_argnames=("window", "causal"))
_jdecode = jax.jit(JA.decode_attention, static_argnames=("window",))
_jdecode_paged = jax.jit(JA.decode_attention_paged,
                         static_argnames=("window",))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    """A numpy array as (the JAX array, the port's tensor) of `dtype`, the
    same values in both (bf16 rounds to nearest even on both sides)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _qkv(rng, b, s, t, hq, hkv, d, dtype):
    return [_pair(rng.normal(size=shape).astype(np.float32), dtype)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


def _check(got, want, dtype, what):
    assert got.dtype == DTYPES[dtype][1], what
    assert_rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
               rel=TOL[dtype], what=what)


# (B, S, T, Hq, Hkv, d, causal, window, chunk, q_offset)
FLASH_CASES = [
    (2, 12, 12, 4, 2, 16, True, 0, 5, 0),     # T % chunk != 0, GQA 2
    (1, 7, 7, 2, 2, 8, False, 0, 4, 0),       # not causal
    (2, 9, 9, 6, 3, 16, True, 4, 4, 0),       # window shorter than T
    (1, 5, 13, 4, 1, 16, True, 0, 4, 8),      # q_offset: the prompt's tail
    (1, 16, 16, 4, 2, 32, True, 0, 16, 0),    # one chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_and_ref_match_jax(case, dtype):
    b, s, t, hq, hkv, d, causal, window, chunk, q_off = case
    rng = np.random.default_rng(sum(case[:6]) + window)
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, s, t, hq, hkv, d, dtype)
    want = _jflash(jq, jk, jv, causal, window, chunk, q_off)
    got = A.flash_attention(q, k, v, causal, window, chunk, q_off)
    _check(got, want, dtype, f"flash {case}")
    want = _jref(jq, jk, jv, causal=causal, window=window, q_offset=q_off)
    got = A.attention_ref(q, k, v, causal=causal, window=window,
                          q_offset=q_off)
    _check(got, want, dtype, f"attention_ref {case}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_chunk_attention_matches_jax(dtype):
    """An arbitrary (B, S, T) mask, one query row fully masked (uniform
    softmax on both sides)."""
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 2, 5, 11, 4, 2, 16, dtype)
    valid = rng.random((2, 5, 11)) < 0.6
    valid[1, 3] = False
    want = _jmasked(jq, jk, jv, jnp.asarray(valid))
    got = A.masked_chunk_attention(q, k, v, torch.from_numpy(valid))
    _check(got, want, dtype, "masked_chunk_attention")


# (B, S, T, Hq, Hkv, d, kv_len, q_pos, window, causal)
CHUNK_CASES = [
    (2, 4, 16, 4, 2, 16, [9, 12], [5, 8], 0, True),
    (2, 4, 16, 4, 2, 16, [9, 12], [5, 8], 3, True),
    (1, 6, 10, 2, 1, 8, 10, 4, 0, False),
    (1, 4, 12, 6, 3, 16, 4, 0, 0, True),             # the first chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_attention_matches_jax(case, dtype):
    b, s, t, hq, hkv, d, kv_len, q_pos, window, causal = case
    rng = np.random.default_rng(s * t + window)
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, s, t, hq, hkv, d, dtype)
    want = _jchunk(jq, jk, jv, jnp.asarray(kv_len), jnp.asarray(q_pos),
                   window=window, causal=causal)
    got = A.chunk_attention(q, k, v, kv_len, q_pos, window=window,
                            causal=causal)
    _check(got, want, dtype, f"chunk {case}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window, dtype):
    rng = np.random.default_rng(11 + window)
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 3, 1, 14, 8, 2, 16, dtype)
    lens = np.array([1, 14, 9], np.int32)
    want = _jdecode(jq, jk, jv, jnp.asarray(lens), window=window)
    got = A.decode_attention(q, k, v, torch.from_numpy(lens), window=window)
    _check(got, want, dtype, f"decode window={window}")
    want = _jdecode(jq, jk, jv, 6, window=window)   # scalar len
    got = A.decode_attention(q, k, v, 6, window=window)
    _check(got, want, dtype, f"decode scalar window={window}")


def _paged(rng, b, ps, n_pages, pool, hkv, d, lens, dtype):
    """Float K/V pools of `pool` pages and a page table giving row i
    ceil(lens[i] / ps) pages in shuffled order, the sentinel `pool` in its
    unallocated tail."""
    k, v = (rng.normal(size=(pool, ps, hkv, d)).astype(np.float32)
            for _ in range(2))
    order = rng.permutation(pool)
    table = np.full((b, n_pages), pool, np.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // ps)
        table[i, :need] = order[used:used + need]
        used += need
    return _pair(k, dtype), _pair(v, dtype), table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_and_decode_attention_match_jax(dtype):
    rng = np.random.default_rng(21)
    b, ps, n_pages, pool, hq, hkv, d = 2, 4, 5, 9, 4, 2, 16
    lens = [17, 6]
    (jk, k), (jv, v), table = _paged(rng, b, ps, n_pages, pool, hkv, d, lens,
                                     dtype)
    jt, pt = jnp.asarray(table), torch.from_numpy(table)
    jq, q = _pair(rng.normal(size=(b, 1, hq, d)).astype(np.float32), dtype)
    jl, pl = jnp.asarray(np.array(lens, np.int32)), torch.tensor(lens)
    for window in (0, 3):
        want = _jdecode_paged(jq, jk, jv, jt, jl, window=window)
        got = A.decode_attention_paged(q, k, v, pt, pl, window=window)
        _check(got, want, dtype, f"paged decode window={window}")
    jq, q = _pair(rng.normal(size=(1, 4, hq, d)).astype(np.float32), dtype)
    for window, causal in ((0, True), (2, True), (0, False)):
        want = _jchunk_paged(jq, jk, jv, jt[:1], 17, 13, window=window,
                             causal=causal)
        got = A.chunk_attention_paged(q, k, v, pt[:1], 17, 13, window=window,
                                      causal=causal)
        _check(got, want, dtype, f"paged chunk window={window} {causal}")
