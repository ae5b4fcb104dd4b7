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


# the edges of the kernels' dispatch rule (`gemm_plan`): small-M rows up to
# 32, tensor-core tiles from 33; K not a multiple of 32, N under one word,
# N = 288 (falcon-mamba's x_proj), float32 and bf16 lhs
EDGE_ROWS = [1, 4, 16, 32, 33, 64, 100]
EDGE_KN = [(100, 10), (300, 288), (1000, 33)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", EDGE_KN)
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_regime_edges_plain_match_jax_ref(m, k, n, dtype):
    x, w, thresh, flip = _case(m * 11 + k + n, m, k, n)
    xt = _t(x).to(dtype)
    ja, jb = _jax_operands(xt.float().numpy(), w)    # bf16 keeps every sign
    want = np.asarray(jref.binary_matmul_packed_ref(ja, jb, k))
    want_words = np.asarray(jref.binary_matmul_fused_ref(
        ja, jb, jnp.asarray(thresh), jnp.asarray(flip), k))
    b = pack_bits(_t(w.T))
    np.testing.assert_array_equal(bg.binary_gemm_packed_rhs(xt, b, k).numpy(),
                                  want)
    for lhs in (xt, pack_bits(xt)):
        np.testing.assert_array_equal(
            words(bg.binary_gemm_fused(lhs, b, _t(thresh), _t(flip), k)),
            want_words)


# kernel 1 (packed lhs) at the edges of its rule: the packed small-M kernel
# up to 32 rows (1 to 4 n8 tiles of rows) and the tensor-core tiles from 33
# rows and wherever KW % 4 != 0; M, K, N
PACKED_EDGES = [(m, k, n) for m in (1, 4, 8, 9, 16, 32, 33)
                for k, n in ((100, 10), (1000, 33), (300, 77), (5120, 1280))]


@pytest.mark.parametrize("m,k,n", PACKED_EDGES)
def test_packed_regime_edges_plain_match_jax_ref(m, k, n):
    x, w, _, _ = _case(m * 13 + k + n, m, k, n)
    ja, jb = _jax_operands(x, w)
    want = np.asarray(jref.binary_matmul_packed_ref(ja, jb, k))
    a, b = pack_bits(_t(x)), pack_bits(_t(w.T))
    np.testing.assert_array_equal(words(a), np.asarray(ja))
    np.testing.assert_array_equal(bg.binary_gemm_packed_plain(a, b, k).numpy(),
                                  want)
    np.testing.assert_array_equal(bg.binary_gemm_packed(a, b, k).numpy(), want)


# channels per block of kernel 1's small-M kernel on a 132-SM card, by N: the
# most that still give every SM a block (K|V: 40 blocks of 32, then K split
# in 2)
PACKED_BLOCK_N = {1280: 32, 5120: 32, 17920: 128}


@pytest.mark.parametrize("kernel,m,k,n,small_m,split", [
    # kernel 1 on phi3-medium-14b's q, K|V and gate|up at decode and chunk
    # rows, K split over a cluster at N 1280, tiles past 32 rows (33, the
    # MLP's output layer at 200) and at KW % 4 != 0
    ("binary_gemm_packed", 1, 5120, 5120, True, 1),
    ("binary_gemm_packed", 4, 5120, 5120, True, 1),
    ("binary_gemm_packed", 32, 5120, 5120, True, 1),
    ("binary_gemm_packed", 4, 5120, 17920, True, 1),
    ("binary_gemm_packed", 32, 5120, 17920, True, 1),
    ("binary_gemm_packed", 1, 5120, 1280, True, 2),
    ("binary_gemm_packed", 4, 5120, 1280, True, 2),
    ("binary_gemm_packed", 32, 5120, 1280, True, 2),
    ("binary_gemm_packed", 33, 5120, 1280, False, 8),
    ("binary_gemm_packed", 200, 1024, 10, False, 4),
    ("binary_gemm_packed", 4, 300, 77, False, 1),
    ("binary_gemm_packed_rhs", 4, 4096, 16384, True, 1),   # mamba in_proj
    ("binary_gemm_packed_rhs", 4, 8192, 288, True, 8),     # x_proj: a cluster
    ("binary_gemm_packed_rhs", 4, 8192, 4096, True, 2),    # out_proj
    ("binary_gemm_packed_rhs", 4, 5120, 5120, True, 2),    # phi3 wo
    ("binary_gemm_packed_rhs", 32, 4096, 16384, True, 1),  # in_proj, a chunk
    ("binary_gemm_packed_rhs", 32, 17920, 5120, True, 2),  # phi3 w_down
    ("binary_gemm_packed_rhs", 1, 100, 10, True, 1),       # 4 words: no split
    ("binary_gemm_packed_rhs", 33, 8192, 288, False, 8),   # past 32 rows
    ("binary_gemm_packed_rhs", 4, 300, 77, False, 1),      # KW % 4 != 0
    ("binary_gemm_packed_rhs", 32, 499968, 20000, False, 2),  # lhs too wide
    ("binary_gemm_packed_rhs", 102400, 1152, 128, False, 1),  # conv 2
    ("binary_gemm_packed_rhs", 6400, 4608, 512, False, 1),    # conv 6
    ("binary_gemm_fused", 200, 1024, 1024, False, 4),      # mlp layer 2
    ("binary_gemm_fused", 100, 8192, 1024, False, 8),      # cnn fc1
    ("binary_gemm_fused", 4, 8192, 288, True, 8),          # kernel 3: small M
    ("binary_gemm_fused", 4, 6144, 24576, True, 1),        # nemotron w_up
    ("binary_gemm_fused", 32, 6144, 24576, False, 2),      # past 16 rows
    ("binary_gemm_fused", 4000, 1024, 1024, False, 1),
    # kernel 4 (its signed w as the packed rhs): the five bnn-cifar10 train
    # convs at batch 100, small M, tiles at small M (KW % 4 != 0), a split
    ("binary_gemm_mxu", 102400, 1152, 128, False, 1),
    ("binary_gemm_mxu", 25600, 1152, 256, False, 1),
    ("binary_gemm_mxu", 25600, 2304, 256, False, 1),
    ("binary_gemm_mxu", 6400, 2304, 512, False, 1),
    ("binary_gemm_mxu", 6400, 4608, 512, False, 1),
    ("binary_gemm_mxu", 4, 1024, 300, True, 1),
    ("binary_gemm_mxu", 32, 8190, 200, True, 8),
    ("binary_gemm_mxu", 17, 300, 48, False, 1),
    ("binary_gemm_mxu", 300, 1000, 257, False, 4),
])
def test_gemm_plan_rule(kernel, m, k, n, small_m, split):
    """The fixed dispatch rule on a 132-SM card: which kernel, how many
    blocks per cluster along K, and always one launch."""
    plan = bg.gemm_plan(kernel, m, n, k, 132)
    assert (plan.small_m, plan.split, plan.launches) == (small_m, split, 1)
    if small_m and kernel == "binary_gemm_packed":
        assert plan.block_n == PACKED_BLOCK_N[n]
        assert plan.blocks == -(-n // plan.block_n) * split
    elif small_m:
        assert plan.block_n == (64 if n >= 32 * 3 * 132 else 32)
        assert plan.blocks == -(-n // plan.block_n) * split
    else:
        assert plan.block_n == (256 if kernel != "binary_gemm_fused"
                                and n > 128 and split == 1 else 128)
        assert plan.blocks == -(-m // 64) * -(-n // plan.block_n) * split


def test_gemm_plan_splits_to_fill_the_card():
    """A split is a power of two up to 8 that stops doubling once the grid
    holds 1.5 blocks per SM (half for kernel 1's small-M kernel) or a block
    would keep too little of K; unaligned operands never take the small-M
    kernels; other kernels have no plan."""
    for sms in (66, 114, 132):
        for m in (1, 4, 32, 33, 200):
            for k, n in ((1000, 33), (8192, 288), (17920, 5120), (784, 1024)):
                for kernel in ("binary_gemm_packed", "binary_gemm_packed_rhs",
                               "binary_gemm_mxu", "binary_gemm_fused"):
                    plan = bg.gemm_plan(kernel, m, n, k, sms)
                    assert plan.split in (1, 2, 4, 8)
                    if plan.split > 1:
                        assert 2 * (plan.blocks // 2) < 3 * sms
                # kernel 4 runs kernel 2's kernels on its signed w
                assert bg.gemm_plan("binary_gemm_mxu", m, n, k, sms) == \
                    bg.gemm_plan("binary_gemm_packed_rhs", m, n, k, sms)
    for kernel in ("binary_gemm_packed", "binary_gemm_packed_rhs"):
        assert not bg.gemm_plan(kernel, 4, 4096, 4096, 132,
                                aligned=False).small_m
    with pytest.raises(ValueError):
        bg.gemm_plan("pack_bits", 4, 4096, 4096, 132)


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
