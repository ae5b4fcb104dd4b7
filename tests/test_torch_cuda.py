"""Each Hopper kernel of the port against its plain PyTorch version, on
the card. Integer dots and packed words: tolerance 0.

These tests need a CUDA card and nvcc. They decide inside each test whether
a card is present and skip where there is none (the kernels have no CPU
mode; tests/test_torch_binary_gemm.py holds the plain versions to the JAX
package on the CPU). This file imports no jax, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bitpack import pack_bits, packed_width
from repro_torch.kernels import binary_gemm as bg

# ragged shapes of tests/test_bit_resident.py plus one word-aligned case
SHAPES = [(8, 32, 64), (9, 100, 48), (17, 64, 10), (3, 37, 33),
          (130, 257, 129)]


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0                  # sign(0) := +1
    w = rng.normal(size=(k, n)).astype(np.float32)
    thresh = rng.integers(-k, k + 1, n).astype(np.int32)
    flip = rng.integers(0, 2, n).astype(np.int32)
    return x, w, thresh, flip


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the Hopper kernels have no "
                    "CPU mode (test_torch_binary_gemm.py holds their plain "
                    "versions to the JAX package)")


@pytest.mark.cuda
def test_cuda_binary_gemm_packed_matches_plain():
    _need_card()
    for m, k, n in SHAPES + [(200, 1024, 10)]:
        x, w, _, _ = _case(m + k, m, k, n)
        a, b = pack_bits(_t(x)), pack_bits(_t(w.T))
        got = bg.binary_gemm_packed(a.cuda(), b.cuda(), k)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu(), bg.binary_gemm_packed_plain(a, b, k))


@pytest.mark.cuda
def test_cuda_binary_gemm_packed_rhs_matches_plain():
    _need_card()
    for m, k, n in SHAPES + [(1000, 1152, 128)]:
        x, w, _, _ = _case(m + 2 * k, m, k, n)
        b = pack_bits(_t(w.T))
        got = bg.binary_gemm_packed_rhs(_t(x).cuda(), b.cuda(), k)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(
            got.cpu(), bg.binary_gemm_packed_rhs_plain(_t(x), b, k))


@pytest.mark.cuda
@pytest.mark.parametrize("packed_lhs", [True, False])
def test_cuda_binary_gemm_fused_matches_plain(packed_lhs):
    _need_card()
    for m, k, n in SHAPES + [(200, 1024, 1024)]:
        x, w, thresh, flip = _case(m + 3 * k, m, k, n)
        lhs = pack_bits(_t(x)) if packed_lhs else _t(x)
        b = pack_bits(_t(w.T))
        got = bg.binary_gemm_fused(lhs.cuda(), b.cuda(), _t(thresh).cuda(),
                                   _t(flip).cuda(), k)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(
            got.cpu(), bg.binary_gemm_fused_plain(lhs, b, _t(thresh), _t(flip), k))


def _card_operands(g, m, k, n, dtype):
    """Card operands with the sign edge cases: +0.0 and -0.0 (+1), NaN (-1)."""
    x = torch.randn(m, k, generator=g, device="cuda")
    x.view(-1)[::13] = 0.0
    x.view(-1)[1::17] = -0.0
    x.view(-1)[2::19] = float("nan")
    b = pack_bits(torch.randn(n, k, generator=g, device="cuda"))
    d = int(k ** 0.5)
    thresh = torch.randint(-d, d + 1, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    flip = torch.randint(0, 2, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    return x.to(dtype), b, thresh, flip


def _one_launch(name, fn):
    bg.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert bg.launches[name] == 1
    return out


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


# Kernel 2's two regimes at their edges: the small-M kernel up to 32 rows
# (K not a multiple of 32, N under one word, N = 288), tensor-core tiles from
# 33 rows on and wherever KW % 4 != 0 (K = 300); (M, K, N)
REGIME_SHAPES = [(m, k, n) for m in (1, 4, 16, 32, 33, 64, 100)
                 for k, n in ((100, 10), (1000, 288), (3961, 130), (300, 77))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binary_gemm_packed_rhs_regimes_match_plain(dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in REGIME_SHAPES:
        x, b, _, _ = _card_operands(g, m, k, n, dtype)
        plan = bg.gemm_plan("binary_gemm_packed_rhs", m, n, k, _sms())
        assert plan.small_m == (m <= bg.SMALL_M_ROWS and k != 300)
        got = _one_launch("binary_gemm_packed_rhs",
                          lambda: bg.binary_gemm_packed_rhs(x, b, k))
        assert torch.equal(got, bg.binary_gemm_packed_rhs_plain(x, b, k)), \
            (m, k, n, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binary_gemm_packed_rhs_wide_tiles_match_plain(dtype):
    """256-channel tiles (N > 128, enough tiles to fill the card): ragged
    N, odd N (element stores), K off the 128-value stage."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for m, k, n in ((12800, 1000, 384), (12831, 300, 301), (25600, 1152, 256)):
        x, b, _, _ = _card_operands(g, m, k, n, dtype)
        plan = bg.gemm_plan("binary_gemm_packed_rhs", m, n, k, _sms())
        assert plan.block_n == 256 and plan.split == 1
        got = _one_launch("binary_gemm_packed_rhs",
                          lambda: bg.binary_gemm_packed_rhs(x, b, k))
        assert torch.equal(got, bg.binary_gemm_packed_rhs_plain(x, b, k)), \
            (m, k, n, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 32])
def test_cuda_binary_gemm_packed_rhs_cluster_split_matches_plain(m):
    """K >= 8192 with N <= 288 splits K over a full cluster (falcon-mamba's
    x_proj); the LM's other shapes split it in 2 or 4."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for k, n, split in ((8192, 288, 8), (8190, 200, 8), (17920, 5120, None),
                        (8192, 4096, None)):
        x, b, _, _ = _card_operands(g, m, k, n, torch.bfloat16)
        plan = bg.gemm_plan("binary_gemm_packed_rhs", m, n, k, _sms())
        assert plan.small_m and plan.split > 1
        if split:
            assert plan.split == split
        got = _one_launch("binary_gemm_packed_rhs",
                          lambda: bg.binary_gemm_packed_rhs(x, b, k))
        assert torch.equal(got, bg.binary_gemm_packed_rhs_plain(x, b, k)), \
            (m, k, n, plan)


# Kernel 1's regimes: the packed small-M kernel (single-bit tensor cores,
# 1 to 32 rows) at phi3's K|V shape, ragged K and N; tensor-core tiles from
# 33 rows (the MLP's output layer at 200) and wherever KW % 4 != 0 (K 300,
# 37); (M, K, N)
PACKED_REGIMES = [(m, k, n) for m in (1, 4, 8, 9, 16, 32, 33, 200)
                  for k, n in ((5120, 1280), (1000, 33), (3961, 130),
                               (300, 77), (37, 33))]


@pytest.mark.cuda
def test_cuda_binary_gemm_packed_regimes_match_plain():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    for m, k, n in PACKED_REGIMES:
        x, b, _, _ = _card_operands(g, m, k, n, torch.float32)
        a = pack_bits(x)
        plan = bg.gemm_plan("binary_gemm_packed", m, n, k, _sms())
        assert plan.small_m == (m <= bg.SMALL_M_ROWS
                                and packed_width(k) % 4 == 0)
        got = _one_launch("binary_gemm_packed",
                          lambda: bg.binary_gemm_packed(a, b, k))
        assert torch.equal(got, bg.binary_gemm_packed_plain(a, b, k)), \
            (m, k, n, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32])
def test_cuda_binary_gemm_packed_each_split_matches_plain(m):
    """The packed small-M kernel with K split over 1, 2, 4 and 8 blocks of a
    cluster and 32 to 256 channels a block (the plan forced), at one and at
    four n8 tiles of rows: every combination equals the plain version."""
    from dataclasses import replace
    from unittest import mock
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    for k, n in ((5120, 1280), (8190, 200)):
        x, b, _, _ = _card_operands(g, m, k, n, torch.float32)
        a = pack_bits(x)
        want = bg.binary_gemm_packed_plain(a, b, k)
        plan = bg.gemm_plan("binary_gemm_packed", m, n, k, _sms())
        assert plan.small_m
        for split in (1, 2, 4, 8):
            for block_n in (32, 64, 128, 256):
                forced = replace(plan, split=split, block_n=block_n,
                                 blocks=-(-n // block_n) * split)
                with mock.patch.object(bg, "gemm_plan",
                                       lambda *_, forced=forced: forced):
                    got = _one_launch("binary_gemm_packed",
                                      lambda: bg.binary_gemm_packed(a, b, k))
                assert torch.equal(got, want), (m, k, n, split, block_n)


# kernel 3's main-path shapes: MLP layers 1-2 at batch 200 (layer 1 of the
# MNIST input width, then 1024), CNN fc1 and fc2 at batch 100
FUSED_MAIN_SHAPES = [(200, 784, 1024), (200, 1024, 1024), (100, 8192, 1024),
                     (100, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("lhs", ["packed", "float32", "bfloat16"])
def test_cuda_binary_gemm_fused_main_and_small_shapes_match_plain(lhs):
    """Kernel 3 on tensor-core tiles split over a cluster at its main-path
    shapes, and at M <= 32: the small-M kernel with the fused epilogue at
    M <= FUSED_SMALL_M_ROWS where KW % 4 == 0 (a cluster of 8 at K 8192, N
    288; N off a word), the tiles otherwise (KW % 4 != 0, 32 rows)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    dtype = torch.bfloat16 if lhs == "bfloat16" else torch.float32
    for m, k, n in FUSED_MAIN_SHAPES + [(1, 300, 77), (4, 8192, 288),
                                        (16, 1000, 77), (32, 1000, 33)]:
        x, b, thresh, flip = _card_operands(g, m, k, n, dtype)
        a = pack_bits(x) if lhs == "packed" else x
        plan = bg.gemm_plan("binary_gemm_fused", m, n, k, _sms())
        assert plan.small_m == (m <= bg.FUSED_SMALL_M_ROWS
                                and packed_width(k) % 4 == 0)
        got = _one_launch("binary_gemm_fused",
                          lambda: bg.binary_gemm_fused(a, b, thresh, flip, k))
        assert torch.equal(got, bg.binary_gemm_fused_plain(a, b, thresh, flip,
                                                           k)), (m, k, n, plan)


# ---------------------------------------------------------------------------
# Kernel 4: the +-1 GEMM of the training path (w sign-packed, then the
# tensor-core tiles or the small-M kernel with a float32 store)
# ---------------------------------------------------------------------------
# the bnn-cifar10 train step's five binary convs at batch 100, then ragged
# shapes: K of 1, 31, 33 and 1000, M and N off the 128x128 tile
MXU_SHAPES = [(102400, 1152, 128), (25600, 1152, 256), (25600, 2304, 256),
              (6400, 2304, 512), (6400, 4608, 512),
              (5, 1, 7), (129, 31, 131), (70, 33, 200), (300, 1000, 257),
              (9, 100, 48), (3, 37, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binary_gemm_mxu_matches_plain(dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in MXU_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda")
        x.view(-1)[::13] = 0.0                     # sign(0) := +1
        x.view(-1)[1::17] = -0.0
        w = torch.randn(k, n, generator=g, device="cuda")
        w.view(-1)[::7] = 0.0
        xs = x.to(dtype)
        bg.reset_launches()
        got = bg.binary_gemm_mxu(xs, w)
        torch.cuda.synchronize()
        assert bg.launches["binary_gemm_mxu"] == 1
        assert torch.equal(got, bg.binary_gemm_mxu_plain(xs, w)), (m, k, n)
    # a tensor that starts off 16-byte alignment is read one value at a time
    x = torch.randn(65 * 128 + 1, generator=g, device="cuda")[1:].view(65, 128)
    assert x.data_ptr() % 16 != 0
    w = torch.randn(128, 40, generator=g, device="cuda")
    assert torch.equal(bg.binary_gemm_mxu(x, w), bg.binary_gemm_mxu_plain(x, w))


# kernel 4 through each of its plan's regimes (shape, small_m, split):
# small-M rows (a 16-byte-word K and an 8-block split of K 8190), tiles at
# small M where KW % 4 != 0, tiles split over a cluster, 256-channel tiles
MXU_REGIMES = [((4, 1024, 300), True, 1), ((32, 8190, 200), True, 8),
               ((17, 300, 48), False, 1), ((300, 1000, 257), False, 4),
               ((25600, 1152, 256), False, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_binary_gemm_mxu_regimes_match_plain(dtype):
    """Kernel 4 equals its plain version (tolerance 0) in every regime of
    `gemm_plan`, with NaN, -0.0 and 0.0 in both x and w (sign: +1 where
    v >= 0, so -0.0 is +1 and NaN -1), one launch per call."""
    from repro_torch._device import sm_count
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    for (m, k, n), small_m, split in MXU_REGIMES:
        plan = bg.gemm_plan("binary_gemm_mxu", m, n, k, sm_count("cuda"))
        assert (plan.small_m, plan.split) == (small_m, split), (m, k, n)
        x = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(k, n, generator=g, device="cuda")
        for t in (x, w):
            t.view(-1)[::13] = 0.0
            t.view(-1)[1::17] = -0.0
            t.view(-1)[2::19] = float("nan")
        xs = x.to(dtype)
        bg.reset_launches()
        got = bg.binary_gemm_mxu(xs, w)
        torch.cuda.synchronize()
        assert bg.launches["binary_gemm_mxu"] == 1
        assert torch.equal(got, bg.binary_gemm_mxu_plain(xs, w)), (m, k, n)


@pytest.mark.cuda
def test_cuda_binary_matmul_routes_agree_with_gradients():
    from repro_torch.kernels import ops
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(300, 1000, generator=g, device="cuda")
    w = torch.randn(1000, 70, generator=g, device="cuda")
    up = torch.randn(300, 70, generator=g, device="cuda")
    outs = {}
    for path in ops.MATMUL_PATHS:
        xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = ops.binary_matmul(xt, wt, path)
        out.backward(up)
        outs[path] = (out.detach(), xt.grad, wt.grad)
    for path, (out, gx, gw) in outs.items():
        for a, b in zip((out, gx, gw), outs["ref"]):
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# Kernels 5 (sign-pack), 6 (decode attention), 8 (prefill attention)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pack_bits_matches_plain(dtype):
    from repro_torch.kernels.pack import pack_bits_kernel, pack_bits_plain
    _need_card()
    for m, k in [(1, 1), (3, 31), (5, 33), (32, 5120), (7, 17920), (4, 130)]:
        x = torch.from_numpy(_case(m + k, m, k, 1)[0]).to(dtype)
        x.view(-1)[1::17] = -0.0
        x.view(-1)[2::19] = float("nan")
        got = pack_bits_kernel(x.cuda())
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu(), pack_bits_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hkv,hd,inactive", [
    (4, 10, 128, (1, 3)),      # phi3's decode step, two rows inactive
    (32, 10, 128, ()),         # a chunk (pads: -1)
    (200, 10, 128, ()),        # a whole prompt
    (5, 2, 37, (0,)),          # K off a word, K % 8 != 0 (ballot body)
    (3, 3, 72, ()),            # K % 8 == 0, off a word
])
def test_cuda_pack_rows_into_matches_plain(dtype, n, hkv, hd, inactive):
    """Kernel 5's cache entry against its plain version: both pools equal
    bit for bit, written rows and untouched rows alike; one launch a
    call."""
    from repro_torch.kernels import pack as pk
    _need_card()
    rng = np.random.default_rng(n * hd)
    kw = packed_width(hd)
    rows_total = n + 7
    srcs = []
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=(n, hkv, hd)).astype(np.float32))
        x.view(-1)[1::17] = -0.0
        x.view(-1)[2::19] = float("nan")
        srcs.append(x.to(dtype).cuda())
    pools = [torch.from_numpy(rng.integers(-2**31, 2**31, (rows_total, hkv, kw))
                              .astype(np.int32)).cuda() for _ in range(2)]
    dst = torch.from_numpy(rng.permutation(rows_total)[:n].astype(np.int64))
    dst[list(inactive)] = -1
    dst = dst.cuda()
    want = [p.clone() for p in pools]
    pk.pack_rows_into_plain(srcs, want, dst)
    before = pk.launches["pack_bits"]
    pk.pack_rows_into(srcs, pools, dst)
    torch.cuda.synchronize()
    assert pk.launches["pack_bits"] - before == 1
    for got, ref in zip(pools, want, strict=True):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_pack_rows_into_rejects_a_strided_source():
    from repro_torch.kernels import pack as pk
    _need_card()
    x = torch.ones(4, 2, 64, device="cuda")[:, :, :32]
    pool = torch.zeros(4, 2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        pk.pack_rows_into([x], [pool], torch.arange(4, device="cuda"))


def _attention_case(seed, b, t, hkv, g, hd, s=1):
    rng = np.random.default_rng(seed)
    kv = [pack_bits(torch.from_numpy(rng.normal(size=(b, t, hkv, hd))
                                     .astype(np.float32))) for _ in range(2)]
    q = torch.from_numpy(rng.integers(-4, 5, (b, s, hkv * g, hd))
                         .astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.5, 1.0, (b, hkv)).astype(np.float32))
    return q, kv[0], kv[1], vs


# attention outputs, rtol = atol: one bf16 ulp, 8 float32 ulps (at 1)
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-6}

# (B, T, Hkv, G, hd, window): GQA G = 1 and 8, odd hd, T not a multiple of
# 32, a window, and the main path's (4, 512, 10, 4, 128)
DECODE = [(4, 512, 10, 4, 128, 0), (3, 37, 2, 1, 33, 0), (2, 70, 1, 8, 64, 9),
          (5, 33, 3, 2, 128, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_matches_plain(dtype):
    """Dots equal; outputs within TOL[q.dtype] (the float sums are exact in
    both; exp may differ by an ulp between CUDA's expf and torch's)."""
    from repro_torch.kernels import decode_attention as da
    _need_card()
    for b, t, hkv, g, hd, window in DECODE:
        q, k, v, vs = _attention_case(t + hd, b, t, hkv, g, hd)
        q = q.to(dtype)
        lens = torch.from_numpy(np.random.default_rng(t).integers(
            1, t + 1, b).astype(np.int32))
        lens[0] = 1
        args = [a.cuda() for a in (q, k, v, vs, lens)]
        got, dots = da.decode_attention_packed(*args, window=window,
                                               return_dots=True)
        want, wdots = da.decode_attention_packed_plain(
            *args, window=window, return_dots=True)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(dots.cpu(), wdots.cpu())
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got >= 0, want >= 0)
    # cache_len 0: every position of the row weighs 1 (the JAX oracle's
    # all-masked softmax), the sums exact in both: bit for bit
    flat = da.decode_attention_packed(*args[:4], 0)
    assert torch.equal(flat, da.decode_attention_packed_plain(*args[:4], 0))
    assert torch.isfinite(flat).all() and (flat != 0).any()


PREFILL = [(1, 32, 512, 10, 4, 128, 0, True), (2, 7, 45, 2, 1, 33, 5, True),
           (1, 16, 70, 1, 8, 64, 0, False), (3, 5, 40, 2, 2, 16, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_attention_matches_plain(dtype):
    from repro_torch.kernels import prefill_attention as pa
    _need_card()
    for b, s, t, hkv, g, hd, window, causal in PREFILL:
        q, k, v, vs = _attention_case(s + t, b, t, hkv, g, hd, s)
        q = q.to(dtype)
        q_pos = torch.from_numpy(np.random.default_rng(s).integers(
            0, t - s + 1, b).astype(np.int32))
        args = [a.cuda() for a in (q, k, v, vs)]
        for kv_len, qp in ((q_pos + s, q_pos), (int(q_pos[0]) + s,
                                                int(q_pos[0]))):
            kv_len = kv_len.cuda() if isinstance(kv_len, torch.Tensor) \
                else kv_len
            qp = qp.cuda() if isinstance(qp, torch.Tensor) else qp
            got, dots = pa.prefill_attention_packed(
                *args, kv_len, qp, window=window, causal=causal,
                return_dots=True)
            want, wdots = pa.prefill_attention_packed_plain(
                *args, kv_len, qp, window=window, causal=causal,
                return_dots=True)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(dots.cpu(), wdots.cpu())
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert torch.equal(got >= 0, want >= 0)


@pytest.mark.cuda
def test_cuda_prefill_one_row_equals_decode():
    """A one-row chunk at q_pos = kv_len - 1 through the prefill wrapper
    equals the decode wrapper's step bit for bit: both launch the one
    attention body with the same plan, decode reading q_pos from the
    length."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    _need_card()
    q, k, v, vs = [a.cuda() for a in _attention_case(1, 3, 50, 2, 4, 64)]
    lens = torch.tensor([1, 20, 50], dtype=torch.int32, device="cuda")
    dec = da.decode_attention_packed(q, k, v, vs, lens, window=4)
    pre = pa.prefill_attention_packed(q, k, v, vs, lens, lens - 1, window=4)
    torch.cuda.synchronize()
    assert torch.equal(dec, pre)


# ---------------------------------------------------------------------------
# Kernels 7 and 9: decode and prefill attention over a paged pool
# ---------------------------------------------------------------------------
def _paged_case(seed, b, ps, n_pages, pool, hkv, g, hd, lens, s=1):
    """Packed K/V pools of `pool` pages, and a page table giving row i
    ceil(lens[i] / ps) distinct pages in shuffled order, the sentinel
    `pool` in its unallocated tail."""
    rng = np.random.default_rng(seed)
    k, v = (pack_bits(torch.from_numpy(rng.normal(size=(pool, ps, hkv, hd))
                                       .astype(np.float32)))
            for _ in range(2))
    free = list(rng.permutation(pool))
    table = np.full((b, n_pages), pool, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-int(n) // ps)):
            table[i, j] = free.pop()
    q = torch.from_numpy(rng.integers(-4, 5, (b, s, hkv * g, hd))
                         .astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.5, 1.0, (b, hkv)).astype(np.float32))
    return q, k, v, vs, torch.from_numpy(table)


# (B, ps, NP, pool, Hkv, G, hd, lengths, window): the main path's shape (a
# 64-page pool, lengths 512/300/100/17) and a ragged one (ps 16, hd 33, a
# row of length 0, a window)
PAGED = [(4, 32, 16, 64, 10, 4, 128, (512, 300, 100, 17), 0),
         (3, 16, 5, 12, 2, 2, 33, (0, 37, 80), 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_paged_matches_plain_and_contiguous(dtype):
    """Outputs and dots at every position equal, bit for bit, the plain
    version's (gather + contiguous plain) and the contiguous kernel's on
    the gathered panel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    _need_card()
    for b, ps, n_pages, pool, hkv, g, hd, lens, window in PAGED:
        q, k, v, vs, pt = [a.cuda() for a in _paged_case(
            hd + ps, b, ps, n_pages, pool, hkv, g, hd, lens)]
        q = q.to(dtype)
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got, dots = da.decode_attention_packed_paged(
            q, k, v, vs, pt, lens_t, window=window, return_dots=True)
        want, wdots = da.decode_attention_packed_paged_plain(
            q, k, v, vs, pt, lens_t, window=window, return_dots=True)
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        contig, cdots = da.decode_attention_packed(
            q, kg, vg, vs, lens_t, window=window, return_dots=True)
        torch.cuda.synchronize()
        for other, odots in ((want, wdots), (contig, cdots)):
            assert torch.equal(dots, odots)
            assert torch.equal(got, other)
        # a row of length 0 weighs its whole gathered row (sentinels
        # clipped to page P-1), as the JAX oracle does
        assert (got[lens_t == 0] != 0).any() or not (lens_t == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_attention_paged_matches_plain_and_contiguous(dtype):
    """A chunk of 32 at q_pos 0 and 96 against one slot's table row (as
    the engine calls it), and per-row q_pos over every row of the table:
    outputs and dots equal the plain version's and the contiguous
    kernel's on the gathered panel, bit for bit."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref
    _need_card()
    for b, ps, n_pages, pool, hkv, g, hd, lens, window in PAGED:
        s = 32 if hd == 128 else 5
        q, k, v, vs, pt = [a.cuda() for a in _paged_case(
            hd + ps + 1, b, ps, n_pages, pool, hkv, g, hd, lens, s)]
        q = q.to(dtype)
        rows = [(q[1:2], vs[1:2], pt[1:2], qp, qp + s) for qp in (0, 96)] \
            if hd == 128 else []
        qpos = torch.tensor([max(n - s, 0) for n in lens], dtype=torch.int32,
                            device="cuda")
        rows.append((q, vs, pt, qpos, qpos + s))
        for qq, vv, tt, qp, kv in rows:
            got, dots = pa.prefill_attention_packed_paged(
                qq, k, v, vv, tt, kv, qp, window=window, return_dots=True)
            want, wdots = pa.prefill_attention_packed_paged_plain(
                qq, k, v, vv, tt, kv, qp, window=window, return_dots=True)
            contig, cdots = pa.prefill_attention_packed(
                qq, ref.gather_pages(k, tt), ref.gather_pages(v, tt), vv, kv,
                qp, window=window, return_dots=True)
            torch.cuda.synchronize()
            for other, odots in ((want, wdots), (contig, cdots)):
                assert torch.equal(dots, odots)
                assert torch.equal(got, other)


# (B, S, T, Hkv, G, hd, kv_lens, q_pos, window, split): 32-row chunks at
# the end of 2,048- and 4,096-position contexts (past ~1,770, where a
# (32, T) score panel no longer fits shared memory), a window shorter than
# the chunk, kv_len 0 rows, and grids that take a split of 8, 4, 2 and 1
LONG = [(1, 32, 2048, 2, 4, 128, (2048,), (2016,), 0, 8),
        (1, 32, 4096, 10, 4, 128, (4096,), (4064,), 0, 4),
        (2, 32, 4096, 10, 4, 128, (0, 4000), (0, 3968), 8, 2),
        (4, 64, 2048, 10, 4, 128, (2048, 0, 700, 64), (1984, 0, 636, 0), 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_attention_long_contexts_match_plain(dtype):
    """Kernels 8 and 9 at T 2,048 and 4,096: dots at every position equal
    the plain version's, outputs within TOL with equal signs, rows of
    kv_len 0 give 0, and paged (shuffled pool pages, sentinel entries
    past each row's length) equals contiguous bit for bit."""
    from repro_torch._device import sm_count
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref
    _need_card()
    ps = 64
    for b, s, t, hkv, g, hd, lens, qpos, window, split in LONG:
        plan = pa.attention_plan(b, s, t, hkv, g, hd, sm_count("cuda"))
        assert plan.split == split, (b, s, t)
        pool = b * t // ps + 3
        q, k, v, vs, pt = _paged_case(t + s + window, b, ps, t // ps, pool,
                                      hkv, g, hd, lens, s)
        q, k, v, vs, pt = [a.cuda() for a in (q.to(dtype), k, v, vs, pt)]
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        got, dots = pa.prefill_attention_packed(q, kg, vg, vs, kv, qp,
                                                window=window,
                                                return_dots=True)
        want, wdots = pa.prefill_attention_packed_plain(
            q, kg, vg, vs, kv, qp, window=window, return_dots=True)
        paged, pdots = pa.prefill_attention_packed_paged(
            q, k, v, vs, pt, kv, qp, window=window, return_dots=True)
        torch.cuda.synchronize()
        assert torch.equal(dots, wdots) and torch.equal(pdots, dots)
        assert torch.equal(paged, got)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got >= 0, want >= 0)
        assert (got[kv == 0] == 0).all()


@pytest.mark.cuda
def test_cuda_prefill_one_row_equals_decode_at_the_main_shape():
    """A one-row chunk at q_pos = kv_len - 1 through the prefill wrappers
    equals the decode wrappers' step bit for bit at the LM's decode shape
    (B 4, T 512, Hkv 10, G 4, hd 128), contiguous and paged: the same
    body, plan and split, q_pos given or read from the length."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import ref
    _need_card()
    lens = (1, 100, 333, 512)
    q, k, v, vs, pt = [a.cuda() for a in _paged_case(
        7, 4, 32, 16, 64, 10, 4, 128, lens)]
    q = q.to(torch.bfloat16)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
    for dec, pre in (
            (da.decode_attention_packed_paged(q, k, v, vs, pt, kv),
             pa.prefill_attention_packed_paged(q, k, v, vs, pt, kv, kv - 1)),
            (da.decode_attention_packed(q, kg, vg, vs, kv),
             pa.prefill_attention_packed(q, kg, vg, vs, kv, kv - 1))):
        torch.cuda.synchronize()
        assert torch.equal(dec, pre)


# (B, T, Hkv, lengths, window): decode at the LM's G and hd (4, 128) past
# the old panel body's cap of ~14,500 positions, with a window and a
# cache_len 0 row
LONG_DECODE = [(4, 4096, 10, (4096, 3000, 1000, 17), 0),
               (3, 16384, 2, (16384, 0, 9001), 0),
               (2, 16384, 1, (16384, 12000), 700)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_long_contexts_match_plain(dtype):
    """Kernels 6 and 7 at T 4,096 and 16,384: dots at every position equal
    the plain version's, outputs within TOL with equal signs, cache_len 0
    rows weigh their whole row (not 0), and paged (shuffled 64-position
    pages, sentinel entries past each row's length) equals contiguous bit
    for bit."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    _need_card()
    ps = 64
    for b, t, hkv, lens, window in LONG_DECODE:
        pool = b * t // ps + 3
        q, k, v, vs, pt = _paged_case(t + b + window, b, ps, t // ps, pool,
                                      hkv, 4, 128, lens)
        q, k, v, vs, pt = [a.cuda() for a in (q.to(dtype), k, v, vs, pt)]
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        got, dots = da.decode_attention_packed(q, kg, vg, vs, kv,
                                               window=window,
                                               return_dots=True)
        want, wdots = da.decode_attention_packed_plain(
            q, kg, vg, vs, kv, window=window, return_dots=True)
        paged, pdots = da.decode_attention_packed_paged(
            q, k, v, vs, pt, kv, window=window, return_dots=True)
        served = da.decode_attention_packed_paged(q, k, v, vs, pt, kv,
                                                  window=window)
        torch.cuda.synchronize()
        assert torch.equal(dots, wdots) and torch.equal(pdots, dots)
        assert torch.equal(paged, got) and torch.equal(served, got)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got >= 0, want >= 0)
        assert (got[kv == 0] != 0).any() or not (kv == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_at_the_hybrid_ring_shape(dtype):
    """Kernel 6 at recurrentgemma-2b's ring: B 4, T 2048, one KV head, G 10
    (a decode step's 10 query rows take the wide body), hd 256, cache
    lengths 0, 1, 17, 2,047 and 2,048: dots equal the plain version's,
    outputs within TOL with equal signs, cache_len 0 rows weigh the whole
    ring alike (not 0)."""
    from repro_torch.kernels import decode_attention as da
    _need_card()
    for lens in ((2048, 2047, 17, 1), (0, 2048, 1, 17)):
        q, k, v, vs = _attention_case(sum(lens), 4, 2048, 1, 10, 256)
        kv = torch.tensor(lens, dtype=torch.int32)
        args = [a.cuda() for a in (q.to(dtype), k, v, vs, kv)]
        got, dots = da.decode_attention_packed(*args, return_dots=True)
        want, wdots = da.decode_attention_packed_plain(*args,
                                                       return_dots=True)
        torch.cuda.synchronize()
        assert torch.equal(dots, wdots)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got >= 0, want >= 0)
        assert (got[args[4] == 0] != 0).any() or not (args[4] == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,chunk", [(1, 4), (1, None), (0, 4)])
def test_cuda_hybrid_engine_matches_plain(kv_bits, chunk):
    """The smoke recurrentgemma-2b (window 8) served on the card through the
    kernels and through their plain versions: greedy tokens equal, on
    prompts longer than the window; at kv_bits=1 decode runs kernel 6."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    _need_card()
    cfg = smoke_config("recurrentgemma-2b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cuda")
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b) for n, b in ((19, 6), (5, 9), (11, 4))]
    kw = dict(freeze=True, slots=2, max_len=32, kv_bits=kv_bits,
              prefill_chunk=chunk)
    da.reset_launches()
    got = ServingEngine(cfg, params, **kw).generate(reqs)
    assert (da.launches["decode_attention_packed"] > 0) == (kv_bits == 1)
    want = ServingEngine(cfg, params, kernel_path="ref", **kw).generate(reqs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32, 200])
def test_cuda_fused_gemm_at_nemotron_w_up(m):
    """Kernel 3 at nemotron-4-15b's up-projection (K 6,144, N 24,576), a
    bf16 lhs, with the act:sq_relu fold (ALWAYS_THRESH, no flip): every word
    all ones, as the plain version gives, though the dots take both signs;
    with random thresholds near 0, the plain version's words. Then kernel 1
    on those words as the lhs of w_down (K 24,576, N 6,144)."""
    from repro_torch.core.packed import ALWAYS_THRESH
    _need_card()
    k, n = 6144, 24576
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    b = pack_bits(torch.randn(n, k, generator=g, device="cuda"))
    always = torch.full((n,), ALWAYS_THRESH, dtype=torch.int32, device="cuda")
    zero = torch.zeros(n, dtype=torch.int32, device="cuda")
    dots = bg.binary_gemm_packed_rhs(x, b, k)
    assert (dots > 0).any() and (dots < 0).any()
    got = bg.binary_gemm_fused(x, b, always, zero, k)
    torch.cuda.synchronize()
    assert torch.equal(got, bg.binary_gemm_fused_plain(x, b, always, zero, k))
    assert (got == -1).all()
    thresh = torch.randint(-40, 41, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    flip = torch.randint(0, 2, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    words = bg.binary_gemm_fused(x, b, thresh, flip, k)
    assert torch.equal(words, bg.binary_gemm_fused_plain(x, b, thresh, flip,
                                                         k))
    w_down = pack_bits(torch.randn(k, n, generator=g, device="cuda"))
    for lhs in (got, words):
        torch.testing.assert_close(
            bg.binary_gemm_packed(lhs, w_down, n),
            bg.binary_gemm_packed_plain(lhs, w_down, n), rtol=0, atol=0)


# (Hkv, G, hd): musicgen-large's MHA (32 heads of 64: two words a row) and
# deepseek-67b's / qwen2-72b's GQA (64 heads over 8: a decode step's 8 rows
# are the narrow body's edge, a 32-row chunk's 256 rows the wide one)
FAMILY_ATTENTION = [(32, 1, 64), (8, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g,hd", FAMILY_ATTENTION)
def test_cuda_attention_at_the_family_shapes(hkv, g, hd, dtype):
    """Kernels 6 and 8 at the new families' head layouts: a 4-slot decode
    step over 512 positions (lengths 1, 17, 512, 300) and a 32-row chunk
    at q_pos 96: dots equal the plain versions', outputs within TOL with
    equal signs."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    _need_card()
    q, k, v, vs = _attention_case(hkv + g, 4, 512, hkv, g, hd)
    lens = torch.tensor([1, 17, 512, 300], dtype=torch.int32)
    args = [a.cuda() for a in (q.to(dtype), k, v, vs, lens)]
    got, dots = da.decode_attention_packed(*args, return_dots=True)
    want, wdots = da.decode_attention_packed_plain(*args, return_dots=True)
    pairs = [(got, want, dots, wdots)]
    q, k, v, vs = _attention_case(hd, 1, 512, hkv, g, hd, s=32)
    args = [a.cuda() for a in (q.to(dtype), k, v, vs)]
    got, dots = pa.prefill_attention_packed(*args, 128, 96, return_dots=True)
    want, wdots = pa.prefill_attention_packed_plain(*args, 128, 96,
                                                    return_dots=True)
    pairs.append((got, want, dots, wdots))
    torch.cuda.synchronize()
    for got, want, dots, wdots in pairs:
        assert torch.equal(dots, wdots)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got >= 0, want >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-72b", "nemotron-4-15b",
                                  "musicgen-large"])
@pytest.mark.parametrize("kv_bits,chunk", [(1, 4), (0, None)])
def test_cuda_family_engine_matches_plain(arch, kv_bits, chunk):
    """The smoke qwen2-72b (QKV bias), nemotron-4-15b (LayerNorm, the
    sq_relu FFN through kernel 3) and musicgen-large (sinusoidal positions,
    GELU) served on the card through the kernels and through their plain
    versions, biases and norm parameters drawn non-zero: greedy tokens
    equal; nemotron launches kernel 3."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.packed import map_tree
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    _need_card()
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = map_tree(lambda _, p: p if p.ndim >= 2 else
                      0.02 * torch.randn(p.shape, generator=gen),
                      get_model(cfg).init(gen, device="cpu"))
    params = map_tree(lambda _, p: p.cuda(), params)
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b) for n, b in ((19, 6), (5, 9), (11, 4))]
    kw = dict(freeze=True, slots=2, max_len=32, kv_bits=kv_bits,
              prefill_chunk=chunk)
    bg.reset_launches()
    got = ServingEngine(cfg, params, **kw).generate(reqs)
    assert (bg.launches["binary_gemm_fused"] > 0) == (cfg.mlp == "sq_relu")
    want = ServingEngine(cfg, params, kernel_path="ref", **kw).generate(reqs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


# kernel 1's batched entry (the MoE experts): (E, C, K, N). dbrx-132b's
# gate|up and down at decode (C 1) and whole-prompt (C 62) capacity rows,
# llama4-scout's down at a chunk's (C 2), and ragged cases: E 3, K off a
# word (the small-M kernel at C 9), with KW % 4 != 0 (the tiles) at C 9 and
# at C 33 past the small-M edge
EXPERT_SHAPES = [(16, 1, 6144, 10752), (16, 62, 10752, 6144),
                 (16, 2, 8192, 5120), (3, 9, 1000, 77), (3, 9, 1050, 77),
                 (3, 33, 1050, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n", EXPERT_SHAPES)
def test_cuda_binary_gemm_packed_batched_matches_plain(e, c, k, n):
    """The batched kernel 1, every expert in one launch, equals its plain
    version (tolerance 0) and the 2-D kernel expert by expert; all-zero
    capacity rows (all-ones words, an empty slot's) included."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(e * c + k)
    x = torch.randn(e, c, k, generator=g, device="cuda")
    x[:, -1] = 0.0
    a = pack_bits(x)
    b = pack_bits(torch.randn(e, n, k, generator=g, device="cuda"))
    bg.reset_launches()
    got = bg.binary_gemm_packed(a, b, k)
    torch.cuda.synchronize()
    assert bg.launches["binary_gemm_packed"] == 1
    assert torch.equal(got, bg.binary_gemm_packed_plain(a, b, k))
    for i in (0, e - 1):
        assert torch.equal(got[i], bg.binary_gemm_packed(
            a[i].contiguous(), b[i].contiguous(), k))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("kv_bits,chunk,cf", [(1, 4, 8.0), (1, 4, 1.0),
                                              (0, None, 1.0)])
def test_cuda_moe_engine_matches_plain(arch, kv_bits, chunk, cf):
    """The smoke dbrx-132b and llama4-scout-17b-a16e (depth 2, 4 experts)
    served on the card through the kernels and through their plain
    versions, router and norms drawn non-zero, at the smoke capacity factor
    and at 1.0 (routes drop at decode): greedy tokens equal; each expert
    projection is one batched launch of kernel 1."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.packed import map_tree
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    _need_card()
    cfg = smoke_config(arch).scaled(capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    params = map_tree(lambda _, p: p if p.ndim >= 2 else
                      0.02 * torch.randn(p.shape, generator=gen),
                      get_model(cfg).init(gen, device="cpu"))
    params = map_tree(lambda _, p: p.cuda(), params)
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b) for n, b in ((19, 6), (5, 9), (11, 4))]
    kw = dict(freeze=True, slots=2, max_len=32, kv_bits=kv_bits,
              prefill_chunk=chunk)
    bg.reset_launches()
    got = ServingEngine(cfg, params, **kw).generate(reqs)
    assert bg.launches["binary_gemm_packed"] > 0
    want = ServingEngine(cfg, params, kernel_path="ref", **kw).generate(reqs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


# kernel 10, the selective scan: (B, T, D, N, with h0). falcon-mamba-7b's
# decode step and prefill chunk (d_inner 8192, N 16), and ragged shapes: D
# off the 32-channel block, T off the 64-step tile, N of 2 and 4
SCAN_SHAPES = [(4, 1, 8192, 16, True), (1, 32, 8192, 16, True),
               (1, 32, 8192, 16, False), (2, 7, 8200, 2, True),
               (1, 33, 8200, 4, False), (3, 1, 8200, 16, True),
               (1, 130, 70, 16, True)]


def _scan_case(seed, b, t, d, n, xi_dtype):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, d)) - 2.0))
    arrays = [dt, rng.normal(size=(b, t, d)), rng.normal(size=(b, t, n)),
              rng.normal(size=(b, t, n)),
              -np.exp(rng.normal(size=(d, n)) * 0.5),
              rng.normal(size=(b, d, n))]
    dt, xi, bm, cm, am, h0 = (_t(a.astype(np.float32)).cuda() for a in arrays)
    return dt, xi.to(xi_dtype), bm, cm, am, h0


@pytest.mark.cuda
@pytest.mark.parametrize("xi_dtype", [torch.float32, torch.bfloat16])
def test_cuda_selective_scan_matches_plain(xi_dtype):
    """Kernel 10 against its plain version on the card (both take the CUDA
    double exp), tolerance 0: y and h_final equal bit for bit."""
    from repro_torch.kernels import selective_scan as ss
    _need_card()
    for b, t, d, n, with_h0 in SCAN_SHAPES:
        dt, xi, bm, cm, am, h0 = _scan_case(b * t + d + n, b, t, d, n,
                                            xi_dtype)
        h0 = h0 if with_h0 else None
        y, h = ss.selective_scan(dt, xi, bm, cm, am, h0)
        torch.cuda.synchronize()
        yr, hr = ss.selective_scan_plain(dt, xi, bm, cm, am, h0)
        assert torch.equal(y, yr), (b, t, d, n)
        assert torch.equal(h, hr), (b, t, d, n)


@pytest.mark.cuda
@pytest.mark.parametrize("xi_dtype", [torch.float32, torch.bfloat16])
def test_cuda_selective_scan_each_n_matches_plain(xi_dtype):
    """Kernel 10 at every N it holds, 1 to 16 (4, 2 or 1 lanes a channel,
    states past N idle), T of 1, 7 and 33 (runs of 8 steps cut short) and D
    off the 32-channel block: y and h_final equal the plain version's."""
    from repro_torch.kernels import selective_scan as ss
    _need_card()
    for n in range(1, ss.MAX_N + 1):
        for t in (1, 7, 33):
            dt, xi, bm, cm, am, h0 = _scan_case(n * 100 + t, 2, t, 70, n,
                                                xi_dtype)
            h0 = h0 if t != 7 else None
            y, h = ss.selective_scan(dt, xi, bm, cm, am, h0)
            torch.cuda.synchronize()
            yr, hr = ss.selective_scan_plain(dt, xi, bm, cm, am, h0)
            assert torch.equal(y, yr), (n, t)
            assert torch.equal(h, hr), (n, t)


@pytest.mark.cuda
def test_cuda_selective_scan_chains_and_passes_pads():
    """Two chained launches equal one over the concatenated steps; dt = 0
    steps leave h_final equal to the state before them, bit for bit; an N
    the kernel does not hold raises, with no fallback."""
    from repro_torch.kernels import selective_scan as ss
    _need_card()
    dt, xi, bm, cm, am, h0 = _scan_case(0, 2, 100, 8200, 16, torch.float32)
    y, h = ss.selective_scan(dt, xi, bm, cm, am, h0)
    y1, h1 = ss.selective_scan(dt[:, :37].contiguous(),
                               xi[:, :37].contiguous(),
                               bm[:, :37].contiguous(),
                               cm[:, :37].contiguous(), am, h0)
    y2, h2 = ss.selective_scan(dt[:, 37:].contiguous(),
                               xi[:, 37:].contiguous(),
                               bm[:, 37:].contiguous(),
                               cm[:, 37:].contiguous(), am, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)
    dt_pad = dt.clone()
    dt_pad[:, 37:] = 0.0
    _, hp = ss.selective_scan(dt_pad, xi, bm, cm, am, h0)
    assert torch.equal(hp, h1)
    wide = torch.zeros(2, 100, 17, device="cuda")
    with pytest.raises(ValueError, match="N=17"):
        ss.selective_scan(dt, xi, wide, wide, torch.zeros(8200, 17,
                                                          device="cuda"), None)


# ---------------------------------------------------------------------------
# The vlm family (llama-3.2-vision-11b): the image K/V GEMM, the image
# pack, and the cross-attention over the image rows
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 200, 1600])
def test_cuda_binary_gemm_packed_at_the_image_kv(m):
    """Kernel 1 on the image's words at K 1,280 (40 words, KW % 4 == 0 but
    not a multiple of 64 words) and N 1,024, past the small-M edge (the
    int8 tiles): equal to its plain version, one launch."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m)
    a = pack_bits(torch.randn(m, 1280, generator=g, device="cuda"))
    b = pack_bits(torch.randn(1024, 1280, generator=g, device="cuda"))
    bg.reset_launches()
    got = bg.binary_gemm_packed(a, b, 1280)
    torch.cuda.synchronize()
    assert bg.launches["binary_gemm_packed"] == 1
    assert torch.equal(got, bg.binary_gemm_packed_plain(a, b, 1280))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pack_bits_at_the_image_width(dtype):
    """Kernel 5 packing 1,600 image rows of 1,280 (whole 16-byte loads),
    -0.0 and NaN among them, and their K|V rows (Hkv 8, hd 128) into slot 2
    of a 4-slot image cache: equal to the plain version bit for bit."""
    from repro_torch.kernels import pack as pk
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1600, 1280, generator=g, device="cuda").to(dtype)
    x.view(-1)[1::17] = -0.0
    x.view(-1)[2::19] = float("nan")
    got = pk.pack_bits_kernel(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.pack_bits_plain(x))
    srcs = [torch.randn(1600, 8, 128, generator=g, device="cuda").to(dtype)
            for _ in range(2)]
    rows = torch.arange(2 * 1600, 3 * 1600, device="cuda")
    pools = [torch.zeros(4, 1600, 8, 4, dtype=torch.int32, device="cuda")
             for _ in range(4)]
    pk.pack_rows_into(srcs, pools[:2], rows)
    pk.pack_rows_into_plain(srcs, pools[2:], rows)
    torch.cuda.synchronize()
    assert torch.equal(pools[0], pools[2]) and torch.equal(pools[1], pools[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hkv,g,hd", [(1, 32, 1600, 8, 4, 128),
                                            (2, 7, 45, 2, 1, 33),
                                            (3, 1, 1600, 8, 4, 128)])
def test_cuda_prefill_attention_non_causal_matches_plain(dtype, b, s, t, hkv,
                                                         g, hd):
    """Kernel 8 with causal=False (the cross-attention of a chunk: every
    row sees all kv_len positions): dots equal, outputs within TOL with
    equal signs, q_pos ignored (0 and 20 equal); a one-row chunk equals
    kernel 6's decode over the same length bit for bit."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    _need_card()
    q, k, v, vs = (a.cuda() for a in _attention_case(s + t, b, t, hkv, g, hd,
                                                     s))
    q = q.to(dtype)
    got, dots = pa.prefill_attention_packed(q, k, v, vs, t, 0, causal=False,
                                            return_dots=True)
    want, wdots = pa.prefill_attention_packed_plain(q, k, v, vs, t, 0,
                                                    causal=False,
                                                    return_dots=True)
    moved = pa.prefill_attention_packed(q, k, v, vs, t, 20, causal=False)
    served = pa.prefill_attention_packed(q, k, v, vs, t, 0, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(dots, wdots)
    tol = TOL[dtype]
    torch.testing.assert_close(served.float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(served >= 0, want >= 0)
    assert torch.equal(moved, served) and torch.equal(got, served)
    for i in range(s):
        row = q[:, i:i + 1].contiguous()
        assert torch.equal(
            pa.prefill_attention_packed(row, k, v, vs, t, 0, causal=False),
            da.decode_attention_packed(row, k, v, vs, t))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits,chunk,page", [(1, 4, None), (0, None, None),
                                                (1, 4, 4)])
def test_cuda_vlm_engine_matches_plain(kv_bits, chunk, page):
    """The smoke llama-3.2-vision-11b (two groups of a cross block and four
    self blocks, norms and gates drawn non-zero) served on the card with an
    image per request, through the kernels and through their plain
    versions: greedy tokens equal; at kv_bits=1 kernels 6 and 8 run for the
    cross-attention."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.packed import map_tree
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Request, ServingEngine
    _need_card()
    cfg = smoke_config("llama-3.2-vision-11b")
    gen = torch.Generator().manual_seed(0)
    params = map_tree(lambda name, p: p if p.ndim >= 2 else
                      (1.0 if name == "gate" else 0.02)
                      * torch.randn(p.shape, generator=gen),
                      get_model(cfg).init(gen, device="cpu"))
    params = map_tree(lambda _, p: p.cuda(), params)
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b, img_emb=rng.standard_normal(
                        (cfg.n_img_tokens, cfg.d_vision)).astype(np.float32))
            for n, b in ((19, 6), (5, 9), (11, 4))]
    kw = dict(freeze=True, slots=2, max_len=32, kv_bits=kv_bits,
              prefill_chunk=chunk, page_size=page)
    da.reset_launches()
    pa.reset_launches()
    got = ServingEngine(cfg, params, **kw).generate(reqs)
    assert (da.launches["decode_attention_packed"] > 0) == (kv_bits == 1)
    assert (pa.launches["prefill_attention_packed"] > 0) == (kv_bits == 1)
    want = ServingEngine(cfg, params, kernel_path="ref", **kw).generate(reqs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the LM trainer on the card
# ---------------------------------------------------------------------------
TRAIN_REL = 5e-5        # tests/test_torch_lm_train.py's GRAD_REL


def _smoke_step(arch, dev, params, batch):
    """One make_train_step step (S-AdaMax at lr 1e-3) of the smoke config on
    `dev` from `params`: (params, opt state, gradients, loss)."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import Optimizer, tree_map
    from repro_torch.train.step import default_optimizer, make_train_step
    cfg = smoke_config(arch)
    opt = default_optimizer(cfg, 1e-3)
    seen = {}

    def update(g, s, p, donate=False):
        seen["g"] = tree_map(torch.clone, g)
        return opt.update(g, s, p)
    to = (lambda t: t.to(dev))
    p = tree_map(to, params)
    p2, st, m = make_train_step(get_model(cfg), Optimizer(opt.init, update))(
        p, opt.init(p), {k: to(v) for k, v in batch.items()})
    return p2, st, seen["g"], float(m["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "falcon-mamba-7b"])
def test_cuda_train_step_matches_cpu(arch):
    """The smoke config's train step on the card and on the CPU from the
    same params and batch: loss, gradients and moments within TRAIN_REL of
    each tensor's largest magnitude, params held through the moments."""
    from _torch_moments import first_step_scale, held_through_moments
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.ap2 import ap2_exponent
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import tree_leaves
    _need_card()
    cfg = smoke_config(arch)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    runs = [_smoke_step(arch, d, params, {"tokens": tokens})
            for d in ("cuda", "cpu")]
    (pg, sg, gg, lg), (pc, sc, gc, lc) = runs
    assert lg == pytest.approx(lc, rel=1e-5, abs=0)
    for a, b in zip(tree_leaves((gg, sg.m, sg.u)), tree_leaves((gc, sc.m, sc.u)),
                    strict=True):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).abs().max()) <= TRAIN_REL * float(b.abs().max())
    e = (lambda s: [ap2_exponent(1.0 / (u.cpu() + 1e-8)).numpy()
                    for u in tree_leaves(s.u)])
    npl = (lambda t: [x.cpu().numpy() for x in tree_leaves(t)])
    held_through_moments(npl(pg), npl(pc), npl(sg.m), npl(sc.m), e(sg), e(sc),
                         TRAIN_REL, first_step_scale(1e-3))


@pytest.mark.cuda
def test_cuda_trainer_resumes_bit_exact(tmp_path):
    """Six steps straight against three, a restart, and three more, on the
    card: final params and optimizer state and the losses bit for bit."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.optim.base import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer
    _need_card()
    cfg = smoke_config("dbrx-132b")
    tc = (lambda d, n: TrainConfig(steps=n, global_batch=4, seq_len=32,
                                   ckpt_every=3, ckpt_dir=str(tmp_path / d),
                                   log_every=1, lr=1e-2))
    straight = Trainer(cfg, tc("a", 6))
    out = straight.run()
    Trainer(cfg, tc("b", 3)).run()
    resumed = Trainer(cfg, tc("b", 6))
    out2 = resumed.run()
    assert [h["loss"] for h in out["history"][3:]] == \
        [h["loss"] for h in out2["history"]]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((straight.params, straight.opt_state)),
        tree_leaves((resumed.params, resumed.opt_state)), strict=True))


@pytest.mark.cuda
def test_cuda_selective_scan_refuses_inputs_that_require_a_gradient():
    from repro_torch.kernels import selective_scan as ss
    _need_card()
    b, t, d, n = 1, 4, 64, 16
    dt = torch.rand(b, t, d, device="cuda", requires_grad=True)
    args = (torch.randn(b, t, d, device="cuda"),
            torch.randn(b, t, n, device="cuda"),
            torch.randn(b, t, n, device="cuda"),
            -torch.rand(d, n, device="cuda"))
    ss.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ss.selective_scan(dt, *args)
    assert ss.launches["selective_scan"] == 0
    with torch.no_grad():
        y, _ = ss.selective_scan(dt, *args)
    assert ss.launches["selective_scan"] == 1 and not y.requires_grad


@pytest.mark.cuda
def test_cuda_restored_packed_checkpoint_serves_through_the_kernels(tmp_path):
    """Two train steps of the smoke phi3-medium-14b on the card, the masters
    saved with packed_binary=True and restored as PackedWeights: served
    chunked at kv_bits=1 through the kernels, greedy tokens equal the plain
    versions' and an engine's on freeze(masters)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.packed import PackedWeight
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import pack as pk
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.train.trainer import TrainConfig, Trainer
    _need_card()
    cfg = smoke_config("phi3-medium-14b")
    tr = Trainer(cfg, TrainConfig(steps=2, global_batch=4, seq_len=32,
                                  ckpt_dir=str(tmp_path / "run")))
    tr.run()
    mgr = CheckpointManager(tmp_path / "packed", async_save=False)
    mgr.save(2, tr.params, packed_binary=True)
    packed = mgr.restore(2, tr.params)
    assert isinstance(packed["blocks"]["attn"]["wq"], PackedWeight)
    assert packed["blocks"]["attn"]["wq"].packed.is_cuda
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b) for n, b in ((19, 6), (5, 9), (11, 4))]
    kw = dict(slots=2, max_len=32, kv_bits=1, prefill_chunk=4)
    scfg = cfg.scaled(kv_bits=1)
    bg.reset_launches()
    pk.reset_launches()
    got = ServingEngine(scfg, packed, **kw).generate(reqs)
    assert bg.launches["binary_gemm_packed"] > 0
    assert pk.launches["pack_bits"] > 0
    plain = ServingEngine(scfg, packed, kernel_path="ref", **kw).generate(reqs)
    frozen = ServingEngine(scfg, tr.params, freeze=True, **kw).generate(reqs)
    for a, b, c in zip(got, plain, frozen, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# the serving lifecycle on the card (tests/test_torch_faults.py and
# tests/test_torch_engine_lifecycle.py hold it to the JAX package)
# ---------------------------------------------------------------------------
def _lifecycle_params(arch="phi3-medium-14b"):
    """Smoke params on the card, norms drawn non-zero."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.packed import map_tree
    from repro_torch.models.api import get_model
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = map_tree(lambda _, p: p if p.ndim >= 2 else
                      0.02 * torch.randn(p.shape, generator=gen),
                      get_model(cfg).init(gen, device="cpu"))
    return cfg, map_tree(lambda _, p: p.cuda(), params)


def _lifecycle_requests(cfg, lens_budgets, seed=1):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=b) for n, b in lens_budgets]


@pytest.mark.cuda
def test_cuda_faulted_run_survivors_equal_the_fault_free_run():
    """The paged kv_bits=1 engine with the prefix cache and the watchdog,
    through the kernels, under a plan arming every single-device site (a
    retried burst, a stall, a NaN and a poisoned admission, two exhausted
    allocs, a corrupted tree) and a blocking queue of 2: every rid resolves
    once, survivors' tokens equal the fault-free run's and the plain
    versions' bit for bit, the pool audits clean."""
    import dataclasses
    import time
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import parse_plan
    _need_card()
    cfg, params = _lifecycle_params()
    reqs = _lifecycle_requests(cfg, [(9, 4), (13, 3), (5, 5), (8, 2),
                                     (12, 4), (6, 3), (10, 2), (7, 4)])
    kw = dict(freeze=True, slots=2, max_len=32, kv_bits=1, prefill_chunk=4,
              page_size=4, prefix_cache=True, check_invariants=True)
    clean = ServingEngine(cfg, params, **kw).generate(reqs)
    plain = ServingEngine(cfg, params, kernel_path="ref", **kw).generate(reqs)
    for a, b in zip(clean, plain, strict=True):
        np.testing.assert_array_equal(a, b)
    plan = parse_plan("device_error@burst:1*2,slow@burst:3:0.01,"
                      "nan@admit:1,poison@admit:4,exhaust@alloc:3*2,"
                      "corrupt@audit:2")
    eng = ServingEngine(cfg, params, fault_plan=plan, queue_cap=2,
                        overflow="block", backoff_s=0.001, **kw)
    sched = eng.scheduler()
    late = {2, 6}
    timed = [dataclasses.replace(r, deadline_s=0.001) if i in late else r
             for i, r in enumerate(reqs)]
    da.reset_launches()
    pa.reset_launches()
    rids = []
    for i, r in enumerate(timed):
        rids.append(sched.submit(r))
        if i in late:
            time.sleep(0.02)            # its deadline passes in the queue
    comps = sched.run()
    assert sorted(comps) == sorted(rids)
    statuses = [comps[r].status for r in rids]
    assert statuses.count("shed") == 2 and statuses.count("error") == 2
    for i, r in enumerate(rids):
        if comps[r].status == "completed":
            np.testing.assert_array_equal(comps[r].tokens, clean[i])
    assert sched.stats["burst_retries"] == 2
    assert sched.stats["invariant_violations"] == 1 and not sched._use_tree
    assert {k for _, _, k in plan.fired} == {"device_error", "slow", "nan",
                                              "poison", "exhaust", "corrupt"}
    assert da.launches["decode_attention_packed_paged"] > 0
    assert pa.launches["prefill_attention_packed_paged"] > 0
    assert sched.audit() == []


@pytest.mark.cuda
def test_cuda_freeze_kv_bits_equals_a_fresh_packed_engine():
    """freeze(kv_bits=1) on a live float-cache engine on the card gives a
    fresh kv_bits=1 engine's tokens, through kernels 6 and 8."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.serving.engine import ServingEngine
    _need_card()
    cfg, params = _lifecycle_params()
    reqs = _lifecycle_requests(cfg, [(19, 6), (5, 9), (11, 4)])
    kw = dict(freeze=True, slots=2, max_len=32, prefill_chunk=4)
    eng = ServingEngine(cfg, params, kv_bits=0, **kw)
    eng.generate(reqs)
    eng.freeze(kv_bits=1)
    da.reset_launches()
    pa.reset_launches()
    got = eng.generate(reqs)
    assert da.launches["decode_attention_packed"] > 0
    assert pa.launches["prefill_attention_packed"] > 0
    want = ServingEngine(cfg, params, kv_bits=1, **kw).generate(reqs)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_whole_prompt_admission_ignores_stale_nan_v():
    """The default engine on the card (whole prompt, float cache): NaN in
    every slot's V rows past the next prompt, left by earlier requests,
    does not reach that prompt's tokens."""
    from repro_torch.serving.engine import ServingEngine
    _need_card()
    cfg, params = _lifecycle_params()
    first = _lifecycle_requests(cfg, [(20, 4), (22, 4)])
    (nxt,) = _lifecycle_requests(cfg, [(7, 6)], seed=2)
    eng = ServingEngine(cfg, params, freeze=True, slots=2, max_len=32)
    eng.generate(first)
    eng.scheduler()._cache["v"][..., 7:, :, :] = float("nan")
    got = eng.serve([nxt])[0]
    assert got.status == "completed", got.error
    want = ServingEngine(cfg, params, freeze=True, slots=2,
                         max_len=32).generate([nxt])[0]
    np.testing.assert_array_equal(got.tokens, want)


# ---------------------------------------------------------------------------
# The route table on the card (kernels/tune.py; tests/test_torch_tune.py
# holds its CPU side to the JAX package's)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_route_table_covers_the_standard_buckets():
    """The card's committed table, named from the device, covers both
    lists of standard buckets with `cuda` routes only."""
    from repro_torch.kernels import tune
    _need_card()
    assert tune.cache_path().name != "cpu.json"
    assert tune.missing() == []
    table = tune.load_cache()
    assert table["_meta"]["device"] == torch.cuda.get_device_name(0)
    for kernel in tune.KERNELS:
        for key, entry in table.get(kernel, {}).items():
            assert entry["route"] == "cuda", (kernel, key)
    for kernel, shapes in tune.standard_shapes().items():
        for shape in shapes:
            route, params = tune.get_route(kernel, **shape)
            assert route == "cuda" and params


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["binary_gemm", "binary_gemm_fused",
                                    "decode_attention", "prefill_attention",
                                    "decode_attention_paged",
                                    "prefill_attention_paged"])
def test_cuda_route_table_winners_equal_plain_on_ragged_shapes(kernel):
    """Every JAX standard bucket's winner, launched through dispatch (route
    None) at a ragged shape inside the bucket with K off a word, equals the
    plain version: GEMMs bit for bit, attention dots bit for bit and
    outputs within the kernel checks' tolerance with equal signs."""
    from repro_torch.kernels import tune
    _need_card()
    for shape in tune.STANDARD_SHAPES[kernel]:
        for cut in (shape, tune.ragged(shape)):
            _, check, _ = tune.problem(kernel, cut, k_short=7)
            check(None, {})
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_a_miss_launches_the_fixed_rule():
    """A bucket the table lacks, and every route pinned by
    `route_override`, launch exactly `gemm_plan`'s / `attention_plan`'s
    plan."""
    from repro_torch._device import sm_count
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import tune
    _need_card()
    sms = sm_count(torch.device("cuda"))
    kn, m, n, k = "binary_gemm_packed_rhs", 3, 1000, 3 * 32 * 1024 - 5
    assert tune.bucket_key(dict(m=m, n=n, kw=-(-k // 32), pl=0)) not in \
        tune.load_cache().get("binary_gemm", {})
    tune.forget_plans()
    assert bg.routed_plan(kn, m, n, k, sms, True, torch.bfloat16) == \
        bg.gemm_plan(kn, m, n, k, sms)
    with tune.route_override(binary_gemm="cuda", decode_attention="cuda"):
        for kn, m, n, k in (("binary_gemm_packed", 4, 1280, 5120),
                            ("binary_gemm_packed_rhs", 32, 5120, 17920)):
            lhs = torch.int32 if kn == "binary_gemm_packed" \
                else torch.bfloat16
            assert bg.routed_plan(kn, m, n, k, sms, True, lhs) == \
                bg.gemm_plan(kn, m, n, k, sms)
        assert pa.routed_plan("decode_attention", 4, 1, 512, 10, 4, 128, sms,
                              None, {}) == \
            pa.attention_plan(4, 1, 512, 10, 4, 128, sms)
    with pytest.raises(ValueError, match="launches no kernel"):
        with tune.route_override(binary_gemm="xla"):
            bg.routed_plan(kn, m, n, k, sms, True, torch.bfloat16)


# ---------------------------------------------------------------------------
# serving over a mesh on the card (tests/test_torch_mesh_serving.py,
# tests/test_torch_sharded_kernels.py and tests/test_torch_replica.py hold
# the same paths on repeated CPU devices)
# ---------------------------------------------------------------------------
def _card_mesh(data, model=1):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(data, model,
                             devices=[torch.device("cuda", 0)] * (data * model))


def _launch_counts():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    return {**bg.launches, **da.launches, **pa.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 4])
def test_cuda_gemm_tp_equals_the_unsharded_launch(parts):
    """binary_gemm_tp / binary_gemm_fused_tp on `parts` shards of one card:
    dots and words bit for bit against the unsharded launch, one launch
    per shard."""
    from repro_torch.kernels import sharded as S
    _need_card()
    mesh = _card_mesh(1, parts)
    for m, k, n in ((4, 5120, 5120), (32, 17920, 5120), (9, 300, 256)):
        x, w, thresh, flip = _case(m + n, m, k, n)
        b = pack_bits(_t(w.T)).cuda()
        for lhs in (_t(x).cuda(), pack_bits(_t(x)).cuda()):
            before = dict(_launch_counts())
            got = S.binary_gemm_tp(lhs, b, k, mesh=mesh)
            after = _launch_counts()
            assert sum(after.values()) - sum(before.values()) == parts
            np.testing.assert_array_equal(
                got.cpu(), bg.dispatch_binary_gemm(lhs, b, k).cpu())
            args = (lhs, b, _t(thresh).cuda(), _t(flip).cuda(), k)
            np.testing.assert_array_equal(
                S.binary_gemm_fused_tp(*args, mesh=mesh).cpu(),
                bg.dispatch_binary_gemm_fused(*args).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 5])
def test_cuda_attention_tp_equals_the_unsharded_launch(parts):
    """The four attention wrappers at phi3's heads (Hkv 10, G 4, hd 128)
    over `parts` shards of one card: dots bit for bit against the
    unsharded launch, outputs too with both pinned to one T split, one
    launch per shard."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import sharded as S
    _need_card()
    mesh = _card_mesh(1, parts)
    gen = torch.Generator().manual_seed(parts)
    b, t, hkv, g, hd, ps, s = 4, 512, 10, 4, 128, 32, 32
    kw = packed_width(hd)
    words = lambda *shape: torch.randint(  # noqa: E731
        -2 ** 31, 2 ** 31 - 1, shape, generator=gen, dtype=torch.int32).cuda()
    kc, vc = words(b, t, hkv, kw), words(b, t, hkv, kw)
    pool = b * (t // ps)
    kp, vp = words(pool, ps, hkv, kw), words(pool, ps, hkv, kw)
    table = torch.randperm(pool, generator=gen).reshape(b, t // ps) \
        .to(torch.int32).cuda()
    vs = torch.rand(b, hkv, generator=gen).cuda() + 0.5
    lens = torch.tensor([512, 300, 17, 1], dtype=torch.int32).cuda()
    q1 = torch.randn(b, 1, hkv * g, hd, generator=gen).cuda()
    qs = torch.randn(b, s, hkv * g, hd, generator=gen).cuda()
    pos = (lens - s).clamp(min=0)
    cases = [(da.decode_attention_packed, S.decode_attention_packed_tp,
              (q1, kc, vc, vs, lens)),
             (da.decode_attention_packed_paged,
              S.decode_attention_packed_paged_tp, (q1, kp, vp, vs, table,
                                                   lens)),
             (pa.prefill_attention_packed, S.prefill_attention_packed_tp,
              (qs, kc, vc, vs, pos + s, pos)),
             (pa.prefill_attention_packed_paged,
              S.prefill_attention_packed_paged_tp,
              (qs, kp, vp, vs, table, pos + s, pos))]
    for kernel, tp, args in cases:
        before = sum(_launch_counts().values())
        got, dots = tp(*args, mesh=mesh, return_dots=True)
        assert sum(_launch_counts().values()) - before == parts
        want, want_dots = kernel(*args, return_dots=True)
        np.testing.assert_array_equal(dots.cpu(), want_dots.cpu())
        np.testing.assert_allclose(got.cpu(), want.cpu(), atol=1e-6,
                                   rtol=1e-6)
        pinned = dict(route="cuda", split=1)
        np.testing.assert_array_equal(
            tp(*args, mesh=mesh, **pinned).cpu(),
            kernel(*args, **pinned).cpu())


@pytest.mark.cuda
def test_cuda_mesh_engine_equals_one_device():
    """A smoke phi3 engine on a 2 x 2 mesh of one card, chunked kv_bits=1
    and paged + prefix at data=4: tokens (greedy and sampled) equal the
    single-device engine's, through the kernels."""
    from repro_torch.serving.engine import ServingEngine
    _need_card()
    cfg, params = _lifecycle_params()
    reqs = _lifecycle_requests(cfg, [(7, 6), (12, 5), (3, 8), (9, 4), (5, 7)])
    reqs[1].temperature = 0.8
    for mesh, extra in ((_card_mesh(2, 2), {}),
                        (_card_mesh(4), dict(page_size=4,
                                             prefix_cache=True))):
        kw = dict(freeze=True, kv_bits=1, prefill_chunk=4, slots=4,
                  max_len=32, seed=3, **extra)
        want = ServingEngine(cfg, params, **kw).generate(reqs)
        got = ServingEngine(cfg, params, mesh=mesh, **kw).generate(reqs)
        for a, b in zip(want, got, strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_two_replicas_on_one_card():
    """Two replicas on cuda:0 give one engine's greedy tokens; replica 0
    killed at its second poll fails over with the same tokens."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.replica import ReplicaServer
    _need_card()
    cfg, params = _lifecycle_params()
    reqs = _lifecycle_requests(cfg, [(7, 6), (12, 5), (3, 8), (9, 4), (5, 7)])
    kw = dict(freeze=True, kv_bits=1, prefill_chunk=4, slots=2, max_len=32)
    want = ServingEngine(cfg, params, **kw).generate(reqs)
    for plan in (None, FaultPlan([Fault("death", "replica0", 1)])):
        srv = ReplicaServer(cfg, params, devices=["cuda:0"] * 2,
                            fault_plan=plan, backoff_s=0.001, **kw)
        for a, b in zip(want, srv.generate(reqs), strict=True):
            np.testing.assert_array_equal(a, b)
        assert srv.health == ([True, True] if plan is None
                              else [False, True])


@pytest.mark.cuda
def test_cuda_mesh_admission_launches_the_table_route():
    """A 2 x 2 mesh of one card admits through the route table as one
    device does: no route pin is on while a shard prefills, and every
    chunk launches kernel 8."""
    import dataclasses
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import tune
    from repro_torch.serving.engine import ServingEngine
    _need_card()
    cfg, params = _lifecycle_params()
    reqs = _lifecycle_requests(cfg, [(7, 6), (12, 5), (3, 8), (9, 4)])
    eng = ServingEngine(cfg, params, freeze=True, kv_bits=1, prefill_chunk=4,
                        slots=4, max_len=32, mesh=_card_mesh(2, 2))
    sched, pins = eng.scheduler(), []
    real = sched.model.prefill_chunk

    def chunk(*a, **kw):
        pins.append(dict(tune._ROUTE_OVERRIDE))
        return real(*a, **kw)
    sched.model = dataclasses.replace(sched.model, prefill_chunk=chunk)
    before = pa.launches["prefill_attention_packed"]
    eng.generate(reqs)
    assert pins and all(p == {} for p in pins)
    assert pa.launches["prefill_attention_packed"] - before \
        == len(pins) * cfg.n_layers


# ---------------------------------------------------------------------------
# training over a mesh of the card (tests/test_torch_mesh_train.py's and
# tests/test_torch_compressed.py's twins)
# ---------------------------------------------------------------------------
def _mesh_step(cfg, params, batch, mesh, gen_seed=None, accum=1,
               placed=False):
    """One port step on the card (over `mesh`, or on one device when None)
    from CPU `params`, with the gradients it took: (params, opt state,
    gradients, loss) as whole CPU tensors. `placed`: params and state
    placed by the JAX specs (the gradients are then None: the optimizer
    sees each device's pieces)."""
    from repro_torch.launch.shardings import join, param_specs, place
    from repro_torch.models.api import get_model
    from repro_torch.optim.base import Optimizer, tree_map
    from repro_torch.train.step import (
        default_optimizer, init_placed_state, make_train_step,
        state_shardings,
    )
    if placed:
        opt = default_optimizer(cfg, 1e-3)
        dev = torch.device("cuda", 0)
        specs = param_specs(params)
        p = tree_map(lambda t, sp: place(t.to(dev), mesh, sp), params, specs)
        s = init_placed_state(opt, p, mesh)
        gen = None if gen_seed is None else \
            torch.Generator(device=dev).manual_seed(gen_seed)
        step = make_train_step(get_model(cfg), opt, accum=accum, mesh=mesh,
                               specs=specs)
        p, s, m = step(p, s, {k: v.to(dev) for k, v in batch.items()}, gen)
        ssp = state_shardings(s, p, specs, ())
        p = tree_map(lambda a, sp: join(a, mesh, sp).cpu(), p, specs)
        s = tree_map(lambda a, sp: join(a, mesh, sp).cpu(), s, ssp)
        return p, s, None, float(m["loss"])
    opt = default_optimizer(cfg, 1e-3)
    seen = {}

    def update(g, s, p, donate=False):
        seen["g"] = tree_map(torch.clone, g)
        return opt.update(g, s, p)
    stash = Optimizer(opt.init, update)
    dev = torch.device("cuda", 0)
    p = tree_map(lambda t: t.to(dev), params)
    s = stash.init(p)
    gen = None if gen_seed is None else \
        torch.Generator(device=dev).manual_seed(gen_seed)
    step = make_train_step(get_model(cfg), stash, accum=accum, mesh=mesh)
    b = {k: v.to(dev) for k, v in batch.items()}
    if mesh is not None:
        rep = (lambda t: tree_map(lambda x: place(x, mesh, ()), t))
        p, s = rep(p), rep(s)
    p, s, m = step(p, s, b, gen)
    if mesh is not None:
        p, s = (tree_map(lambda a: join(a, mesh, ()), t) for t in (p, s))
    cpu = (lambda t: tree_map(lambda x: x.cpu(), t))
    return cpu(p), cpu(s), cpu(seen["g"]), float(m["loss"])


def _smoke_masters(arch, **over):
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.api import get_model
    cfg = smoke_config(arch).scaled(**over)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32))
    return cfg, params, {"tokens": tokens}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("phi3-medium-14b", {"quant": "bbp"}),
                                       ("dbrx-132b", {"capacity_factor": 1.0})])
def test_cuda_one_shard_mesh_step_is_the_single_device_step(arch, over):
    """On the card a one-shard mesh step equals the single-device step bit
    for bit (mode 'bbp' draws from a card generator; accum 2)."""
    from repro_torch.optim.base import tree_leaves
    _need_card()
    cfg, params, batch = _smoke_masters(arch, **over)
    want = _mesh_step(cfg, params, batch, None, gen_seed=4, accum=2)
    got = _mesh_step(cfg, params, batch, _card_mesh(1), gen_seed=4, accum=2)
    assert got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got[:3]), tree_leaves(want[:3]), strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("phi3-medium-14b", {"quant": "bbp"}),
                                       ("dbrx-132b", {"capacity_factor": 1.0})])
def test_cuda_mesh_step_matches_the_single_device_step(arch, over):
    """A 2 x 2 mesh of one card against one device's step: the loss,
    gradients and moments within TRAIN_REL, params held through the
    moments (the shards' float32 sums run in another order)."""
    from _torch_moments import first_step_scale, held_through_moments
    from repro_torch.core.ap2 import ap2_exponent
    from repro_torch.optim.base import tree_leaves
    _need_card()
    cfg, params, batch = _smoke_masters(arch, **over)
    pg, sg, gg, lg = _mesh_step(cfg, params, batch, _card_mesh(2, 2),
                                gen_seed=4)
    pc, sc, gc, lc = _mesh_step(cfg, params, batch, None, gen_seed=4)
    assert lg == pytest.approx(lc, rel=1e-5, abs=0)
    for a, b in zip(tree_leaves((gg, sg.m, sg.u)),
                    tree_leaves((gc, sc.m, sc.u)), strict=True):
        a, b = a.double(), b.double()
        assert float((a - b).abs().max()) <= TRAIN_REL * float(b.abs().max())
    e = (lambda s: [ap2_exponent(1.0 / (u + 1e-8)).numpy()
                    for u in tree_leaves(s.u)])
    npl = (lambda t: [x.numpy() for x in tree_leaves(t)])
    held_through_moments(npl(pg), npl(pc), npl(sg.m), npl(sc.m), e(sg), e(sc),
                         TRAIN_REL, first_step_scale(1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("phi3-medium-14b", {"quant": "bbp"}),
                                       ("dbrx-132b", {"capacity_factor": 1.0}),
                                       ("falcon-mamba-7b", {})])
def test_cuda_placed_step_matches_the_single_device_step(arch, over):
    """Params and S-AdaMax state placed by the JAX specs on a 2 x 2 mesh of
    one card (projections, vocabulary and experts over 'model', rows over
    'data') against one device's step: the loss, moments within TRAIN_REL,
    params held through the moments; on data 2 ('model' 1) the placed step
    equals the replicated one bit for bit."""
    from _torch_moments import first_step_scale, held_through_moments
    from repro_torch.core.ap2 import ap2_exponent
    from repro_torch.optim.base import tree_leaves
    _need_card()
    cfg, params, batch = _smoke_masters(arch, **over)
    pg, sg, _, lg = _mesh_step(cfg, params, batch, _card_mesh(2, 2),
                               gen_seed=4, placed=True)
    pc, sc, _, lc = _mesh_step(cfg, params, batch, None, gen_seed=4)
    assert lg == pytest.approx(lc, rel=1e-5, abs=0)
    for a, b in zip(tree_leaves((sg.m, sg.u)), tree_leaves((sc.m, sc.u)),
                    strict=True):
        a, b = a.double(), b.double()
        assert float((a - b).abs().max()) <= TRAIN_REL * float(b.abs().max())
    e = (lambda s: [ap2_exponent(1.0 / (u + 1e-8)).numpy()
                    for u in tree_leaves(s.u)])
    npl = (lambda t: [x.numpy() for x in tree_leaves(t)])
    held_through_moments(npl(pg), npl(pc), npl(sg.m), npl(sc.m), e(sg), e(sc),
                         TRAIN_REL, first_step_scale(1e-3))
    got = _mesh_step(cfg, params, batch, _card_mesh(2), gen_seed=4,
                     placed=True)
    want = _mesh_step(cfg, params, batch, _card_mesh(2), gen_seed=4)
    assert got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got[:2]), tree_leaves(want[:2]), strict=True))


@pytest.mark.cuda
def test_cuda_trainer_on_2x2_resumes(tmp_path):
    """The Trainer on a 2 x 2 mesh of the card (placed by the JAX specs): a
    run stopped after 2 steps and resumed on 2 x 2 ends bit for bit where
    a straight run does; each position holds a quarter of the sharded
    leaves."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.optim.base import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer
    _need_card()
    cfg = smoke_config("musicgen-large")
    tc = (lambda d: TrainConfig(steps=4, global_batch=8, seq_len=16,
                                ckpt_every=2, ckpt_dir=str(tmp_path / d),
                                log_every=1, lr=1e-2, keep=1))
    straight = Trainer(cfg, tc("s"), mesh=_card_mesh(2, 2))
    out = straight.run()
    killed = Trainer(cfg, tc("k"), mesh=_card_mesh(2, 2))
    orig = killed._batch

    def stop(step):
        if step == 1:
            killed._stop = True
        return orig(step)
    killed._batch = stop
    assert killed.run()["final_step"] == 2
    resumed = Trainer(cfg, tc("k"), mesh=_card_mesh(2, 2))
    out2 = resumed.run()
    assert [h["loss"] for h in out["history"][2:]] == \
        [h["loss"] for h in out2["history"]]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed.full_state()),
        tree_leaves(straight.full_state()), strict=True))
    per = resumed.resident_bytes_per_device()
    whole = sum(x.numel() * x.element_size()
                for x in tree_leaves(resumed.full_state()))
    assert len(per) == 4 and all(b["total"] < whole / 3 for b in per.values())


@pytest.mark.cuda
def test_cuda_compressed_step_tracks_dense():
    """EF-SignSGD over data 2 of the card, musicgen-large smoke, SGD(0.02),
    6 steps: each loss within 0.08 of the dense step's (the JAX package's
    bound); the residuals non-zero."""
    from repro_torch.launch.shardings import join, place
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import sgd
    from repro_torch.optim.base import tree_leaves, tree_map
    from repro_torch.train.compressed import (
        init_ef_sharded, make_compressed_train_step,
    )
    from repro_torch.train.step import make_train_step
    _need_card()
    cfg, params, _ = _smoke_masters("musicgen-large")
    mesh, opt, model = _card_mesh(2), sgd(0.02), get_model(cfg)
    p = tree_map(lambda t: t.cuda(), params)
    pd, od = tree_map(torch.clone, p), opt.init(p)
    pc = tree_map(lambda x: place(x, mesh, ()), p)
    oc = tree_map(lambda x: place(x, mesh, ()), opt.init(p))
    ef = init_ef_sharded(p, mesh)
    cstep = make_compressed_train_step(model, opt, mesh)
    dstep = make_train_step(model, opt)
    rng = np.random.default_rng(0)
    for _ in range(6):
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (16, 32)).astype(np.int32)).cuda()}
        pc, oc, ef, mc = cstep(pc, oc, ef, b)
        pd, od, md = dstep(pd, od, b)
        assert abs(float(mc["loss"]) - float(md["loss"])) < 0.08
    assert sum(float(join(e, mesh, ("data",)).abs().sum())
               for e in tree_leaves(ef)) > 0


@pytest.mark.cuda
def test_cuda_trainer_on_a_mesh_resumes(tmp_path):
    """The Trainer on data 2 of the card: a run stopped after 2 steps and
    resumed on data 2 ends bit for bit where a straight run does; resumed
    on one device it restores every leaf byte for byte."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.optim.base import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer
    _need_card()
    cfg = smoke_config("musicgen-large")
    tc = (lambda d: TrainConfig(steps=4, global_batch=8, seq_len=16,
                                ckpt_every=2, ckpt_dir=str(tmp_path / d),
                                log_every=1, lr=1e-2, keep=1))
    straight = Trainer(cfg, tc("s"), mesh=_card_mesh(2))
    out = straight.run()
    killed = Trainer(cfg, tc("k"), mesh=_card_mesh(2))
    orig = killed._batch

    def stop(step):
        if step == 1:
            killed._stop = True
        return orig(step)
    killed._batch = stop
    assert killed.run()["final_step"] == 2
    shutil.copytree(tmp_path / "k", tmp_path / "one")
    saved = CheckpointManager(tmp_path / "k").restore(
        2, straight.full_state(), device="cpu")
    resumed = Trainer(cfg, tc("k"), mesh=_card_mesh(2))
    out2 = resumed.run()
    assert [h["loss"] for h in out["history"][2:]] == \
        [h["loss"] for h in out2["history"]]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed.full_state()),
        tree_leaves(straight.full_state()), strict=True))
    one = Trainer(cfg, tc("one"), device="cuda")
    assert one.maybe_restore()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(one.full_state()), tree_leaves(saved), strict=True))
