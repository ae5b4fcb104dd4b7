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

from repro_torch.core.bitpack import pack_bits
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


# ---------------------------------------------------------------------------
# Kernels A (sign-pack), B (decode attention), C (prefill attention)
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
    zero = da.decode_attention_packed(*args[:4], 0)
    assert (zero == 0).all()


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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    _need_card()
    q, k, v, vs = [a.cuda() for a in _attention_case(1, 3, 50, 2, 4, 64)]
    lens = torch.tensor([1, 20, 50], dtype=torch.int32, device="cuda")
    dec = da.decode_attention_packed(q, k, v, vs, lens, window=4)
    pre = pa.prefill_attention_packed(q, k, v, vs, lens, lens - 1, window=4)
    torch.cuda.synchronize()
    assert torch.equal(dec, pre)
