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
