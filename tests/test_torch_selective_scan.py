"""The port's selective scan (kernel 10's plain version,
`repro_torch.kernels.ref.selective_scan_ref`, and its wrapper) against the
JAX package's: the Pallas kernel `repro.kernels.selective_scan` in
interpret mode, as tests/test_selective_scan.py runs it, on that file's
shapes with float32 and bf16 inputs, and the scan the JAX Mamba block runs,
`repro.models.ssm._mamba_chunk_scan`, with and without an initial state.

Tolerance against JAX: 1e-6 of each output's largest magnitude (about 8
float32 ulps). The two sides compute the same recurrence in another order:
JAX takes exp in float32, the port in float64 rounded once to float32 (an
ulp apart at some steps), and JAX sums y_t over the N states in its
einsum's order, the port in sequence. Inputs come from numpy seeds.

Within the port the plain version is exact in itself: chained calls equal
one call, and dt = 0 steps (the chunk pads) leave the state bit for bit.
tests/test_torch_cuda.py holds the CUDA kernel to this plain version with
tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as jax_selective_scan
from repro.models.ssm import _mamba_chunk_scan
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.ref import selective_scan_ref

from _torch_parity import assert_rel

REL = 1e-6

# tests/test_selective_scan.py's shapes: b, t, d, n, bd, bt (the Pallas
# kernel's block shapes; the port's scan has none)
CASES = [
    (2, 16, 8, 4, 8, 8),
    (1, 33, 16, 4, 8, 16),      # ragged T
    (2, 64, 32, 8, 32, 16),
    (1, 7, 8, 2, 8, 32),        # T < block
    (3, 24, 24, 4, 8, 8),       # several channel blocks
]


def _inputs(seed, b, t, d, n):
    """dt = 0.1 * softplus(normal) > 0, xi/B/C normal, A = -exp(0.3
    normal) < 0, h0 normal: float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.normal(size=(b, t, d)))) * 0.1)
    return {"dt": dt.astype(np.float32),
            "xi": rng.normal(size=(b, t, d)).astype(np.float32),
            "bm": rng.normal(size=(b, t, n)).astype(np.float32),
            "cm": rng.normal(size=(b, t, n)).astype(np.float32),
            "am": (-np.exp(rng.normal(size=(d, n)) * 0.3)).astype(np.float32),
            "h0": rng.normal(size=(b, d, n)).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("b,t,d,n,bd,bt", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_jax_kernel(b, t, d, n, bd, bt, dtype):
    """The Pallas kernel in interpret mode against the plain scan on the
    same (bf16-rounded, for bf16) values; xi reaches the port as bf16."""
    x = _inputs(b * t * d + n, b, t, d, n)
    jdt = getattr(jnp, dtype)
    dt, xi, bm, cm = (jnp.asarray(x[k]).astype(jdt)
                      for k in ("dt", "xi", "bm", "cm"))
    y, h = jax_selective_scan(dt, xi, bm, cm, jnp.asarray(x["am"]), bd=bd,
                              bt=bt)
    xi_t = _t(xi.astype(jnp.float32)).to(getattr(torch, dtype))
    py, ph = selective_scan_ref(_t(dt.astype(jnp.float32)), xi_t,
                                _t(bm.astype(jnp.float32)),
                                _t(cm.astype(jnp.float32)), _t(x["am"]))
    assert_rel(py.numpy(), np.asarray(y), REL, "y")
    assert_rel(ph.numpy(), np.asarray(h), REL, "h")


@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_scan_matches_mamba_chunk_scan(with_h0):
    """`_mamba_chunk_scan(bp, ..., h0=)`, the function the JAX main path
    computes (chunk 8 over T = 20: a padded last chunk), with A = -exp(A_log)
    taken from the same A_log on both sides."""
    b, t, d, n = 2, 20, 16, 4
    x = _inputs(7, b, t, d, n)
    a_log = np.random.default_rng(8).normal(size=(d, n)).astype(np.float32) * 0.3
    h0 = x["h0"] if with_h0 else None
    y, h = _mamba_chunk_scan(
        {"A_log": jnp.asarray(a_log)}, jnp.asarray(x["dt"]),
        jnp.asarray(x["xi"]), jnp.asarray(x["bm"]), jnp.asarray(x["cm"]),
        chunk=8, h0=None if h0 is None else jnp.asarray(h0))
    am = -torch.exp(_t(a_log))
    py, ph = selective_scan_ref(_t(x["dt"]), _t(x["xi"]), _t(x["bm"]),
                                _t(x["cm"]), am,
                                None if h0 is None else _t(h0))
    assert_rel(py.numpy(), np.asarray(y), REL, "y")
    assert_rel(ph.numpy(), np.asarray(h), REL, "h")


def test_chained_calls_equal_one_call():
    """Scanning T1 steps, then T2 more from the state it left, gives the
    outputs and final state of one scan over T1 + T2, bit for bit (more
    than the plain version's 64-step output blocks, to cross one)."""
    b, t, d, n = 2, 150, 12, 3
    x = {k: _t(v) for k, v in _inputs(3, b, t, d, n).items()}
    y, h = selective_scan_ref(x["dt"], x["xi"], x["bm"], x["cm"], x["am"],
                              x["h0"])
    def steps(s, h0):
        return selective_scan_ref(x["dt"][:, s], x["xi"][:, s], x["bm"][:, s],
                                  x["cm"][:, s], x["am"], h0)

    for cut in (1, 64, 97):
        y1, h1 = steps(slice(0, cut), x["h0"])
        y2, h2 = steps(slice(cut, t), h1)
        assert torch.equal(torch.cat([y1, y2], dim=1), y)
        assert torch.equal(h2, h)


def test_dt_zero_pads_pass_the_state_bit_for_bit():
    """Steps with dt = 0 (a = 1, input term 0), as a chunk's pads are: the
    final state equals the state after the last real step, bit for bit,
    whatever xi, B and C hold at the pads."""
    b, t, d, n, real = 2, 12, 10, 4, 5
    x = {k: _t(v) for k, v in _inputs(4, b, t, d, n).items()}
    dt = x["dt"].clone()
    dt[:, real:] = 0.0
    _, h_pad = selective_scan_ref(dt, x["xi"], x["bm"], x["cm"], x["am"],
                                  x["h0"])
    _, h_real = selective_scan_ref(x["dt"][:, :real], x["xi"][:, :real],
                                   x["bm"][:, :real], x["cm"][:, :real],
                                   x["am"], x["h0"])
    assert torch.equal(h_pad, h_real)
    _, h_none = selective_scan_ref(torch.zeros_like(dt), x["xi"], x["bm"],
                                   x["cm"], x["am"], x["h0"])
    assert torch.equal(h_none, x["h0"])


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version (no launch); it
    checks its operands and names no kernel for other devices."""
    b, t, d, n = 1, 5, 6, 3
    x = {k: _t(v) for k, v in _inputs(5, b, t, d, n).items()}
    ss.reset_launches()
    got = ss.selective_scan(x["dt"], x["xi"].to(torch.bfloat16), x["bm"],
                            x["cm"], x["am"], x["h0"])
    want = selective_scan_ref(x["dt"], x["xi"].to(torch.bfloat16), x["bm"],
                              x["cm"], x["am"], x["h0"])
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert ss.launches["selective_scan"] == 0
    args = [x["dt"], x["xi"], x["bm"], x["cm"], x["am"], x["h0"]]
    bad = [
        (0, x["dt"].double()),                        # dt not float32
        (1, x["xi"][:, :, :4]),                       # xi shape
        (2, x["bm"].transpose(0, 1).contiguous()),    # B shape
        (4, x["am"].t()),                             # A shape / layout
        (5, x["h0"][:, :, :2]),                       # h0 shape
        (3, torch.zeros(b, n, t).transpose(1, 2)),    # C not contiguous
    ]
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises((TypeError, ValueError)):
            ss.selective_scan(*call)
    with pytest.raises(ValueError, match="no selective-scan kernel"):
        ss.selective_scan(*(a.to("meta") for a in args))
