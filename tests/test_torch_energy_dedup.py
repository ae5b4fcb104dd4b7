"""The paper's energy model (§4, Tables 1-2) and kernel-repetition analysis
(§4.2) of the port against the JAX package's, on seeded inputs: every
function of `core.energy` on a grid of shapes, modes and dedup fractions
(floats equal exactly), `kernel_signatures` / `unique_kernel_fraction` /
`dedup_plan` on seeded +-1 weights in both layouts and at the paper CNN's
conv shapes (arrays equal), and `apply_dedup` equal to JAX's."""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as E_jax
from repro.core import kernel_dedup as K_jax
from repro_torch.core import energy as E
from repro_torch.core import kernel_dedup as K

MODES = ("fp32", "fp16", "bc", "bbp")
# the paper CIFAR-10 CNN's convs (cin, cout, k, h, w) and fully connected
# layers, as benchmarks/bench_energy.py lists them
CNN_CONVS = [(3, 128, 3, 32, 32), (128, 128, 3, 32, 32),
             (128, 256, 3, 16, 16), (256, 256, 3, 16, 16),
             (256, 512, 3, 8, 8), (512, 512, 3, 8, 8)]
DENSE = [(1, 784, 1024), (1, 1024, 10), (7, 33, 5), (100, 8192, 1024),
         (3, 1, 1)]


def test_tables_equal_jax():
    assert E.ENERGY_PJ == E_jax.ENERGY_PJ
    assert E.MEM_PJ == E_jax.MEM_PJ


@pytest.mark.parametrize("nbytes", [0, 1, 8 * 1024, 8 * 1024 + 1,
                                    32 * 1024, 500_000, 1024 * 1024,
                                    10 ** 9])
def test_mem_access_pj(nbytes):
    assert E.mem_access_pj(nbytes) == E_jax.mem_access_pj(nbytes)


@pytest.mark.parametrize("mode", MODES)
def test_dense_layer_energy(mode):
    for m, k, n in DENSE:
        a = E.dense_layer_energy(m, k, n, mode=mode)
        b = E_jax.dense_layer_energy(m, k, n, mode=mode)
        assert a.counts == b.counts
        assert a.total_pj() == b.total_pj()


@pytest.mark.parametrize("mode,frac", list(itertools.product(
    MODES, [1.0, 0.37, 0.5, 1 / 3, 0.0])))
def test_conv_layer_energy(mode, frac):
    for cin, cout, k, h, w in CNN_CONVS + [(1, 1, 1, 1, 1), (5, 7, 5, 3, 9)]:
        a = E.conv_layer_energy(cin, cout, k, h, w, mode=mode,
                                unique_kernel_fraction=frac)
        b = E_jax.conv_layer_energy(cin, cout, k, h, w, mode=mode,
                                    unique_kernel_fraction=frac)
        assert a.counts == b.counts
        assert a.total_pj() == b.total_pj()


def test_ledger_and_errors():
    a, b = E.EnergyLedger(), E_jax.EnergyLedger()
    for op, dt, n in [("mul", "fp32", 3), ("add", "int2", 10 ** 12),
                      ("xnor_popcount_word", "b32", 7), ("mul", "fp32", 2)]:
        a.add(op, dt, n)
        b.add(op, dt, n)
    assert a.counts == b.counts and a.total_pj() == b.total_pj()
    with pytest.raises(KeyError):
        a.add("mul", "int4", 1)
    with pytest.raises(ValueError):
        E.dense_layer_energy(1, 1, 1, mode="int8")


def _pm1(rng, shape, p=0.5):
    return np.where(rng.random(shape) < p, 1.0, -1.0).astype(np.float32)


# seeded +-1 weights: (kh, kw, cin, cout) as both packages' conv weights
# are stored, the paper CNN's shapes among them; (cout, cin, kh, kw) with
# cout or cin > 16 (the layout rule reads those as such); and a few with a
# skew towards +1, where repetitions are common
WEIGHTS = ([(3, 3, cin, cout) for cin, cout, *_ in CNN_CONVS]
           + [(3, 3, 4, 5), (1, 1, 7, 3), (5, 5, 2, 9),
              (32, 3, 3, 3), (20, 17, 3, 3), (64, 128, 1, 1)])


@pytest.mark.parametrize("shape,p", [(s, 0.5) for s in WEIGHTS]
                         + [((3, 3, 64, 64), 0.9), ((40, 8, 3, 3), 0.95)])
def test_signatures_fraction_plan_equal_jax(shape, p):
    rng = np.random.default_rng(abs(hash((shape, p))) % 2 ** 32)
    w = _pm1(rng, shape, p)
    np.testing.assert_array_equal(K.kernel_signatures(w),
                                  K_jax.kernel_signatures(w))
    assert K.unique_kernel_fraction(w) == K_jax.unique_kernel_fraction(w)
    a, b = K.dedup_plan(w), K_jax.dedup_plan(w)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_inverse_kernels_fold():
    """K and -K share a signature; the plan's sign restores -K."""
    rng = np.random.default_rng(0)
    w = _pm1(rng, (3, 3, 1, 6))
    w[..., 3] = -w[..., 0]
    w[..., 5] = w[..., 0]
    plan = K.dedup_plan(w)
    assert plan["rep_index"][3] == plan["rep_index"][0] \
        == plan["rep_index"][5]
    assert plan["sign"][3] == -1 and plan["sign"][5] == 1
    assert K.unique_kernel_fraction(w) == K_jax.unique_kernel_fraction(w)


def test_layout_rule_is_jax_quirk():
    """A (cout, cin, kh, kw) weight with cout, cin <= 16 is read as (kh,
    kw, cin, cout) by both packages (the recorded quirk)."""
    rng = np.random.default_rng(1)
    w = _pm1(rng, (8, 4, 3, 3))
    np.testing.assert_array_equal(K.kernel_signatures(w),
                                  K_jax.kernel_signatures(w))
    assert len(K.kernel_signatures(w)) == 3 * 3 == 9   # cin * cout read


def test_rejects_non_4d():
    with pytest.raises(ValueError):
        K.kernel_signatures(np.ones((3, 3, 4)))


@pytest.mark.parametrize("shape,lead,dtype", [
    ((3, 3, 16, 32), (2, 5), torch.float32),
    ((3, 3, 128, 128), (4,), torch.float32),
    ((20, 17, 3, 3), (3, 2, 2), torch.float32),
    ((3, 3, 8, 8), (6,), torch.bfloat16)])
def test_apply_dedup_equal_jax(shape, lead, dtype):
    rng = np.random.default_rng(len(lead) + shape[-1])
    w = _pm1(rng, shape, 0.8)
    plan = K.dedup_plan(w)
    x = rng.standard_normal(lead + (plan["n_unique"],)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    got = K.apply_dedup(xt, plan)
    want = K_jax.apply_dedup(jnp.asarray(xt.float().numpy(),
                                         dtype=jnp.bfloat16
                                         if dtype == torch.bfloat16
                                         else jnp.float32), plan)
    assert got.dtype == dtype and got.shape == lead + (len(plan["sign"]),)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))


def test_apply_dedup_on_meta():
    """On another device the expansion stays there (a gather and a sign
    multiply on the tensor's device)."""
    w = _pm1(np.random.default_rng(2), (3, 3, 4, 4))
    plan = K.dedup_plan(w)
    y = K.apply_dedup(torch.empty((2, plan["n_unique"]), device="meta"),
                      plan)
    assert y.device.type == "meta" and y.shape == (2, 16)
