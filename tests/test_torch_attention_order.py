"""Whole-prompt against chunked attention in float32, at phi3's head shape
and score magnitudes: both packages part alike.

The float attention of whole-prompt admission (`flash_attention`) scales q
in float32, casts it to the compute dtype and then takes the dots; the
chunked path's (`masked_chunk_attention` under a `chunk_valid_mask` of
32-row chunks) takes the dots first and scales the scores after. With
integer-valued q and k at hd 128 the scores reach 1e4-1e5. The chunked
path's integer dots are exact in float32 (|q.k| < 2^24) and rounded once
by the scale; the flash path sums 128 non-integer products of the scaled q
in float32, each partial sum rounded at ~1e4, which moves a score by
~1e-3, and exp() turns that into a relative change of the same order in a
near-tied softmax.

These tests hold, on the same numpy-seeded q, k and v (40 query heads over
10 KV heads, 200 positions, causal):
  * each port function within float32 rounding of its JAX twin;
  * the flash-against-chunk difference of the port equal in size, and at
    the same positions, to the JAX package's own, far above float32
    rounding of the outputs;
  * float64 as the arbiter: the chunked formula lies nearer the exact
    attention, and the flash formula's departure is not the rounding of
    q*scale itself (exact attention over that rounded q stays near exact)
    but its float32 sums of non-integer products.
So the parting is the reference's semantics, not a port fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import attention as JA
from repro_torch.kernels import ref as R
from repro_torch.models import attention as A

B, S, HQ, HKV, HD, CHUNK = 1, 200, 40, 10, 128, 32
G = HQ // HKV


def _exact(q, k, v):
    """Causal attention in float64 (numpy inputs, any dtype)."""
    qd, kd, vd = (torch.from_numpy(np.asarray(x, np.float64))
                  for x in (q, k, v))
    kd, vd = (x.repeat_interleave(G, 2) for x in (kd, vd))
    sc = torch.einsum("bshd,bthd->bhst", qd, kd) / np.sqrt(HD)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool))
    p = torch.softmax(sc.masked_fill(~causal, -np.inf), -1)
    out = torch.einsum("bhst,bthd->bshd", p, vd).numpy()
    return out, float(sc.abs().max())


def _chunked(mask, attend, q, k, v):
    """The chunked path: 32-row chunks against the whole cache."""
    outs = []
    for p in range(0, S, CHUNK):
        s = min(CHUNK, S - p)
        outs.append(np.asarray(attend(q[:, p:p + s], k, v,
                                      mask(B, s, S, p + s, p))))
    return np.concatenate(outs, 1)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    q = rng.integers(-100, 101, (B, S, HQ, HD)).astype(np.float32)
    # near-tied keys: one shared row plus small integer offsets
    k = (rng.integers(-100, 101, (B, 1, HKV, HD))
         + rng.integers(-3, 4, (B, S, HKV, HD))).astype(np.float32)
    v = rng.integers(-300, 301, (B, S, HKV, HD)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = {
        "jax flash": np.asarray(jax.jit(JA.flash_attention)(jq, jk, jv)),
        "jax chunk": _chunked(
            lambda b, s, t, kl, qp: JR.chunk_valid_mask(
                b, s, t, jnp.int32(kl), jnp.int32(qp), 0, True),
            jax.jit(JA.masked_chunk_attention), jq, jk, jv),
        "port flash": A.flash_attention(tq, tk, tv).numpy(),
        "port chunk": _chunked(
            lambda b, s, t, kl, qp: R.chunk_valid_mask(b, s, t, kl, qp, 0,
                                                       True),
            A.masked_chunk_attention, tq, tk, tv),
    }
    out["exact"], out["max score"] = _exact(q, k, v)
    # the flash formula's q: scaled in float32 and rounded there
    q_rounded = (q * np.float32(1 / np.sqrt(np.float32(HD)))).astype(
        np.float32) * np.sqrt(HD)
    out["exact, rounded q"] = _exact(q_rounded, k, v)[0]
    out["scale"] = float(np.abs(out["exact"]).max())
    return out


def test_scores_reach_phi3_s_magnitudes(runs):
    assert 1e4 <= runs["max score"] <= 1e5


@pytest.mark.parametrize("formula", ["flash", "chunk"])
def test_port_is_jax_to_float32_rounding(runs, formula):
    diff = np.abs(runs[f"port {formula}"] - runs[f"jax {formula}"]).max()
    assert diff <= 2.0 ** -20 * runs["scale"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_whole_and_chunked_part_far_above_rounding(runs, pkg):
    part = np.abs(runs[f"{pkg} flash"] - runs[f"{pkg} chunk"]).max()
    assert part >= 1e-3 * runs["scale"] > 1000 * 2.0 ** -23 * runs["scale"]


def test_port_parts_where_and_as_much_as_jax(runs):
    """Per position, the largest |flash - chunk| of each package: equal to
    float32 rounding, so the ten worst positions are the same."""
    part = {pkg: np.abs(runs[f"{pkg} flash"] - runs[f"{pkg} chunk"])
            .max(axis=(0, 2, 3)) for pkg in ("jax", "port")}
    np.testing.assert_allclose(part["port"], part["jax"], rtol=0,
                               atol=2.0 ** -19 * runs["scale"])
    worst = np.argsort(-part["jax"])[:10]
    assert set(np.argsort(-part["port"])[:10]) == set(worst)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_float64_arbiter_names_the_flash_sums(runs, pkg):
    """The chunked formula is the nearer to exact attention; exact
    attention over the flash formula's rounded q*scale stays within a
    hundredth of the flash formula's departure, so that departure is the
    float32 sums of the scaled products, not the rounding of q."""
    flash_err = np.abs(runs[f"{pkg} flash"] - runs["exact"]).max()
    chunk_err = np.abs(runs[f"{pkg} chunk"] - runs["exact"]).max()
    assert chunk_err < 0.25 * flash_err
    assert np.abs(runs["exact, rounded q"] - runs["exact"]).max() \
        < 0.01 * flash_err
