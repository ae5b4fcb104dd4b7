"""The port's MoE sublayer (`repro_torch.models.common.moe_ffn`) and the
batched entry of kernel 1 against the JAX package, at a small size.

The same numpy params and inputs go through `repro.models.common.moe_ffn`
(eager, its frozen experts on jnp: the JAX package has no Pallas kernel
there) and the port's. Compared exactly: the routing (top-k expert
indices, each route's position in its expert's buffer, which routes are
kept), the frozen experts' int32 dots and the batched plain GEMM. The
outputs within 1e-5 of their largest magnitude (float32: the router's
matmul, the softmax and the gate-weighted sum round a few ulps apart), the
load-balance loss within 1e-6, and the dropped share (1 - the kept
share) within two float32 ulps of 1 (XLA's CPU mean multiplies by 1/n,
torch's divides by n), which pins the count of dropped routes exactly.

Where the router's probabilities differ between the packages, two of them
can lie within a few ulps and top-k then picks another expert: such a
route is accepted only where the JAX probabilities of the two experts are
proved that close (`_assert_same_routes`); at these seeds there are none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layers import QuantMode as JaxQuantMode
from repro.core.packed import attach_ffn_act_thresholds as jax_attach
from repro.core.packed import freeze_params as jax_freeze
from repro.kernels import tune
from repro.models import common as JC
from repro_torch.convert import from_numpy_tree
from repro_torch.core.layers import QuantMode
from repro_torch.core.packed import (
    PackedActivation, attach_ffn_act_thresholds, freeze_params,
    resident_weight_bytes,
)
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models import transformer as T

from _torch_parity import jax_to_np, np_to_jax, to_port, words

E, D, F_, K = 4, 64, 96, 2
NEAR_TIE_ULPS = 4
DROP_TOL = 2 * 2.0 ** -23       # two float32 ulps of 1


def _tree(kind, seed=0, router_scale=0.3):
    """numpy params of one MoE sublayer in the JAX package's shapes."""
    rng = np.random.default_rng(seed)
    shapes = JC.moe_param_shapes(D, F_, E, kind)
    return {"router": (rng.normal(size=shapes["router"])
                       * router_scale).astype(np.float32),
            "experts": {n: (rng.normal(size=s) * 0.02).astype(np.float32)
                        for n, s in shapes["experts"].items()}}


def _x(seed=1, b=2, s=9):
    return np.random.default_rng(seed).normal(size=(b, s, D)) \
        .astype(np.float32)


def _trees(tree, kind, frozen):
    jp, pp = np_to_jax(tree), to_port(tree)
    if frozen:
        jp, pp = jax_freeze(jp), freeze_params(pp)
        if kind == "sq_relu":
            jp, pp = jax_attach(jp), attach_ffn_act_thresholds(pp)
    return jp, pp


def _jax_route(router, x, top_k, cf):
    """JAX's dispatch, step for step as `repro.models.common.moe_ffn`
    computes it (its lines 126-144), which the function does not return."""
    t = x.shape[0] * x.shape[1]
    e = router.shape[-1]
    cap = int(max(1, (t * top_k * cf) // e))
    xt = jnp.asarray(x).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        jnp.asarray(router).astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    flat = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(t * top_k, e)
    pos = jnp.max(jnp.cumsum(flat, axis=0) * flat - 1, axis=-1)
    return {"probs": np.asarray(probs), "gate_idx": np.asarray(gate_idx),
            "pos": np.asarray(pos), "keep": np.asarray(pos < cap), "cap": cap}


def _port_route(router, x, top_k, cf):
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    r = C.moe_route(torch.from_numpy(router), xt, top_k, cf)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in r.items()}


def _assert_same_routes(got, want, top_k):
    """gate_idx, pos and keep equal; a row whose experts differ must hold
    a proved near tie: the JAX probabilities of the experts that traded
    places within NEAR_TIE_ULPS ulps of each other."""
    assert got["cap"] == want["cap"]
    rows = np.nonzero((got["gate_idx"] != want["gate_idx"]).any(-1))[0]
    for r in rows:
        p = want["probs"][r]
        for a, b in zip(got["gate_idx"][r], want["gate_idx"][r]):
            if a != b:
                assert abs(p[a] - p[b]) <= NEAR_TIE_ULPS * np.spacing(p[b]), \
                    f"row {r}: experts {a} / {b} are no near tie: {p}"
    assert not len(rows), f"near ties at rows {rows}: compare the rest"
    np.testing.assert_array_equal(got["gate_idx"], want["gate_idx"])
    np.testing.assert_array_equal(got["pos"], want["pos"])
    np.testing.assert_array_equal(got["keep"], want["keep"])


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


CASES = [("swiglu", "none", False), ("swiglu", "bc", False),
         ("swiglu", "bbp_det", False), ("swiglu", "bbp_det", True),
         ("swiglu", "bc", True), ("sq_relu", "bbp_det", False),
         ("sq_relu", "bbp_det", True)]


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("kind,mode,frozen", CASES)
def test_moe_ffn_equals_jax(kind, mode, frozen, cf):
    """Output, lb_loss and drop_frac against JAX eager, for masters in every
    mode and frozen experts, at capacity factors with no drop (8) and with
    routes dropped in token order (1.0, 0.5)."""
    tree, x = _tree(kind), _x()
    jp, pp = _trees(tree, kind, frozen)
    with tune.gspmd_safe():
        jo, ja = JC.moe_ffn(jp, jnp.asarray(x), kind, JaxQuantMode(mode),
                            top_k=K, capacity_factor=cf)
    po, pa = C.moe_ffn(pp, torch.from_numpy(x), kind, QuantMode(mode),
                       top_k=K, capacity_factor=cf)
    _close(po.numpy(), jo)
    np.testing.assert_allclose(float(pa["lb_loss"]), float(ja["lb_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pa["drop_frac"]),
                               float(ja["drop_frac"]), rtol=0, atol=DROP_TOL)
    assert (float(pa["drop_frac"]) > 0) == (cf < 8.0)
    _assert_same_routes(_port_route(tree["router"], x, K, cf),
                        _jax_route(tree["router"], x, K, cf), K)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_routes_drop_in_token_order(top_k):
    """At capacity factor 0.5 each expert keeps its first C routes counted
    token-major, k-minor, and drops the rest, as JAX does."""
    tree, x = _tree("swiglu", seed=4), _x(seed=5, b=3, s=7)
    got = _port_route(tree["router"], x, top_k, 0.5)
    _assert_same_routes(got, _jax_route(tree["router"], x, top_k, 0.5),
                        top_k)
    expert = got["gate_idx"].reshape(-1)
    for e in range(E):
        kept = got["keep"][expert == e]
        assert kept.sum() == min(got["cap"], kept.size)
        assert not kept[got["cap"]:].any() and kept[:got["cap"]].all()


def test_tied_router_takes_the_lower_experts():
    """Zero router weights tie every expert: top-k takes experts 0..k-1 in
    that order, as lax.top_k does, and the gates are 1/k."""
    tree, x = _tree("swiglu"), _x()
    tree["router"][:] = 0.0
    for top_k in (1, 2, 3):
        got = _port_route(tree["router"], x, top_k, 8.0)
        want = _jax_route(tree["router"], x, top_k, 8.0)
        np.testing.assert_array_equal(got["gate_idx"], want["gate_idx"])
        assert (got["gate_idx"] == np.arange(top_k)).all()
        np.testing.assert_array_equal(got["gate_vals"],
                                      np.full((18, top_k), 1 / top_k,
                                              np.float32))


def test_near_ties_are_proved():
    """Router column 2 is column 1 with one entry one ulp larger: the two
    experts' probabilities lie within a few ulps, the order between them
    is what each package's rounding makes it. The port's top-k equals the
    order of its own probabilities with ties to the lower index, and where
    its picks differ from JAX's, the check proves a near tie."""
    tree, x = _tree("swiglu", seed=7), _x(seed=8)
    tree["router"][:, 2] = tree["router"][:, 1]
    tree["router"][0, 2] = np.nextafter(tree["router"][0, 1], np.inf)
    got = _port_route(tree["router"], x, K, 8.0)
    want = _jax_route(tree["router"], x, K, 8.0)
    probs = got["probs"]
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    np.testing.assert_array_equal(got["gate_idx"], order)
    diff = (got["gate_idx"] != want["gate_idx"]).any(-1)
    for r in np.nonzero(diff)[0]:
        p = want["probs"][r]
        assert abs(p[1] - p[2]) <= NEAR_TIE_ULPS * np.spacing(p[1])
        assert set(got["gate_idx"][r]) ^ set(want["gate_idx"][r]) <= {1, 2}
    close = np.abs(want["probs"][:, 1] - want["probs"][:, 2]) \
        <= NEAR_TIE_ULPS * np.spacing(want["probs"][:, 1])
    assert close.all()


@pytest.mark.parametrize("kind", ["swiglu", "sq_relu"])
def test_frozen_expert_dots_equal_jax(kind):
    """The frozen experts' popcount dots on a dispatch buffer (with empty,
    all-zero capacity rows) equal JAX's `_batched_qmm`, exactly; gate and
    up read one shared pack."""
    tree = _tree(kind)
    jp, pp = _trees(tree, kind, True)
    rng = np.random.default_rng(11)
    buf = rng.normal(size=(E, 5, D)).astype(np.float32)
    buf[:, 3:] = 0.0
    for name in ("w_gate", "w_up") if kind == "swiglu" else ("w_up",):
        want = JC._batched_qmm(jnp.asarray(buf), jp["experts"][name],
                               JaxQuantMode.BBP_DET, False, None)
        w = pp["experts"][name]
        got = ops.packed_matmul_experts(torch.from_numpy(buf), w, path="ref")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))
        shared = PackedActivation.pack(torch.from_numpy(buf))
        np.testing.assert_array_equal(
            ops.packed_matmul_experts(shared, w).numpy(), got.numpy())
    h = rng.normal(size=(E, 5, F_)).astype(np.float32)
    want = JC._batched_qmm(jnp.asarray(h), jp["experts"]["w_down"],
                           JaxQuantMode.BBP_DET, False, None)
    got = C._batched_qmm(torch.from_numpy(h), pp["experts"]["w_down"],
                         QuantMode.BBP_DET, "ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (E, M, K, N): decode and chunk rows, one past a word, a ragged case with
# K off a word, KW % 4 != 0 and M across the small-M edge
BATCHED = [(3, 1, 64, 40), (4, 10, 96, 33), (3, 33, 100, 17), (2, 62, 128, 64)]


@pytest.mark.parametrize("e,m,k,n", BATCHED)
def test_batched_plain_equals_each_expert(e, m, k, n):
    """The batched entry's plain version, (E, M, KW) x (E, N, KW), equals
    the 2-D one expert by expert and JAX's packed_dot; zero rows pack to
    all-ones words."""
    from repro.core.bitpack import pack_bits as j_pack, packed_dot
    rng = np.random.default_rng(e * 100 + m)
    x = rng.normal(size=(e, m, k)).astype(np.float32)
    x[:, -1:] = 0.0
    w = rng.normal(size=(e, n, k)).astype(np.float32)
    from repro_torch.core.bitpack import pack_bits
    a, b = pack_bits(torch.from_numpy(x)), pack_bits(torch.from_numpy(w))
    got = bg.binary_gemm_packed(a, b, k)
    assert got.shape == (e, m, n) and got.dtype == torch.int32
    for i in range(e):
        np.testing.assert_array_equal(
            got[i].numpy(), bg.binary_gemm_packed_plain(a[i], b[i], k).numpy())
    want = packed_dot(j_pack(jnp.asarray(x))[:, :, None],
                      j_pack(jnp.asarray(w))[:, None], k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (a[:, -1] == -1).all()
    with pytest.raises(ValueError):
        bg.binary_gemm_packed(a, b[:1], k)
    with pytest.raises(ValueError):
        bg.binary_gemm_packed(a[0], b, k)


def test_batched_plan_counts_every_expert():
    """`gemm_plan` counts the E x blocks of a batched grid: a split that
    one expert's blocks would take is not taken for sixteen, the widest
    small-M block that fills the card with all experts is chosen, and
    the tiles count every expert's."""
    sms = 132
    one = bg.gemm_plan("binary_gemm_packed", 4, 1024, 6144, sms)
    many = bg.gemm_plan("binary_gemm_packed", 4, 1024, 6144, sms, batch=16)
    assert one.small_m and one.split > 1
    assert many.small_m and many.split == 1
    assert many.blocks == 16 * -(-1024 // many.block_n)
    dbrx = bg.gemm_plan("binary_gemm_packed", 10, 10752, 6144, sms, batch=16)
    assert dbrx.small_m and dbrx.block_n == 256 and dbrx.split == 1
    tiles = bg.gemm_plan("binary_gemm_packed", 62, 6144, 10752, sms, batch=16)
    assert not tiles.small_m and tiles.blocks == 16 * -(-6144 // 256)
    with pytest.raises(ValueError):
        bg.gemm_plan("binary_gemm_packed_rhs", 4, 64, 64, sms, batch=2)


def test_packed_experts_tree():
    """Freezing an (L, E, D, F) stack gives (L, E, F, KW) words equal to
    JAX's; a layer's view is (E, F, KW) with its (E, F) fold thresholds;
    resident bytes, `to` and `from_numpy_tree` of a JAX-frozen tree keep
    them; the router stays float32."""
    rng = np.random.default_rng(2)
    shapes = JC.moe_param_shapes(D, F_, E, "sq_relu")
    tree = {"blocks": {"ffn": {
        "router": rng.normal(size=(2,) + shapes["router"]).astype(np.float32),
        "experts": {n: rng.normal(size=(2,) + s).astype(np.float32)
                    for n, s in shapes["experts"].items()}}}}
    jf = jax_attach(jax_freeze(np_to_jax(tree)))
    pf = attach_ffn_act_thresholds(freeze_params(to_port(tree)))
    for name in ("w_up", "w_down"):
        jw, pw = jf["blocks"]["ffn"]["experts"][name], \
            pf["blocks"]["ffn"]["experts"][name]
        np.testing.assert_array_equal(words(pw.packed), np.asarray(jw.packed))
        assert pw.packed.shape[:2] == (2, E) and pw.k == jw.k
        view = T.layer_params(pf, 1)["ffn"]["experts"][name]
        assert torch.equal(view.packed, pw.packed[1])
        if name == "w_up":
            assert pw.fold == jw.fold == "act:sq_relu"
            assert view.thresh.shape == (E, F_)
            np.testing.assert_array_equal(pw.thresh.numpy(),
                                          np.asarray(jw.thresh))
        moved = pw.to("cpu")
        assert torch.equal(moved.packed, pw.packed) and moved.fold == pw.fold
    experts = pf["blocks"]["ffn"]["experts"]
    cw = from_numpy_tree(jax_to_np(jf), device="cpu")["blocks"]["ffn"][
        "experts"]["w_up"]
    assert torch.equal(cw.packed, experts["w_up"].packed)
    assert torch.equal(cw.thresh, experts["w_up"].thresh)
    assert pf["blocks"]["ffn"]["router"].dtype == torch.float32
    assert resident_weight_bytes(pf) == {
        "binary": sum(w.nbytes for w in experts.values()),
        "other": 2 * D * E * 4}


def test_stack_layers_of_frozen_experts():
    """Layers frozen one at a time and stacked equal the stack frozen
    whole (the path of `init_transformer_params(freeze_layer=...)`)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(3, E, D, F_)).astype(np.float32))
    whole = freeze_params({"w_up": w})["w_up"]
    parts = [freeze_params({"w_up": w[i:i + 1]}) for i in range(3)]
    stacked = T.stack_layers(parts)["w_up"]
    assert torch.equal(stacked.packed, whole.packed)


def test_pad_rows_count_and_never_displace_earlier_rows():
    """Rows after a row cannot take its capacity (positions count
    token-major): the outputs of a call's first rows are the same with
    and without rows appended after them, at a capacity factor that drops
    routes; rows before them can."""
    tree = _tree("swiglu", seed=9)
    _, pp = _trees(tree, "swiglu", True)
    x = _x(seed=10, b=1, s=12)
    full, _ = C.moe_ffn(pp, torch.from_numpy(x), "swiglu", QuantMode.BBP_DET,
                        top_k=K, capacity_factor=1.0)
    head = x[:, :6]
    cap_full = int((12 * K * 1.0) // E)
    xs = np.concatenate([head, np.zeros((1, 6, D), np.float32)], axis=1)
    padded, aux = C.moe_ffn(pp, torch.from_numpy(xs), "swiglu",
                            QuantMode.BBP_DET, top_k=K, capacity_factor=1.0)
    with tune.gspmd_safe():
        jo, ja = JC.moe_ffn(jax_freeze(np_to_jax(tree)), jnp.asarray(xs),
                            "swiglu", JaxQuantMode.BBP_DET, top_k=K,
                            capacity_factor=1.0)
    _close(padded.numpy(), jo)
    np.testing.assert_allclose(float(aux["drop_frac"]),
                               float(ja["drop_frac"]), rtol=0, atol=DROP_TOL)
    assert cap_full == 6
    r_full = _port_route(tree["router"], x, K, 1.0)
    r_pad = _port_route(tree["router"], xs, K, 1.0)
    n = 6 * K
    np.testing.assert_array_equal(r_full["pos"][:n], r_pad["pos"][:n])
    np.testing.assert_array_equal(r_full["keep"][:n], r_pad["keep"][:n])
    np.testing.assert_array_equal(full[:, :6].numpy(), padded[:, :6].numpy())
