"""The port's route table (`repro_torch.kernels.tune`) against the JAX
package's (`repro.kernels.tune`), and the dispatch that reads it, on the
CPU.

Held equal to JAX: `bucket` and `bucket_key` on a grid of shapes,
`get_route` on every standard bucket (the port's copy of the CPU table)
and on a miss (the heuristic, recorded in `misses`), `route_override`'s
nesting, `ServingEngine.kernel_routes()` on a contiguous and a paged
engine, and the serving CLI's `kernel route` lines.

The card's side needs no card to be tested here: the launch a table entry
names (`plan_from_params`) is checked against the fixed rule (`gemm_plan`,
`attention_plan`) at `sms=132`, an H100's count. The fixed rule's own
fields give the fixed rule's plan, so a miss changes no launch; every
check the fixed rule makes sends an invalid entry back to the fixed rule;
an explicit route bypasses the table; a card table naming a plain route
raises. tests/test_torch_cuda.py holds the committed card table's winners
to the plain versions on the card.
"""
import json
import re
import sys

import numpy as np
import pytest
import torch

from repro.kernels import tune as jtune
from repro.launch import serve as jax_serve
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.core.bitpack import pack_bits
from repro_torch.kernels import binary_gemm as bg
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels import tune
from repro_torch.launch import serve
from repro_torch.serving.engine import ServingEngine

from _torch_families import params

SMS = 132


@pytest.fixture(autouse=True)
def _fresh_plans():
    tune.forget_plans()
    yield
    tune.forget_plans()


# ---------------------------------------------------------------------------
# Buckets and the CPU table: equal to JAX's
# ---------------------------------------------------------------------------
SHAPE_GRID = [dict(m=m, n=n, kw=kw, pl=pl)
              for m, n, kw, pl in ((1, 1, 1, 1), (5, 100, 3, 0),
                                   (32, 5120, 160, 1), (33, 17920, 560, 0),
                                   (200, 77, 10, 1), (4096, 24576, 192, 0))] + [
    dict(b=b, t=t, hkv=hkv, g=g, hd=hd)
    for b, t, hkv, g, hd in ((1, 1, 1, 1, 16), (4, 300, 10, 4, 128),
                             (3, 2100, 1, 10, 256))] + [
    dict(b=4, s=s, t=t, ps=ps, p=p, hkv=8, g=8, hd=128)
    for s, t, ps, p in ((32, 544, 32, 70), (7, 16, 4, 17))]


@pytest.mark.parametrize("shape", SHAPE_GRID, ids=jtune.bucket_key)
def test_bucket_and_key_equal_jax(shape):
    assert tune.bucket(shape) == jtune.bucket(shape)
    assert tune.bucket_key(shape) == jtune.bucket_key(shape)
    assert tune.bucket(tune.bucket(shape)) == tune.bucket(shape)


def test_standard_shapes_and_cpu_table_are_jax_s():
    assert tune.STANDARD_SHAPES == jtune.STANDARD_SHAPES
    assert tune.default_backend() == "cpu"
    mine = json.loads(tune.cache_path("cpu").read_text())
    assert mine == json.loads(jtune.cache_path("cpu").read_text())


STANDARD = [(k, s) for k, shapes in jtune.STANDARD_SHAPES.items()
            for s in shapes]


@pytest.mark.parametrize("kernel,shape", STANDARD, ids=[
    f"{k}-{jtune.bucket_key(s)}" for k, s in STANDARD])
def test_get_route_equals_jax_on_standard_shapes(kernel, shape):
    got = tune.get_route(kernel, **shape)
    assert got == jtune.get_route(kernel, **shape)
    assert got[0] in tune.ROUTES[kernel]
    nudged = {k: max(1, v - 1) for k, v in shape.items()}
    if tune.bucket_key(nudged) == tune.bucket_key(shape):
        assert tune.get_route(kernel, **nudged) == got


@pytest.mark.parametrize("shape", [
    dict(m=1 << 12, n=1 << 13, kw=1 << 9, pl=1), dict(m=3, n=40, kw=1, pl=0)])
def test_miss_records_the_shape_and_returns_jax_s_heuristic(shape):
    tune.misses.clear()
    got = tune.get_route("binary_gemm", **shape)
    assert (("binary_gemm", tune.bucket_key(shape)) in tune.misses)
    assert tune.misses[("binary_gemm", tune.bucket_key(shape))] == shape
    assert got == jtune.get_route("binary_gemm", **shape)
    assert got == tune._heuristic("binary_gemm", shape)


def test_autotune_on_the_cpu_keeps_the_heuristic(monkeypatch):
    """REPRO_AUTOTUNE=1 tunes only on a card (outside graph capture): on
    the CPU a miss still answers the heuristic, as the CPU has no tuner."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    shape = dict(m=3, n=40, kw=1, pl=0)
    assert tune._capture_clean()
    assert tune.get_route("binary_gemm", **shape) == \
        jtune._heuristic("binary_gemm", shape)


def test_route_override_nests_and_restores_as_jax_s():
    shape = dict(m=4, n=64, kw=2, pl=1)
    base = tune.get_route("binary_gemm", **shape)
    for t in (tune, jtune):
        with t.route_override(binary_gemm="float"):
            assert t.get_route("binary_gemm", **shape) == ("float", {})
            with t.route_override(binary_gemm="mxu",
                                  decode_attention="xla"):
                assert t.get_route("binary_gemm", **shape) == ("mxu", {})
            assert t.get_route("binary_gemm", **shape) == ("float", {})
            assert "decode_attention" not in t._ROUTE_OVERRIDE
        assert t.get_route("binary_gemm", **shape) == base


def test_cli_check_show_and_tune_on_the_cpu(capsys):
    assert tune.main(["--check"]) == 0
    assert "all standard shapes covered" in capsys.readouterr().out
    assert tune.main(["--show"]) == 0
    assert "binary_gemm_fused" in capsys.readouterr().out
    assert tune.main(["--tune"]) == 2          # the card tunes, not the CPU
    with pytest.raises(RuntimeError, match="CUDA card"):
        tune.tune_bucket("binary_gemm", dict(m=4, n=64, kw=2, pl=1))


def test_card_shapes_list_is_well_formed():
    """The card's recorded list (if committed) holds one real shape per
    bucket of the six table kernels, a GEMM's float lhs with the dtype of
    its first launch (the paper nets' float32, the LMs' bf16), and
    `standard_shapes` adds it only for a card."""
    extra = tune.card_shapes()
    for kernel, shapes in extra.items():
        assert kernel in tune.KERNELS
        keys = [tune.bucket_key(s) for s in shapes]
        assert len(set(keys)) == len(keys)
        for s in shapes:
            assert set(s) - {"dtype"} == set(tune.STANDARD_SHAPES[kernel][0])
            if "gemm" in kernel:
                assert ("dtype" in s) == (s["pl"] == 0)
                assert s.get("dtype", "float32") in ("float32", "bfloat16")
    if extra:
        # the MLP's l1 (float32) and l2 / l3 (words): one shape, two buckets
        mlp = [s for s in extra["binary_gemm_fused"]
               if (s["m"], s["n"], s["kw"]) == (200, 1024, 32)]
        assert sorted((s["pl"], s.get("dtype")) for s in mlp) == \
            [(0, "float32"), (1, None)]
    assert tune.standard_shapes("cpu") == tune.STANDARD_SHAPES
    card = tune.standard_shapes("nvidia-h100-80gb-hbm3")
    for kernel, shapes in extra.items():
        assert {tune.bucket_key(s) for s in shapes} <= \
            {tune.bucket_key(s) for s in card[kernel]}


CARD = "nvidia-h100-80gb-hbm3"


@pytest.mark.parametrize("kernel", tune.KERNELS)
def test_committed_card_table_covers_both_lists_with_kernel_launches(kernel):
    """The H100's table, named from the device: every standard bucket of
    both lists, each winner a `cuda` launch the kernel takes at the shape
    it was tuned at (the table's clamps, the card's SMs), the fixed rule's
    launch there recorded as this tree's rule computes it, and the winner
    no slower than it."""
    table = tune.load_cache(CARD)
    meta = table["_meta"]
    assert meta["device"] == "NVIDIA H100 80GB HBM3"
    assert meta["backend"] == CARD
    assert not [gap for gap in tune.missing(CARD) if gap[0] == kernel]
    card = {}
    for s in tune.standard_shapes(CARD).get(kernel, []):
        card.setdefault(tune.bucket_key(s), []).append(s)
    for key, entry in table[kernel].items():
        shape = {k: v for k, v in (re.match(r"([a-z]+)(\d+)$", part).groups()
                                   for part in key.split("_"))}
        shape = {k: int(v) for k, v in shape.items()}
        assert tune.bucket_key(shape) == key
        shape = entry.get("shape", shape)
        assert tune.bucket_key(shape) == key
        assert shape in card.get(key, [shape])   # tuned as recorded
        assert entry["route"] == "cuda"
        assert entry["rule"]["params"] == tune.rule_params(kernel, shape,
                                                           meta["sms"])
        assert entry["us"] <= entry["rule"]["us"]
        if kernel in ("binary_gemm", "binary_gemm_fused"):
            kn = tune._gemm_kernel(kernel, shape)
            assert bg.plan_from_params(kn, shape["m"], shape["n"],
                                       32 * shape["kw"], meta["sms"], True,
                                       entry["params"]) is not None
        else:
            assert pa.plan_from_params(shape["b"], shape.get("s", 1),
                                       shape["t"], shape["hkv"], shape["g"],
                                       shape["hd"], entry["params"]) is not None


# ---------------------------------------------------------------------------
# The card's launches, checked against the fixed rule without a card
# ---------------------------------------------------------------------------
GEMM_KERNELS = ("binary_gemm_packed", "binary_gemm_packed_rhs",
                "binary_gemm_fused")
RULE_GRID = [(kn, m, k, n) for kn in GEMM_KERNELS
             for m in (1, 4, 16, 17, 32, 33, 200, 2048)
             for k, n in ((5120, 1280), (5120, 17920), (17920, 5120),
                          (300, 77), (8190, 200), (4096, 288), (6144, 24576))]


@pytest.mark.parametrize("kn", GEMM_KERNELS)
def test_rule_fields_give_the_rule_s_gemm_plan(kn):
    """A miss on the card answers the fixed rule's fields at the bucket's
    K (KW * 32); the launch they name at the real shape is gemm_plan's."""
    for kernel, m, k, n in RULE_GRID:
        if kernel != kn:
            continue
        kw = -(-k // 32)
        name = "binary_gemm_fused" if kn == "binary_gemm_fused" \
            else "binary_gemm"
        fields = tune.rule_params(
            name, dict(m=m, n=n, kw=kw, pl=int(kn == "binary_gemm_packed")),
            SMS)
        want = bg.gemm_plan(kn, m, n, k, SMS)
        assert bg.plan_from_params(kn, m, n, k, SMS, True, fields) == want
        for tuned in ({"small_m": 1, "block_n": 32, "split": 1}, fields):
            got = bg.plan_from_params(kn, m, n, k, SMS, True, tuned)
            assert got is None or got.blocks > 0


ATTN_GRID = [(b, s, t, hkv, g, hd)
             for b, s in ((4, 1), (1, 32), (4, 32), (1, 200), (2, 7))
             for t in (16, 300, 512, 4096, 16384)
             for hkv, g, hd in ((10, 4, 128), (8, 8, 128), (1, 10, 256),
                                (32, 1, 64), (2, 2, 16))]


def test_rule_fields_give_the_rule_s_attention_plan():
    for b, s, t, hkv, g, hd in ATTN_GRID:
        want = pa.attention_plan(b, s, t, hkv, g, hd, SMS)
        fields = pa.plan_params(want, s)
        assert pa.plan_from_params(b, s, t, hkv, g, hd, fields) == want
        kernel = "decode_attention" if s == 1 else "prefill_attention"
        shape = dict(b=b, t=t, hkv=hkv, g=g, hd=hd, **({} if s == 1
                                                        else {"s": s}))
        assert tune.rule_params(kernel, shape, SMS) == fields


@pytest.mark.parametrize("kernel", tune.KERNELS)
def test_candidates_on_the_card_hold_the_rule_and_only_kernels(kernel):
    for shape in tune.STANDARD_SHAPES[kernel]:
        cands = tune.candidates(kernel, shape, sms=SMS)
        assert cands[0] == ("cuda", tune.rule_params(kernel,
                                                     tune.bucket(shape), SMS))
        assert all(route == "cuda" for route, _ in cands)
        assert len({json.dumps(p, sort_keys=True) for _, p in cands}) \
            == len(cands)


def _table(monkeypatch, route, params):
    """get_route answering one card-table entry for every shape (a route
    override still wins)."""
    calls = []

    def get_route(kernel, **shape):
        calls.append((kernel, shape))
        if kernel in tune._ROUTE_OVERRIDE:
            return tune._ROUTE_OVERRIDE[kernel], {}
        return route, dict(params)
    monkeypatch.setattr(tune, "get_route", get_route)
    return calls


SMALL = dict(small_m=1, block_n=32, split=1)
# (kernel, M, N, K, aligned, the tuned fields, the check they fail)
GEMM_CLAMPS = [
    ("binary_gemm_packed", 33, 4096, 4096, True, SMALL, "M > SMALL_M_ROWS"),
    ("binary_gemm_fused", 24, 4096, 4096, True, SMALL,
     "M > FUSED_SMALL_M_ROWS"),
    ("binary_gemm_packed_rhs", 8, 4096, 4000, True, SMALL, "KW % 4"),
    ("binary_gemm_packed", 8, 4096, 4096, False, SMALL, "unaligned"),
    ("binary_gemm_packed_rhs", 32, 512, 65536, True, SMALL, "shared memory"),
    ("binary_gemm_packed", 32, 512, 65536, True,
     dict(small_m=1, block_n=256, split=1), "shared memory, packed stride"),
    ("binary_gemm_packed", 4, 4096, 4096, True,
     dict(small_m=1, block_n=32, split=16), "split > _CLUSTER_MAX"),
    ("binary_gemm_packed_rhs", 4, 4096, 4096, True,
     dict(small_m=1, block_n=32, split=3), "split not a power of two"),
    ("binary_gemm_packed", 4, 1024, 640, True,
     dict(small_m=1, block_n=32, split=4), "a block without K"),
    ("binary_gemm_packed_rhs", 64, 1024, 256, True,
     dict(small_m=0, block_n=128, split=4), "a tile block without K"),
    ("binary_gemm_packed_rhs", 8, 4096, 4096, True,
     dict(small_m=1, block_n=128, split=1), "float small-M width"),
    ("binary_gemm_packed_rhs", 64, 4096, 4096, True,
     dict(small_m=0, block_n=256, split=2), "wide tiles with a split"),
    ("binary_gemm_fused", 64, 4096, 4096, True,
     dict(small_m=0, block_n=256, split=1), "wide tiles, fused"),
]


@pytest.mark.parametrize("kn,m,n,k,aligned,fields,why", GEMM_CLAMPS,
                         ids=[c[-1] for c in GEMM_CLAMPS])
def test_invalid_tuned_gemm_entry_takes_the_fixed_rule(monkeypatch, kn, m, n,
                                                       k, aligned, fields,
                                                       why):
    _table(monkeypatch, "cuda", fields)
    assert bg.plan_from_params(kn, m, n, k, SMS, aligned, fields) is None
    got = bg.routed_plan(kn, m, n, k, SMS, aligned,
                         torch.int32 if kn == "binary_gemm_packed"
                         else torch.bfloat16)
    assert got == bg.gemm_plan(kn, m, n, k, SMS, aligned)
    if why.startswith("M > FUSED"):
        # the kernel takes it, the table may not: an explicit route can
        assert bg.routed_plan(kn, m, n, k, SMS, aligned, torch.bfloat16, "cuda",
                              fields).small_m


def test_valid_tuned_gemm_entry_is_launched_and_kept(monkeypatch):
    tuned = dict(small_m=1, block_n=64, split=2)
    calls = _table(monkeypatch, "cuda", tuned)
    kn, m, n, k = "binary_gemm_packed_rhs", 20, 5120, 17920
    got = bg.routed_plan(kn, m, n, k, SMS, True, torch.bfloat16)
    assert got == bg.GemmPlan(True, 2, 64, 80 * 2)
    assert got != bg.gemm_plan(kn, m, n, k, SMS)
    bg.routed_plan(kn, m, n, k, SMS, True, torch.bfloat16)
    assert calls == [("binary_gemm", dict(m=20, n=5120, kw=560, pl=0))]
    with tune.route_override(binary_gemm="cuda"):
        assert bg.routed_plan(kn, m, n, k, SMS, True, torch.bfloat16) == \
            bg.gemm_plan(kn, m, n, k, SMS)
    assert bg.routed_plan(kn, m, n, k, SMS, True, torch.bfloat16) == got
    assert len(calls) == 3            # the override emptied the memo


def test_fused_float_and_packed_lhs_resolve_their_own_entries(monkeypatch):
    """Kernel 3 at one (M, N, K) with a float lhs and with packed words (the
    MLP's l1 and l2) asks the table for pl 0 and pl 1 apart, launches each
    entry, and records both buckets, the float one with its dtype."""
    by_pl = {0: dict(small_m=0, block_n=128, split=1),
             1: dict(small_m=0, block_n=128, split=2)}
    calls = []

    def get_route(kernel, **shape):
        calls.append((kernel, shape["pl"]))
        return "cuda", dict(by_pl[shape["pl"]])
    monkeypatch.setattr(tune, "get_route", get_route)
    monkeypatch.setattr(tune, "seen", {})
    tune.forget_plans()
    kn, m, n, k = "binary_gemm_fused", 200, 1024, 1024
    try:
        got = {pl: bg.routed_plan(kn, m, n, k, SMS, True, lhs)
               for pl, lhs in ((0, torch.float32), (1, torch.int32))}
        for pl, lhs in ((0, torch.float32), (1, torch.int32)):
            assert bg.routed_plan(kn, m, n, k, SMS, True, lhs) == got[pl]
    finally:
        tune.forget_plans()
    assert got == {pl: bg.plan_from_params(kn, m, n, k, SMS, True, p)
                   for pl, p in by_pl.items()}
    assert got[0] != got[1]
    assert calls == [("binary_gemm_fused", 0), ("binary_gemm_fused", 1)]
    assert tune.seen == {
        ("binary_gemm_fused", "kw32_m256_n1024_pl0"):
            dict(m=200, n=1024, kw=32, pl=0, dtype="float32"),
        ("binary_gemm_fused", "kw32_m256_n1024_pl1"):
            dict(m=200, n=1024, kw=32, pl=1)}


def test_a_recorded_dtype_keys_nothing_and_sizes_the_lhs():
    """A card shape's float lhs `dtype` is left out of the bucket key (the
    JAX package's), and the roofline reads 4 bytes a float32 value, 2 a
    bf16 one, 4 a 32-value word."""
    shape = dict(m=200, n=1024, kw=32, pl=0)
    f32 = dict(shape, dtype="float32")
    assert tune.bucket_key(f32) == tune.bucket_key(shape) == \
        jtune.bucket_key(shape)
    assert tune.ragged(f32)["dtype"] == "float32"
    size = {form: tune.roofline("binary_gemm", s, {}, SMS)["hbm_bytes"]
            for form, s in (("bf16", shape), ("f32", f32),
                            ("words", dict(shape, pl=1)))}
    assert size["f32"] - size["bf16"] == 200 * 1024 * 2
    assert size["bf16"] - size["words"] == 200 * 1024 * 2 - 200 * 32 * 4


# (kernel, B, S, T, Hkv, G, hd, the tuned fields, the check they fail)
ATTN_CLAMPS = [
    ("decode_attention", 4, 1, 512, 10, 4, 128, {"split": 3}, "split 3"),
    ("decode_attention", 4, 1, 100, 10, 4, 128, {"split": 2},
     "narrow: 64 positions a block"),
    ("prefill_attention", 1, 32, 300, 10, 4, 128,
     {"block_rows": 8, "split": 2}, "wide: 256 positions a block"),
    ("prefill_attention", 1, 4, 512, 10, 4, 128,
     {"block_rows": 0, "split": 1}, "no rows"),
    ("prefill_attention_paged", 1, 32, 512, 8, 8, 128,
     {"block_rows": 8, "split": 1}, "64 query rows"),
]


@pytest.mark.parametrize("kernel,b,s,t,hkv,g,hd,fields,why", ATTN_CLAMPS,
                         ids=[c[-1] for c in ATTN_CLAMPS])
def test_invalid_tuned_attention_entry_takes_the_fixed_rule(
        monkeypatch, kernel, b, s, t, hkv, g, hd, fields, why):
    _table(monkeypatch, "cuda", fields)
    assert pa.plan_from_params(b, s, t, hkv, g, hd, fields) is None
    got = pa.routed_plan(kernel, b, s, t, hkv, g, hd, SMS, None, {})
    assert got == pa.attention_plan(b, s, t, hkv, g, hd, SMS)


def test_tuned_block_rows_are_cut_to_the_chunk():
    """A bucket's block_rows above a ragged chunk's S launch S rows a
    block, as `attention_plan` cuts them."""
    got = pa.plan_from_params(3, 7, 112, 2, 4, 64,
                              {"block_rows": 8, "split": 1})
    assert got == pa.attention_plan(3, 7, 112, 2, 4, 64, SMS) == \
        pa.AttentionPlan(7, 1, 3 * 2)


def test_valid_tuned_attention_entry_is_launched(monkeypatch):
    calls = _table(monkeypatch, "cuda", {"block_rows": 4, "split": 4})
    got = pa.routed_plan("prefill_attention_paged", 2, 32, 4096, 10, 4, 128,
                         SMS, None, {}, ps=32, pool=300)
    assert got == pa.AttentionPlan(4, 4, 2 * 10 * 8 * 4)
    assert calls == [("prefill_attention_paged",
                      dict(b=2, t=4096, hkv=10, g=4, hd=128, s=32, ps=32,
                           p=300))]


def test_explicit_route_bypasses_the_table(monkeypatch):
    def no_table(kernel, **shape):
        raise AssertionError("an explicit route consulted the table")
    monkeypatch.setattr(tune, "get_route", no_table)
    kn, m, n, k = "binary_gemm_packed", 4, 5120, 5120
    forced = dict(small_m=1, block_n=128, split=8)
    words = torch.int32
    assert bg.routed_plan(kn, m, n, k, SMS, True, words, "cuda", forced) == \
        bg.plan_from_params(kn, m, n, k, SMS, True, forced)
    assert bg.routed_plan(kn, m, n, k, SMS, True, words, "cuda", {}) == \
        bg.gemm_plan(kn, m, n, k, SMS)
    with pytest.raises(ValueError, match="cannot launch"):
        bg.routed_plan(kn, 40, n, k, SMS, True, words, "cuda", forced)
    # a split the table would refuse at T 512 (wide body): the kernel takes it
    assert pa.routed_plan("prefill_attention", 1, 32, 512, 10, 4, 128, SMS,
                          "cuda", {"block_rows": 8, "split": 8}).split == 8
    # on the CPU every route runs the plain version, without the table
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3, 100)).astype(np.float32))
    b = pack_bits(torch.from_numpy(rng.normal(size=(7, 100))
                                   .astype(np.float32)))
    want = bg.binary_gemm_packed_rhs_plain(a, b, 100)
    for route in ("xla", "float", "vpu", "mxu", "cuda"):
        assert torch.equal(bg.dispatch_binary_gemm(a, b, 100, route=route),
                           want)
    with pytest.raises(ValueError, match="unknown binary_gemm route"):
        bg.dispatch_binary_gemm(a, b, 100, route="bogus")


@pytest.mark.parametrize("route", ["xla", "float", "pallas", "vpu"])
def test_a_card_table_naming_a_plain_route_raises(monkeypatch, tmp_path,
                                                  route):
    kernel = "decode_attention" if route == "pallas" else "binary_gemm"
    shape = dict(b=4, t=512, hkv=10, g=4, hd=128) if route == "pallas" \
        else dict(m=4, n=5120, kw=160, pl=1)
    table = {"_meta": {"backend": "nvidia-h100-80gb-hbm3"},
             kernel: {tune.bucket_key(shape): {"route": route,
                                               "params": {}}}}
    path = tmp_path / "nvidia-h100-80gb-hbm3.json"
    path.write_text(json.dumps(table))
    monkeypatch.setattr(tune, "cache_path", lambda backend=None: path)
    with pytest.raises(ValueError, match="launches no kernel on the card"):
        tune.get_route(kernel, **shape)
    with pytest.raises(ValueError, match="launches no kernel"):
        tune.check_card_route(kernel, route)


# ---------------------------------------------------------------------------
# ServingEngine.kernel_routes and the CLI lines, against JAX's
# ---------------------------------------------------------------------------
ENGINES = {"contiguous": dict(slots=2, max_len=16, freeze=True, kv_bits=1),
           "paged": dict(slots=2, max_len=16, freeze=True, kv_bits=1,
                         prefill_chunk=4, page_size=4)}


@pytest.fixture(scope="module")
def qwen2():
    jcfg, cfg, jp, _, pp, _ = params("qwen2-72b")
    return jcfg, cfg, jp, pp


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_kernel_routes_equal_jax_s(qwen2, kind):
    jcfg, cfg, jp, pp = qwen2
    kw = ENGINES[kind]
    got = ServingEngine(cfg, pp, **kw).kernel_routes()
    want = JaxEngine(jcfg, jp, **kw).kernel_routes()
    assert got == want
    assert any(k.startswith("binary_gemm_fused") for k in got)
    assert any(k.startswith("decode_attention" + ("_paged" if kind == "paged"
                                                  else "[")) for k in got)


ROUTE_LINE = re.compile(r"^kernel route ")


def test_cli_prints_jax_s_kernel_route_lines(capsys, monkeypatch):
    argv = ["--arch", "qwen2-72b", "--smoke", "--freeze", "--kv-bits", "1",
            "--batch", "1", "--prompt-len", "4", "--max-new", "1",
            "--prefill-chunk", "4", "--page-size", "4"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    mine = [ln for ln in capsys.readouterr().out.splitlines()
            if ROUTE_LINE.match(ln)]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if ROUTE_LINE.match(ln)]
    assert len(mine) == 8 and mine == theirs
