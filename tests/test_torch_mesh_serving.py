"""Serving over a mesh (`ServingEngine(mesh=)`, `serving.scheduler`) on
repeated CPU devices, against the single-device port engine (itself held to
the JAX engine by the other serving tests); the mirror of
`tests/test_sharded_serving.py`, which skips on a one-device host.

  * data=2 x model=2: every one of JAX's DECODE_ARCHS, greedy and sampled
    rows, gives the single-device engine's tokens bit for bit;
  * data=4, paged pool + prefix cache + chunked admission on JAX's shared
    prefix traffic: the same tokens, four shards of residency, and the
    pool's replicas byte-equal after every poll;
  * each shard's residency counts only the tensors it holds (a data row's
    'model' 0 shard: the params, the row's cache and state; the others
    nothing), and a mesh's admission runs under no route pin, through the
    route table as one device's does;
  * a MoE shard's router sees exactly its shard's rows: the sublayer's
    output at capacity factor 0.5 equals JAX's `moe_ffn` called eagerly on
    those rows;
  * the serving CLI with `--mesh 2,2 --device cpu` prints the single-device
    CLI's `req i:` lines, after JAX's mesh line and one residency line per
    shard.
"""
import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layers import QuantMode as JaxQuantMode
from repro.kernels import tune as jtune
from repro.models import common as JC
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core.packed import resident_weight_bytes
from repro_torch.kernels import tune
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer as T
from repro_torch.models.api import ATTENTION_FAMILIES, get_model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_parity import np_to_jax

DECODE_ARCHS = ["qwen2-72b", "musicgen-large", "llama-3.2-vision-11b",
                "falcon-mamba-7b", "recurrentgemma-2b", "dbrx-132b"]


def _mesh(data, model=1):
    return make_serving_mesh(data, model, devices=["cpu"] * (data * model))


def _params(cfg, seed=0):
    return get_model(cfg).init(torch.Generator().manual_seed(seed),
                               device="cpu")


def _requests(cfg, rng):
    """Mixed-length, mixed-temperature batch (ragged admission order,
    greedy and sampled rows, early-finishing slots): JAX's."""
    reqs = []
    for n, m, t in [(7, 6, 0.0), (12, 5, 0.8), (3, 8, 0.0), (9, 4, 0.0)]:
        kw = {}
        if cfg.family == "vlm":
            kw["img_emb"] = rng.standard_normal(
                (cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab, n, dtype=np.int32),
            max_new_tokens=m, temperature=t, **kw))
    return reqs


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_scheduler_token_identical(arch):
    """data=2 x model=2 against one device: the same requests and seed,
    bit-identical tokens, with the packed cache where the family has one;
    the sampled row's too (one noise draw per step, split by rows)."""
    cfg = smoke_config(arch)
    params = _params(cfg)
    reqs = _requests(cfg, np.random.default_rng(0))
    kw = dict(max_len=64, freeze=True, slots=4, seed=7,
              kv_bits=1 if cfg.family in ATTENTION_FAMILIES else None)
    want = ServingEngine(cfg, params, **kw).generate(reqs)
    eng = ServingEngine(cfg, params, mesh=_mesh(2, 2), **kw)
    got = eng.generate(reqs)
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=f"{arch} request {i}")
    sched = eng.scheduler()
    assert [sh.rows for sh in sched._shards] == [2, 2]
    assert sched.decode_steps() == sched.stats["decode_steps"] > 0


def _pools_equal(sched) -> bool:
    first = sched._shards[0].cache
    return all(torch.equal(sh.cache[name], first[name])
               for sh in sched._shards[1:] for name in ("k", "v"))


def test_mesh_scheduler_paged_prefix_token_identical():
    """data=4: paged pool + prefix cache + chunked admission, a shared
    16-token prefix over 5 requests (JAX's traffic), served once whole and
    once after its first request alone, so that the others' hits pin pages
    shard 0 wrote. Tokens equal one device's; the pool's replicas are
    byte-equal after every poll; four shards of residency."""
    cfg = smoke_config("qwen2-72b")
    params = _params(cfg)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, 16, dtype=np.int32)
    reqs = [Request(prompt=np.concatenate(
                [shared, rng.integers(0, cfg.vocab, 5, dtype=np.int32)]),
                    max_new_tokens=6) for _ in range(5)]
    kw = dict(max_len=64, freeze=True, slots=4, kv_bits=1, prefill_chunk=4,
              page_size=8, prefix_cache=True)
    for batches in ([reqs], [reqs[:1], reqs[1:]]):
        one = ServingEngine(cfg, params, **kw)
        want = [t for b in batches for t in one.generate(b)]
        eng = ServingEngine(cfg, params, mesh=_mesh(4), **kw)
        sched = eng.scheduler()
        got, shard_of = {}, {}
        start = sched._start_admission

        def admit(slot, rid, req, poison=0.0):
            shard_of[rid] = slot // sched._rows
            return start(slot, rid, req, poison)

        sched._start_admission = admit
        for batch in batches:
            for r in batch:
                sched.submit(r)
            while not sched.idle:
                for c in sched.poll(drain=True):
                    got[c.rid] = c
                assert _pools_equal(sched)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i].tokens, w,
                                          err_msg=f"request {i}")
        hits = [rid for rid, c in got.items() if c.cached_tokens]
        assert hits and sched.stats["prefix_hits"] == len(hits)
    assert {shard_of[rid] for rid in hits} == {1, 2, 3, 0}
    per_dev = eng.resident_bytes_per_device()
    assert len(per_dev) == 4
    assert all(d["total"] > 0 and d["cache"] > 0 for d in per_dev.values())


def test_mesh_rejects_bad_shapes():
    cfg = smoke_config("qwen2-72b")
    params = _params(cfg)
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(cfg, params, slots=3, mesh=_mesh(2))
    with pytest.raises(ValueError, match="resident_bytes_per_device"):
        ServingEngine(cfg, params, slots=2).resident_bytes_per_device()


def test_mesh_residency_counts_each_shards_own_tensors():
    """data=2 x model=2: a data row's 'model' 0 shard holds the params, its
    two slots' cache rows and serving state; the 'model' 1 shards hold
    nothing (the engine splits no layer over 'model')."""
    cfg = smoke_config("qwen2-72b")
    eng = ServingEngine(cfg, _params(cfg), slots=4, max_len=32, freeze=True,
                        kv_bits=1, mesh=_mesh(2, 2))
    per = eng.resident_bytes_per_device()
    assert list(per) == [f"cpu (data {d}, model {m})"
                         for d in (0, 1) for m in (0, 1)]
    wb = resident_weight_bytes(eng.params)
    row = ServingEngine(cfg, eng.params, slots=2, max_len=32, kv_bits=1)
    cache = row.resident_cache_bytes()["total"]
    for d in (0, 1):
        own, other = per[f"cpu (data {d}, model 0)"], \
            per[f"cpu (data {d}, model 1)"]
        assert own["weights"] == wb["binary"] + wb["other"] > 0
        assert own["cache"] == cache > 0 and own["state"] > 0
        assert own["total"] == own["weights"] + own["cache"] + own["state"]
        assert other == {"weights": 0, "cache": 0, "state": 0, "total": 0}


def test_mesh_admission_runs_unpinned(monkeypatch):
    """A mesh's admission resolves the route table as one device's does:
    no route pin is on while a shard prefills (whole prompt or chunk)."""
    cfg = smoke_config("phi3-medium-14b")
    params = _params(cfg)
    reqs = _requests(cfg, np.random.default_rng(2))
    for extra in ({}, dict(prefill_chunk=4)):
        eng = ServingEngine(cfg, params, max_len=64, freeze=True, slots=4,
                            kv_bits=1, mesh=_mesh(2, 2), **extra)
        sched, pins = eng.scheduler(), []

        def pinned(real):
            def call(*a, **kw):
                pins.append(dict(tune._ROUTE_OVERRIDE))
                return real(*a, **kw)
            return call
        monkeypatch.setattr(sched, "model", dataclasses.replace(
            sched.model, prefill=pinned(sched.model.prefill),
            prefill_chunk=pinned(sched.model.prefill_chunk)))
        eng.generate(reqs)
        assert len(pins) >= len(reqs) and all(p == {} for p in pins)


def test_moe_router_sees_its_shards_rows(monkeypatch):
    """dbrx at capacity factor 0.5 on a data=2 mesh: each decode step's
    MoE sublayer gets its shard's 2 rows (inactive ones included), and its
    output equals JAX's `moe_ffn` on exactly those rows and params."""
    cfg = smoke_config("dbrx-132b").scaled(capacity_factor=0.5)
    params = _params(cfg)
    seen = []
    real = T.moe_ffn

    def record(p, x, kind, mode, **kw):
        out = real(p, x, kind, mode, **kw)
        seen.append((p, x, kind, mode, kw, out[0]))
        return out

    eng = ServingEngine(cfg, params, slots=4, max_len=32, mesh=_mesh(2))
    reqs = [Request(np.arange(n, dtype=np.int32) + n, max_new_tokens=3)
            for n in (5, 9, 3)]
    monkeypatch.setattr(T, "moe_ffn", record)
    eng.generate(reqs)
    decode = [s for s in seen if s[1].shape[:2] == (2, 1)]
    assert decode and all(s[1].shape[0] == 2 for s in decode)
    for p, x, kind, mode, kw, out in decode[:2]:
        with jtune.gspmd_safe():
            want, _ = JC.moe_ffn(np_to_jax(to_numpy_tree(p)),
                                 jnp.asarray(x.numpy()), kind,
                                 JaxQuantMode(mode.value), top_k=kw["top_k"],
                                 capacity_factor=kw["capacity_factor"])
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def _cli(*argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--arch", "phi3-medium-14b", "--smoke", "--freeze",
                         "--kv-bits", "1", "--batch", "3", "--prompt-len",
                         "8", "--max-new", "5", "--device", "cpu",
                         *argv]) == 0
    return buf.getvalue().splitlines()


def test_cli_mesh_prints_single_device_tokens():
    one, mesh = _cli(), _cli("--mesh", "2,2")
    req = [ln for ln in one if ln.startswith("req ")]
    assert len(req) == 3
    assert [ln for ln in mesh if ln.startswith("req ")] == req
    assert "serving mesh: data=2 x model=2 over 4 of 4 devices" in mesh
    shard_lines = [ln for ln in mesh if ln.startswith("  cpu (data ")]
    assert len(shard_lines) == 4
    assert all("MB weights +" in ln and "serving state" in ln
               for ln in shard_lines)
