"""The port's dry run on the CPU: the dispatch-level counter
(`roofline.count`), the report (`roofline.report`), `launch.dryrun` and the
placed prefill / decode steps (`train.step.make_prefill_step(mesh=)`,
`make_decode_step(mesh=)`).

  * configs and report against the JAX package: `n_params` /
    `n_active_params` of every registry arch and smoke config,
    `model_flops` of every arch x shape, `roofline_row` of one record
    handed JAX's v5e constants;
  * the FLOP counter against `repro.roofline.hlo.analyze` of JAX's jitted
    single-device steps (dense train, prefill and decode; ssm and moe
    train; five compiles, one module fixture). The products are grouped
    by their FLOPs; the groups agree but for the named products below,
    which one side computes and the other does not (ROADMAP Queue C):
      - REMAT_TAIL: under cfg.remat the port's `torch.utils.checkpoint`
        recomputes each block's last product (the FFN's down projection,
        the Mamba block's out_proj), whose output the backward never
        reads; XLA drops that dead recomputation. +1 per layer, 2 T F D
        (2 T di D). Not in the MoE block: the router's gradient reads the
        experts' outputs, so the recomputation is live on both sides.
      - SOFTMAX_VJP: JAX's softmax backward takes each row's sum of
        dP * P as a dot, (B, Hkv, G, S, S) x (B, Hkv, G, S, S) ->
        (B, Hkv, G, S): 2 B H S S each, one per attention layer; the
        port's is elementwise.
      - SCAN_Y: JAX's sequential Mamba scan takes y_t = h_t . C_t as a
        dot, (B, di, N) x (B, N), and its VJP two more of the same size:
        3 per step and layer, 2 B di N each; the port's is elementwise.
  * conservation on 1 x 2, 2 x 1 and 2 x 2 fake meshes: the per-device
    FLOPs of the placed train step sum to the single-device step's (plus,
    where 'model' is 1, the float head's forward product, which
    `core.layers._float_grads` recomputes in the backward), and each
    position's argument bytes are `launch.shardings.resident_bytes`;
  * one weight on 2 x 1: gathered per use (forward and the backward's
    dx), its gradient slice sent back once;
  * the one-shard replay equals a full trace per device;
  * the placed prefill and decode steps (dense, moe, ssm): on 2 x 1 the
    single-device step's outputs bit for bit, on 2 x 2 within 1e-5;
  * `run_cell` OK on the overrides of JAX's dry-run test and at reduced
    prefill / decode cells, kernel 10 counted by its formula;
  * after a count the main path is as before: kernel 10 on a CPU tensor
    runs its plain version, launch tables untouched.
"""
from __future__ import annotations

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_port
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs.smoke import smoke_config as j_smoke
from repro.launch import mesh as j_mesh
from repro.models.api import get_model as j_get_model
from repro.roofline import report as j_report
from repro.roofline.hlo import (
    _CALLED_RE, _TRIP_RE, _dot_flops, analyze, parse_module,
)
from repro.train import step as JS
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core.layers import QuantMode, qmatmul
from repro_torch.core.placed import Placed
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import (
    cache_shardings, join, param_specs, place, resident_bytes,
)
from repro_torch.models.api import get_model
from repro_torch.optim.base import tree_leaves, tree_map
from repro_torch.roofline import count as C
from repro_torch.roofline import report
from repro_torch.train import step as PS

B, S = 4, 16
ARCH = {"dense": "phi3-medium-14b", "ssm": "falcon-mamba-7b",
        "moe": "dbrx-132b"}
CASES = [("dense", "train"), ("dense", "prefill"), ("dense", "decode"),
         ("ssm", "train"), ("moe", "train")]


# ---------------------------------------------------------------------------
# configs and report
# ---------------------------------------------------------------------------
def test_registry_matches_jax():
    assert list_archs() == j_list_archs()


@pytest.mark.parametrize("arch", list_archs())
def test_n_params_equal_jax(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (smoke_config(arch), j_smoke(arch))):
        assert mine.n_params() == theirs.n_params()
        assert mine.n_active_params() == theirs.n_active_params()


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax(arch):
    for shape in SHAPES:
        assert report.model_flops(arch, shape) == \
            j_report.model_flops(arch, shape)


def _record(arch="qwen2-72b", shape="train_4k"):
    return {"arch": arch, "shape": shape, "multi_pod": False,
            "status": "OK", "accum": 4, "n_devices": 256,
            "flops": 3.1e15, "bytes_accessed": 7.7e13,
            "collectives": {"total_bytes": 2.9e11},
            "memory": {"argument_size_in_bytes": 2.5e9,
                       "temp_size_in_bytes": 1.9e10}}


def test_roofline_row_is_jax_row_with_v5e_peaks():
    rec = _record()
    mine = report.roofline_row(rec, peak_flops=j_mesh.PEAK_FLOPS_BF16,
                               hbm_bw=j_mesh.HBM_BW, link_bw=j_mesh.ICI_BW)
    assert mine == j_report.roofline_row(rec)
    h100 = report.roofline_row(rec)
    assert h100["t_compute_s"] == rec["flops"] / 989.4e12
    assert h100["t_memory_s"] == rec["bytes_accessed"] / 3.35e12
    assert h100["t_collective_s"] == 2.9e11 / 450e9


def test_make_table(tmp_path):
    import json
    path = tmp_path / "r.jsonl"
    recs = [_record(), _record("phi3-medium-14b", "decode_32k"),
            {"arch": "x", "shape": "train_4k", "multi_pod": False,
             "status": "FAIL", "error": "ValueError: boom"},
            {"arch": "y", "shape": "long_500k", "multi_pod": False,
             "status": "SKIP", "reason": "long_500k needs sub-quadratic"}]
    path.write_text("\n".join(json.dumps(r) for r in recs))
    table = report.make_table(path)
    assert "datasheet" in table.splitlines()[0]
    assert "FAIL: ValueError: boom" in table and "SKIP" in table
    assert table.count("| qwen2-72b | train_4k |") == 1


# ---------------------------------------------------------------------------
# the FLOP counter against JAX's HLO count
# ---------------------------------------------------------------------------
def _jax_dots(text: str) -> collections.Counter:
    """{FLOPs of one dot: how many run} over the module, loops multiplied
    by their trip counts (as `analyze` counts them)."""
    comps = parse_module(text)
    out: collections.Counter = collections.Counter()

    def walk(name, mult):
        comp = comps[name]
        for op in comp.ops:
            if op.opcode == "dot":
                out[_dot_flops(op, comp)] += mult
            trip = 1
            if op.opcode == "while":
                m = _TRIP_RE.search(op.attrs)
                trip = int(m.group(1)) if m else 1
            for sub in _CALLED_RE.findall(op.attrs):
                if sub in comps:
                    walk(sub, mult * trip)
    walk(re.search(r"ENTRY\s+%?([\w.\-]+)", text).group(1), 1)
    return out


@pytest.fixture(scope="module")
def jax_counts():
    """(analyze's FLOPs, dots by FLOPs) of JAX's jitted single-device
    step, by case: five compiles."""
    out = {}
    for fam, kind in CASES:
        cfg = j_smoke(ARCH[fam])
        model = j_get_model(cfg)
        p = model.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
        if kind == "train":
            opt = JS.default_optimizer(cfg)
            low = jax.jit(JS.make_train_step(model, opt)).lower(
                p, opt.init(p), batch, None)
        elif kind == "prefill":
            low = jax.jit(JS.make_prefill_step(model, max_len=S)).lower(
                p, batch)
        else:
            low = jax.jit(JS.make_decode_step(model)).lower(
                p, jnp.zeros((B,), jnp.int32), model.init_cache(B, S),
                jnp.full((B,), S - 1, jnp.int32))
        text = low.compile().as_text()
        out[(fam, kind)] = (analyze(text)["flops"], _jax_dots(text))
    return out


def _port_count(cfg, kind, monkeypatch):
    """The port's single-device step counted: (report, matmul-class ops
    by FLOPs)."""
    seen: collections.Counter = collections.Counter()
    inner = C._Counter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        if func._overloadpacket not in C.flop_registry:
            return inner(self, func, types, args, kwargs)
        before = sum(s.flops for s in self.stats.values())
        out = inner(self, func, types, args, kwargs)
        if not self.quiet:
            seen[sum(s.flops for s in self.stats.values()) - before] += 1
        return out
    monkeypatch.setattr(C._Counter, "__torch_dispatch__", spy)
    model = get_model(cfg)
    with C.fake_mode():
        dev = torch.device("meta", 0)
        params = model.init(torch.Generator(), device=dev)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device=dev)}
        if kind == "train":
            opt = PS.default_optimizer(cfg)
            rep = C.count(PS.make_train_step(model, opt), params,
                          opt.init(params), batch)
        elif kind == "prefill":
            rep = C.count(PS.make_prefill_step(model, max_len=S), params,
                          batch)
        else:
            rep = C.count(
                PS.make_decode_step(model), params,
                torch.zeros((B,), dtype=torch.int32, device=dev),
                model.init_cache(B, S, device=dev),
                torch.full((B,), S - 1, dtype=torch.int32, device=dev))
    return rep, seen


def _named(cfg, kind) -> collections.Counter:
    """Port minus JAX, by a product's FLOPs: the named products of the
    module doc."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    out: collections.Counter = collections.Counter()
    if kind != "train":
        return out
    t = B * S
    if cfg.family == "ssm":
        di = cfg.expand * d
        if cfg.remat:
            out[2 * t * di * d] += layers                  # REMAT_TAIL
        out[2 * B * di * cfg.ssm_state] -= 3 * S * layers  # SCAN_Y
        return out
    if cfg.remat and not cfg.n_experts:
        out[2 * t * f * d] += layers                       # REMAT_TAIL
    out[2 * B * cfg.n_heads * S * S] -= layers             # SOFTMAX_VJP
    return out


@pytest.mark.parametrize("fam,kind", CASES)
def test_flops_equal_jax_but_named_products(fam, kind, jax_counts,
                                            monkeypatch):
    cfg = smoke_config(ARCH[fam])
    rep, port = _port_count(cfg, kind, monkeypatch)
    total, dots = jax_counts[(fam, kind)]
    assert sum(dots[k] * k for k in dots) == total
    assert C.total(rep, "flops") == sum(k * n for k, n in port.items())
    named = _named(cfg, kind)
    diff = collections.Counter(port)
    diff.subtract(dots)
    assert {k: v for k, v in diff.items() if v} == \
        {k: v for k, v in named.items() if v}
    assert C.total(rep, "flops") - total == sum(k * n for k, n in
                                                named.items())
    if (fam, kind) == ("dense", "train"):   # the gap measured at take-up
        assert C.total(rep, "flops") - total == 2_080_768


def test_index_backward_counted_in_place():
    """The backward of table[ids] accumulates into one fresh zeros buffer
    of the table's size, as autograd runs it for a plain tensor, not the
    two (zeros and an out-of-place index_put) it takes under a dispatch
    mode such as the counter's own."""
    with C.fake_mode():
        dev = torch.device("meta", 0)
        table = torch.empty((1000, 64), device=dev, requires_grad=True)
        ids = torch.zeros((8, 16), dtype=torch.long, device=dev)
        rep = C.count(lambda t, i: torch.autograd.grad(t[i].sum(), [t]),
                      table, ids)
    mem = rep["devices"]["meta:0"]["memory"]
    assert mem["output_size_in_bytes"] == 1000 * 64 * 4
    # the table-sized gradient beside the loss and its seed gradient
    # (the gathered rows are freed once summed)
    assert mem["temp_size_in_bytes"] == 1000 * 64 * 4 + 2 * 4


# ---------------------------------------------------------------------------
# placed steps on fake meshes
# ---------------------------------------------------------------------------
def _fake_inputs(cfg, shape, kind="train", rows=8, seq=16):
    """(mesh, placed params, specs, step args) on fake devices, made inside
    `fake_mode()`; shape (data, model)."""
    data, mdl = shape
    mesh = make_host_mesh(mdl, devices=C.fake_devices(data * mdl, mdl))
    model = get_model(cfg)
    params = model.init(torch.Generator(), device="cpu")
    specs = param_specs(params)
    placed = tree_map(lambda x, sp: place(x, mesh, sp), params, specs)
    dev0 = mesh.devices.flat[0]
    if kind == "train":
        opt = PS.default_optimizer(cfg)
        state = PS.init_placed_state(opt, placed, mesh)
        batch = {"tokens": torch.zeros((rows, seq), dtype=torch.int32,
                                       device=dev0)}
        step = PS.make_train_step(model, opt, mesh=mesh, specs=specs)
        return mesh, (placed, state), step, (placed, state, batch)
    if kind == "prefill":
        batch = {"tokens": torch.zeros((rows, seq), dtype=torch.int32,
                                       device=dev0)}
        step = PS.make_prefill_step(model, max_len=seq, mesh=mesh,
                                    specs=specs)
        return mesh, (placed,), step, (placed, batch)
    whole = model.init_cache(rows, seq, device="cpu")
    sh = cache_shardings(mesh, whole, cfg.family, rows)
    cache = {k: place(v, mesh, sh[k].spec) for k, v in whole.items()}
    step = PS.make_decode_step(model, mesh=mesh, specs=specs)
    return mesh, (placed, cache), step, (
        placed, torch.zeros((rows,), dtype=torch.int32, device=dev0), cache,
        torch.full((rows,), seq - 1, dtype=torch.int32, device=dev0))


def _single_flops(cfg, rows=8, seq=16):
    model = get_model(cfg)
    opt = PS.default_optimizer(cfg)
    with C.fake_mode():
        dev = torch.device("meta", 0)
        params = model.init(torch.Generator(), device=dev)
        rep = C.count(PS.make_train_step(model, opt), params,
                      opt.init(params),
                      {"tokens": torch.zeros((rows, seq), dtype=torch.int32,
                                             device=dev)})
    return C.total(rep, "flops")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_placed_step_conserves_flops_and_holds_resident_bytes(shape):
    cfg = smoke_config(ARCH["dense"])
    with C.fake_mode():
        mesh, held, step, args = _fake_inputs(cfg, shape)
        rep = C.count(step, *args, mesh=mesh)
        resident = resident_bytes(held, mesh)
        names = {str(mesh.devices[ix]): mesh.shard_name(ix)
                 for ix in np.ndindex(*mesh.devices.shape)}
        batch = args[-1]["tokens"]
        for dev, r in rep["devices"].items():
            extra = batch.numel() * batch.element_size() \
                if dev == str(batch.device) else 0
            assert r["memory"]["argument_size_in_bytes"] == \
                resident[names[dev]] + extra
    # HEAD_RECOMPUTE: on a 'model' 1 mesh the placed float head's backward
    # (`core.layers._float_grads`) recomputes its forward product, 2 T D V
    # over the shards' rows; split over 'model' it takes the parts' path
    head = 2 * 8 * 16 * cfg.d_model * cfg.vocab if shape[1] == 1 else 0
    assert C.total(rep, "flops") == _single_flops(cfg) + head
    assert len(rep["devices"]) == shape[0] * shape[1]


def test_one_weight_gathered_per_use_on_2x1():
    """A (64, 32) master cut over 'data' on 2 x 1: the row on data 0
    gathers data 1's piece in the forward and again in the backward's dx
    (never kept), and sends its gradient slice back once."""
    with C.fake_mode():
        mesh = make_host_mesh(1, devices=C.fake_devices(2))
        w = torch.zeros((64, 32), dtype=torch.float32, device="cpu")
        pieces = place(w, mesh, ("data", None))
        piece = pieces.flat[1].numel() * 4

        def step(pieces):
            leaves = np.empty(pieces.shape, dtype=object)
            for ix in np.ndindex(*pieces.shape):
                leaves[ix] = pieces[ix].detach().requires_grad_(True)
            handle = Placed(leaves, mesh, ("data", None), (0, 0))
            x = torch.ones((8, 64), device=mesh.devices[0, 0],
                           requires_grad=True)
            y = qmatmul(x, handle, QuantMode.BBP_DET, train=True)
            return torch.autograd.grad(y.sum(), [x, *leaves.flat])
        rep = C.count(step, pieces, mesh=mesh)
    d0, d1 = (rep["devices"][str(d)]["collectives"]
              for d in mesh.devices.flat)
    assert d0["per_op"] == {"gather": 2 * piece}
    assert d0["counts"] == {"gather": 2}
    assert d1["per_op"] == {"reduce": piece}


@pytest.mark.parametrize("arch,shape,kind", [
    ("phi3-medium-14b", (4, 2), "train"),
    ("falcon-mamba-7b", (4, 1), "train"),
    ("phi3-medium-14b", (4, 2), "prefill"),
    ("phi3-medium-14b", (4, 2), "decode")])
def test_one_shard_replay_equals_full_trace(arch, shape, kind):
    cfg = smoke_config(arch)
    reps = []
    for one in (True, False):
        with C.fake_mode():
            mesh, _, step, args = _fake_inputs(cfg, shape, kind, seq=8)
            rep = C.count(step, *args, mesh=mesh, one_shard=one)
            del rep["result"]
        for r in list(rep["devices"].values()) + [rep["host"]]:
            r.pop("ops")
        reps.append(rep)
    assert reps[0] == reps[1]


# ---------------------------------------------------------------------------
# the placed prefill and decode steps on real (CPU) tensors
# ---------------------------------------------------------------------------
PLACED = [("phi3-medium-14b", {}), ("falcon-mamba-7b", {}),
          ("dbrx-132b", {"capacity_factor": 1.0})]


def _prefill_decode(cfg, params, tokens, mesh=None, placed=True):
    """[prefill logits, its cache, decode logits, the cache after one
    step], the cache joined whole over a mesh; params placed by JAX's
    specs where `placed`, else replicated."""
    model = get_model(cfg)
    specs = None if mesh is None else param_specs(params) if placed \
        else tree_map(lambda _: (), params)
    p = params if mesh is None else tree_map(
        lambda x, sp: place(x, mesh, sp), params, specs)
    pre = PS.make_prefill_step(model, max_len=tokens.shape[1] + 2,
                               mesh=mesh, specs=specs)
    logits, cache = pre(p, {"tokens": tokens})

    def whole(c):
        if mesh is None:
            return {k: v.clone() for k, v in c.items()}
        sh = cache_shardings(mesh, {k: a.flat[0] for k, a in c.items()},
                             cfg.family, tokens.shape[0])
        return {k: join(a, mesh, sh[k].spec) for k, a in c.items()}
    c1 = whole(cache)
    dec = PS.make_decode_step(model, mesh=mesh, specs=specs)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32)
    logits2, cache = dec(p, tok, cache, pos)
    return [logits, c1, logits2, whole(cache)]


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread, as the mesh train tests run it: a multi-
    threaded CPU matmul may split a product's rows by their count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single_runs(one_thread):
    out = {}
    for arch, over in PLACED:
        cfg = smoke_config(arch).scaled(**over)
        params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (4, 8)).astype(np.int32))
        out[arch] = (cfg, to_numpy_tree(params), tokens,
                     _prefill_decode(cfg, params, tokens))
    return out


def _leaves(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _hold(got, want, rel):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if rel == 0 or not g.is_floating_point():
            assert torch.equal(g, w)
        else:
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= rel * scale


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("arch", [a for a, _ in PLACED])
def test_placed_prefill_and_decode(arch, shape, single_runs):
    """2 x 1: the single-device step bit for bit; 2 x 2: within 1e-5 of
    each output's largest magnitude. On 4 x 1 each shard is one row, which
    the CPU's BLAS multiplies by another kernel than a block of rows (up
    to 2.4e-7 apart): the placed step is the replicated one on that mesh
    bit for bit, and within 1e-6 of the single device."""
    cfg, np_params, tokens, want = single_runs[arch]
    data, mdl = shape
    mesh = make_host_mesh(mdl, devices=["cpu"] * (data * mdl))
    got = _prefill_decode(cfg, to_port(np_params), tokens, mesh)
    if shape == (4, 1):
        _hold(got, _prefill_decode(cfg, to_port(np_params), tokens, mesh,
                                   placed=False), 0)
    _hold(got, want, {(2, 1): 0, (4, 1): 1e-6, (2, 2): 1e-5}[shape])


# ---------------------------------------------------------------------------
# run_cell and the main path
# ---------------------------------------------------------------------------
SMALL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
             d_ff=512, vocab=2048, attn_chunk=256)


def test_run_cell_small_train_ok():
    """JAX's test_dryrun_subprocess_small cell (musicgen-large train_4k
    at its overrides) on the 16 x 16 production mesh of fake devices."""
    r = dryrun.run_cell("musicgen-large", "train_4k", overrides=SMALL,
                        verbose=False)
    assert r["status"] == "OK" and r["n_devices"] == 256
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["collectives"]["total_bytes"] > 0
    mem = r["memory"]
    assert set(mem) == {"argument_size_in_bytes", "temp_size_in_bytes",
                        "output_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"]
    assert len(r["per_device"]["flops"]) == 256


@pytest.mark.parametrize("arch,shape", [("phi3-medium-14b", "prefill_32k"),
                                        ("falcon-mamba-7b", "decode_32k")])
def test_run_cell_reduced_prefill_decode(arch, shape):
    over = dict(n_layers=1, d_model=128, vocab=512)
    if arch == "phi3-medium-14b":
        over.update(n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
                    attn_chunk=512)
    r = dryrun.run_cell(arch, shape, overrides=over, verbose=False)
    assert r["status"] == "OK" and r["flops"] > 0
    if arch == "falcon-mamba-7b":
        # kernel 10 met once per layer and batch shard, counted by formula
        assert r["kernels"] == {"selective_scan": 16}


def test_long_500k_skipped_with_jax_reason():
    r = dryrun.run_cell("phi3-medium-14b", "long_500k", verbose=False)
    assert r["status"] == "SKIP" and "sub-quadratic" in r["reason"]


def test_cli_writes_skip_and_fail_lines(tmp_path, monkeypatch):
    """The CLI appends a line per cell; a cell that raises (the multi-pod
    mesh's 512 positions, more than fake devices name apart) is written
    FAIL with its error, and the CLI exits 1."""
    import json
    out = tmp_path / "d.jsonl"
    for extra in ([], ["--multi-pod"]):
        monkeypatch.setattr("sys.argv", ["dryrun", "--arch",
                                         "phi3-medium-14b", "--shape",
                                         "long_500k" if not extra else
                                         "decode_32k", "--out", str(out),
                                         *extra])
        with pytest.raises(SystemExit) as e:
            dryrun.main()
        assert e.value.code == (1 if extra else 0)
    skip, fail = (json.loads(x) for x in out.read_text().splitlines())
    assert skip["status"] == "SKIP" and fail["status"] == "FAIL"
    assert fail["multi_pod"] and "8 bits" in fail["error"]
    with pytest.raises(ValueError):
        C.fake_devices(257, 16)
    assert len({str(d) for d in C.fake_devices(256, 16)}) == 256


def test_main_path_untouched_after_a_count():
    """A count (here one reaching kernel 10) leaves every kernel's launch
    table as it was; after it kernel 10 on CPU tensors runs its plain
    version and counts no launch, on a meta tensor outside a count it
    raises, and the counter's hooks are gone."""
    import importlib
    tables = [importlib.import_module(f"repro_torch.kernels.{m}").launches
              for m in ("binary_gemm", "pack", "decode_attention",
                        "prefill_attention", "selective_scan")]
    before = [dict(t) for t in tables]
    with C.fake_mode():
        dev = torch.device("meta", 0)
        C.count(lambda x: ss.selective_scan(
            x, x, torch.empty((1, 4, 2), device=dev),
            torch.empty((1, 4, 2), device=dev),
            torch.empty((3, 2), device=dev)),
            torch.empty((1, 4, 3), device=dev))
    assert [dict(t) for t in tables] == before
    assert PS.repeat_hook is None and not C._ACTIVE
    ss.reset_launches()
    g = torch.Generator().manual_seed(0)
    dt = torch.rand((1, 4, 3), generator=g)
    bm, cm = torch.randn((1, 4, 2), generator=g), torch.randn((1, 4, 2),
                                                              generator=g)
    a = -torch.rand((3, 2), generator=g)
    y, h = ss.selective_scan(dt, dt, bm, cm, a)
    y2, h2 = ss.selective_scan_plain(dt, dt, bm, cm, a)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert ss.launches["selective_scan"] == 0
    with pytest.raises(ValueError):
        ss.selective_scan(*(t.to("meta") for t in (dt, dt, bm, cm, a)))
