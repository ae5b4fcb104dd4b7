"""The port's training over data x model as the JAX package places it
(`train.step.make_train_step(mesh=, specs=)`, `Trainer(mesh=)`), on the
CPU, meshes over repeated CPU devices (`make_host_mesh(model,
devices=["cpu"] * n)`).

The masters and the S-AdaMax state live in pieces cut by
`launch.shardings.param_specs` (the JAX package's rules); a weight is
gathered over 'data' only while a forward or backward uses it; its
'model' parts compute on the 'model' devices; each piece's gradient is
summed over the batch shards on the piece's device. JAX's own sharded step
raises under jax 0.9.0 (`DuplicateSpecError` at `_embed`, ROADMAP Queue
C), so the oracles are the single-device steps:

  * on meshes whose 'model' axis is 1 the placed step is the replicated
    step (the data-parallel layout) bit for bit, every family, accum 1 and 2;
  * on 1 x 2, 2 x 2 and 1 x 4 it is within LOSS_REL / GRAD_REL of the
    single-device step, every family (largest measured 3.3e-6 of a
    tensor's largest magnitude, moe on 1 x 4), params held through the
    moments; so are qwen2's biases, nemotron's LayerNorm and sq_relu FFN,
    llama4-scout's top-1 experts (at its stated tolerance) and a 'pod' x
    'data' x 'model' mesh; dense and moe on 2 x 2 within JAX_LOSS_REL /
    JAX_GRAD_REL of JAX's jitted single-device `make_train_step`;
  * 'bbp' on 2 x 2 draws what one device draws, remat replays included;
  * every piece is the slice JAX's `param_specs` names; on 2 x 2 each
    position holds its share of every sharded leaf (a quarter where the
    spec names both axes) and the replicated leaves; no saved tensor of
    the backward has a gathered master's whole shape;
  * the Trainer resumes bit for bit on 2 x 2 and from data-2 and
    one-device checkpoints; `launch/train.py --mesh host --model 2`;
  * phi3-medium-14b at full depth placed on the production mesh of meta
    devices: under 1 GB a position (about 168 GB replicated).

No smoke leaf of the registry fails to divide over 2 x 2 (checked below);
a leaf that does not divide raises ValueError, as JAX's `device_put` /
`jit(out_shardings=)` do for such a NamedSharding.
"""
import importlib
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_train import (  # noqa: F401 (_one_thread: autouse fixture)
    FAMILIES, GRAD_REL, JAX_GRAD_REL, JAX_LOSS_REL, LOSS_REL, LR, ROWS,
    _batch, _cfg, _close, _held, _masters, _mesh, _one_thread,
    _record_draws, _single, _step, _t,
)
from _torch_moments import first_step_scale, held_through_moments
from _torch_parity import jax_to_np, np_leaves, to_port
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.ap2 import ap2_exponent as j_ap2_exponent
from repro.launch.shardings import param_specs as j_param_specs
from repro.models.api import get_model as jax_get_model
from repro.optim.base import Optimizer as JOptimizer
from repro.train.step import default_optimizer as j_default_optimizer
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core import ap2 as tap2
from repro_torch.core.placed import Placed, _axes
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (
    Mesh, make_host_mesh, make_production_mesh,
)
from repro_torch.launch.shardings import (
    param_specs, place, place_leaf, replicated, resident_bytes,
)
from repro_torch.launch.specs import abstract_opt_state, abstract_params
from repro_torch.models.api import get_model
from repro_torch.models.transformer import pick
from repro_torch.optim.base import tree_leaves, tree_map, tree_map_with_path
from repro_torch.optim.shift_adamax import shift_adamax
from repro_torch.train.step import (
    default_optimizer, init_placed_state, make_train_step, state_shardings,
)
from repro_torch.train.trainer import TrainConfig, Trainer

OB = importlib.import_module("repro_torch.optim.base")

MODEL_1 = {"data2": (2, 1), "data4": (4, 1)}
MODEL_N = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b), strict=True))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", list(MODEL_1))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_1_is_the_replicated_step_bit_for_bit(family, mesh, accum):
    """'model' 1: every gather is a copy, a piece's gradient the slice of
    the shard's whole one, the sums in one order: params, moments,
    gradients and metrics equal the replicated step's bit for bit."""
    cfg, m = _cfg(family), _mesh(MODEL_1[mesh])
    got = _step(cfg, _masters(family), _batch(cfg), mesh=m, accum=accum,
                placed=True)
    want = _step(cfg, _masters(family), _batch(cfg), mesh=m, accum=accum)
    assert got[3] == want[3]
    assert _same(got[:3], want[:3])


@pytest.mark.parametrize("mesh", list(MODEL_N))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_split_is_the_single_device_step(family, mesh):
    """Projections, vocabulary and experts split over 'model': loss and
    metrics to LOSS_REL, gradients and moments to GRAD_REL of each
    tensor's largest magnitude, params through the moments."""
    cfg = _cfg(family)
    got = _step(cfg, _masters(family), _batch(cfg), mesh=_mesh(MODEL_N[mesh]),
                placed=True)
    counts = _held(got, _single(family, 1), (LOSS_REL, GRAD_REL))
    print(f"{family} {mesh}: params off by more than {GRAD_REL}: {counts}")


@pytest.mark.parametrize("arch,rel", [
    ("qwen2-72b", GRAD_REL), ("nemotron-4-15b", GRAD_REL),
    # wv's gradient is a cancelling sum (its largest 7.1e-4, wo's 47):
    # float32 rounding of the 'model' parts' sums reaches 2.35e-5 of it
    # (1 x 2 and 2 x 2; every other leaf within 5.7e-7)
    ("llama4-scout-17b-a16e", JAX_GRAD_REL)])
def test_other_layouts_on_2x2_are_the_single_device_step(arch, rel):
    """The leaves FAMILIES' configs lack: QKV biases over 'model' (qwen2),
    LayerNorm's bias and the two-matrix sq_relu FFN (nemotron), top-1
    experts (llama4-scout), on 2 x 2 within the tolerances."""
    cfg = smoke_config(arch).scaled(remat=False)
    np_p = to_numpy_tree(get_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"))
    want = _step(cfg, np_p, _batch(cfg))
    got = _step(cfg, np_p, _batch(cfg), mesh=_mesh((2, 2)), placed=True)
    _held(got, want, (LOSS_REL, rel))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_pod_mesh_is_the_single_device_step(family):
    """A ('pod', 'data', 'model') mesh of 2 x 2 x 2: the params replicate
    over 'pod' (pure data parallelism, as JAX's multipod mesh), each pod's
    rows are batch shards; within the tolerances of one device's step."""
    grid = np.empty((2, 2, 2), dtype=object)
    for ix in np.ndindex(*grid.shape):
        grid[ix] = torch.device("cpu")
    cfg = _cfg(family)
    got = _step(cfg, _masters(family), _batch(cfg),
                mesh=Mesh(grid, ("pod", "data", "model")), placed=True)
    _held(got, _single(family, 1), (LOSS_REL, GRAD_REL))


def test_accum_2_on_2x2_is_the_single_device_step():
    cfg = _cfg("moe")
    got = _step(cfg, _masters("moe"), _batch(cfg), mesh=_mesh((2, 2)),
                accum=2, placed=True)
    _held(got, _single("moe", 2), (LOSS_REL, GRAD_REL))


def _stash_jax(opt):
    return JOptimizer(init=lambda p: (opt.init(p), None),
                      update=lambda g, s, p: (
                          lambda out: (out[0], (out[1], g)))(
                              opt.update(g, s[0], p)))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted single-device make_train_step by family, from JAX's
    init: (metrics, gradients, params, S-AdaMax state) as numpy."""
    cache = {}

    def get(family):
        if family not in cache:
            arch, over = FAMILIES[family]
            jcfg = jax_smoke(arch).scaled(**dict(over, remat=False))
            opt = _stash_jax(j_default_optimizer(jcfg, LR))
            p = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
            b = {k: jnp.asarray(v) for k, v in _batch(_cfg(family),
                                                        seed=1).items()}
            p2, (st2, g), m = jax.jit(j_make_train_step(
                jax_get_model(jcfg), opt))(p, opt.init(p), b, None)
            cache[family] = (jax_to_np(p), jax_to_np(m), jax_to_np(g),
                             jax_to_np(p2), jax_to_np(st2))
        return cache[family]
    return get


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_2x2_is_the_jax_single_device_step(jax_steps, family):
    jp, jm, jg, jp2, jst = jax_steps(family)
    cfg = _cfg(family)
    p, st, g, m = _step(cfg, jp, _batch(cfg, seed=1), mesh=_mesh((2, 2)),
                        placed=True)
    want = dict(jm)
    assert set(m) == set(want)
    for k in m:
        assert m[k] == pytest.approx(float(want[k]), rel=JAX_LOSS_REL,
                                     abs=1e-7), k
    _close(g, to_port(jg), JAX_GRAD_REL, "grads")
    _close(st.m, to_port(jst["m"]), JAX_GRAD_REL, "opt m")
    _close(st.u, to_port(jst["u"]), JAX_GRAD_REL, "opt u")
    tu = np_leaves(to_numpy_tree(st.u))
    ju = np_leaves(to_numpy_tree(to_port(jst["u"])))
    counts = held_through_moments(
        np_leaves(to_numpy_tree(p)), np_leaves(to_numpy_tree(to_port(jp2))),
        np_leaves(to_numpy_tree(st.m)),
        np_leaves(to_numpy_tree(to_port(jst["m"]))),
        [tap2.ap2_exponent(1.0 / (_t({"u": u})["u"] + 1e-8)).numpy()
         for u in tu],
        [np.asarray(j_ap2_exponent(1.0 / (jnp.asarray(u) + 1e-8)))
         for u in ju], JAX_GRAD_REL, first_step_scale(LR))
    print(f"{family} 2 x 2 against JAX: params parted {counts}")


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_bbp_draws_on_2x2_are_one_devices(monkeypatch, family):
    """quant 'bbp', remat on: each data shard's draw at every call of a
    site (forward and remat's replay) is its rows of one device's draw
    there, a weight's draw the whole of one device's (its 'model' parts
    take their slices of it); the losses agree."""
    cfg = _cfg(family, quant="bbp", remat=True)
    seen = _record_draws(monkeypatch)
    want = _step(cfg, _masters(family), _batch(cfg), gen_seed=3)
    one = seen[:]
    seen.clear()
    got = _step(cfg, _masters(family), _batch(cfg), mesh=_mesh((2, 2)),
                gen_seed=3, placed=True)
    calls = len(one)
    pre = len(seen) - 2 * calls          # a MoE's routing forward
    assert pre == (calls // 2 if cfg.n_experts else 0), (pre, calls)
    for (site, per_row, u), (s, pr, v) in zip(one[:pre], seen[:pre]):
        assert (s, pr) == (site, per_row) and torch.equal(u, v), site
    seen = seen[pre:]
    half = ROWS // 2
    for j, part in enumerate((seen[:calls], seen[calls:])):
        for (site, per_row, u), (s, pr, v) in zip(one, part, strict=True):
            assert (s, pr) == (site, per_row)
            assert torch.equal(v, u[j * half:(j + 1) * half] if per_row
                               else u), (site, j)
    assert got[3]["loss"] == pytest.approx(want[3]["loss"], rel=LOSS_REL)


def test_quant_none_adamw_never_reaches_global_norm(monkeypatch):
    """quant 'none' (AdamW, the float products' placed path): the 2 x 2
    step within tolerance of one device's; neither this step nor
    S-AdaMax's reaches `optim.base.global_norm` (every optimizer of the
    step is elementwise, so a piece's update is its slice of the whole
    leaf's)."""
    def refuse(*a, **k):
        raise AssertionError("global_norm reached")
    monkeypatch.setattr(OB, "global_norm", refuse)
    monkeypatch.setattr(OB, "clip_by_global_norm", refuse)
    cfg = _cfg("dense", quant="none")
    got = _step(cfg, _masters("dense"), _batch(cfg), mesh=_mesh((2, 2)),
                placed=True)
    want = _step(cfg, _masters("dense"), _batch(cfg))
    assert got[3]["loss"] == pytest.approx(want[3]["loss"], rel=LOSS_REL)
    _close(got[2], want[2], GRAD_REL, "grads")
    _close(got[1].m, want[1].m, GRAD_REL, "opt m")
    _close(got[1].v, want[1].v, GRAD_REL, "opt v")
    cfg = _cfg("dense")
    _step(cfg, _masters("dense"), _batch(cfg), mesh=_mesh((2, 2)),
          placed=True)


# ---------------------------------------------------------------------------
# placement, residency, what the backward keeps
# ---------------------------------------------------------------------------
def _jax_specs(family) -> dict:
    """{path: JAX's PartitionSpec as a tuple} of the family's smoke tree."""
    arch, over = FAMILIES[family]
    jp = jax.eval_shape(jax_get_model(jax_smoke(arch).scaled(**over)).init,
                        jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        j_param_specs(jp), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in flat}


def _named_slice(shape, spec, mesh, index):
    """The slice of each dim a JAX spec names at mesh `index`, computed
    from the spec's entries (row-major over an entry's axes)."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        names = () if e is None else ((e,) if isinstance(e, str) else e)
        parts, rank = 1, 0
        for a in names:
            k = mesh.shape[a]
            parts, rank = parts * k, rank * k + index[
                mesh.axis_names.index(a)]
        out.append(slice(rank * n // parts, (rank + 1) * n // parts))
    return tuple(out)


def _tc(ckpt_dir, **kw):
    base = dict(steps=4, global_batch=8, seq_len=16, ckpt_every=2,
                ckpt_dir=str(ckpt_dir), log_every=1, lr=1e-2, keep=1)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pieces_are_the_slices_jax_param_specs_names(tmp_path, family):
    """Trainer(mesh=2 x 2): every piece of the params and of the moments is
    the slice of its leaf that the JAX package's `param_specs` names on
    the same tree; the counter replicates."""
    mesh = _mesh((2, 2))
    tr = Trainer(_cfg(family), _tc(tmp_path), mesh=mesh)
    specs = _jax_specs(family)
    whole_p, whole_s = tr.full_state()
    seen = []

    def check(path, pieces, leaf, m, u):
        name = "/".join(map(str, path))
        seen.append(name)
        for ix in np.ndindex(*mesh.devices.shape):
            cut = _named_slice(leaf.shape, specs[name], mesh, ix)
            assert torch.equal(pieces[ix], leaf[cut]), (name, ix)
            assert pieces[ix].device == mesh.devices[ix]
            for placed, w in ((m, whole_s.m), (u, whole_s.u)):
                assert placed[ix].shape == pieces[ix].shape, (name, ix)
    tree_map_with_path(check, tr.params, whole_p, tr.opt_state.m,
                       tr.opt_state.u)
    assert sorted(seen) == sorted(specs)
    assert all(int(s) == 0 for s in tr.opt_state.step.flat)


def _parts(spec, mesh) -> int:
    return int(np.prod([mesh.shape[a] for e in spec for a in _axes(e)]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_position_holds_its_share(tmp_path, family):
    """On 2 x 2 the sharded leaves' distinct pieces sum to the whole; each
    position holds each leaf's whole / (the parts its spec names), so
    where every sharded leaf names both axes a position holds a quarter
    of them plus the replicated leaves."""
    mesh = _mesh((2, 2))
    tr = Trainer(_cfg(family), _tc(tmp_path), mesh=mesh)
    whole_p, _ = tr.full_state()
    specs = param_specs(whole_p)
    nb = (lambda t: t.numel() * t.element_size())
    leaves, sp = tree_leaves(whole_p), []
    tree_map(lambda _, s: sp.append(s), whole_p, specs)
    sharded = sum(3 * nb(x) for x, s in zip(leaves, sp) if _parts(s, mesh) > 1)
    rep = sum(3 * nb(x) for x, s in zip(leaves, sp) if _parts(s, mesh) == 1) \
        + nb(tr.opt_state.step.flat[0])
    want = sum(3 * nb(x) // _parts(s, mesh) for x, s in zip(leaves, sp)) \
        + nb(tr.opt_state.step.flat[0])
    per = tr.resident_bytes_per_device()
    assert len(per) == 4
    for b in per.values():
        assert b["total"] == want
        if all(_parts(s, mesh) in (1, 4) for s in sp):
            assert b["total"] == sharded // 4 + rep
    distinct = {}
    for a, s in zip(tree_leaves(tr.params), sp):
        if _parts(s, mesh) > 1:
            for p in a.flat:
                distinct[id(p)] = nb(p)
    assert sum(distinct.values()) == sharded // 3


@pytest.mark.parametrize("quant", ["bbp_det", "bbp"])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_no_gathered_master_is_saved_for_the_backward(monkeypatch, family,
                                                     mesh, quant):
    """A saved_tensors_hooks over the placed step's forwards: no tensor
    kept for the backward has the whole shape of a master whose spec names
    'data' (projections, experts, embedding, head: per layer or stacked,
    either orientation), whatever its values: not the gathered weight,
    and under 'bbp' not the weight's draws; pieces are what it keeps.
    d_model 48 and 5 positions a row: no piece and no activation shares
    such a shape. (What the backward saves and frees inside itself, such
    as the head's recomputed float product, is not kept from the
    forward.)"""
    cfg, m = _cfg(family, quant=quant, d_model=48), _mesh(mesh)
    masters = get_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    whole, pieces = set(), set()

    def collect(x, s):
        layers = lambda t: [t] + (list(t.unbind(0)) if t.ndim >= 3 else [])
        for p in place(x, m, s).flat:
            pieces.update(tuple(v.shape) for v in layers(p))
        if "data" in {a for e in s for a in _axes(e)}:
            for w in layers(x):
                whole.update({tuple(w.shape), tuple(w.shape[::-1])})
    tree_map(collect, masters, param_specs(masters))
    assert not whole & pieces
    kept, backward = [], [False]
    grad = torch.autograd.grad

    def in_backward(*a, **kw):
        backward[0] = True
        try:
            return grad(*a, **kw)
        finally:
            backward[0] = False
    monkeypatch.setattr(torch.autograd, "grad", in_backward)

    def pack(t):
        if not backward[0]:
            kept.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _step(cfg, to_numpy_tree(masters), _batch(cfg, seq=5), mesh=m,
              placed=True, gen_seed=3 if quant == "bbp" else None)
    hits = [s for s in kept if s in whole]
    assert kept and not hits, hits
    assert {s for s in pieces if len(s) >= 2} & set(kept)


def test_the_model_ops_import_no_launcher_module():
    """The ops and the models take a placed master through `core.placed`:
    importing them loads no module of `repro_torch.launch`."""
    code = ("import sys, repro_torch.core.layers, repro_torch.models.common, "
            "repro_torch.models.transformer, repro_torch.models.ssm, "
            "repro_torch.models.ssm_lm; print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.launch')))")
    out = subprocess.run([sys.executable, "-c", code], env=os.environ,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_placed_handle_views_layers_and_gathers():
    """A Placed of a stacked (L, K, N) leaf: `[l]` / `unbind` / `pick` give
    layer l's handle, `gather` the whole layer on the row's device and
    its 'model' part m on that device, and the gather's backward hands
    each piece its slice of the gradient; a cut leading axis does not
    index."""
    mesh = _mesh((2, 2))
    x = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(0))
    arr = place(x, mesh, (None, "data", "model"))
    leaves = np.empty(arr.shape, dtype=object)
    for ix in np.ndindex(*arr.shape):
        leaves[ix] = arr[ix].clone().requires_grad_(True)
    h = Placed.of(leaves, mesh, (None, "data", "model"), (0, 0))
    assert h.shape == (3, 4, 6) and h.ndim == 3
    lay = h.unbind(0)[1]
    assert torch.equal(lay.gather(), x[1])
    assert torch.equal(pick({"w": h}, 1)["w"].gather(), x[1])
    assert torch.equal(lay.gather(1), x[1][:, 3:])
    assert torch.equal(lay.T.gather(), x[1].T)
    r = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    (lay.gather() * r).sum().backward()
    for ix in np.ndindex(*arr.shape):
        g = leaves[ix].grad
        want = torch.zeros(3, 2, 3)
        want[1] = r[2 * ix[0]:2 * ix[0] + 2, 3 * ix[1]:3 * ix[1] + 3]
        assert torch.equal(g, want), ix
    cut = torch.zeros(4, 4, 6)
    with pytest.raises(ValueError, match="layer axis"):
        Placed.of(place(cut, mesh, ("data",)), mesh, ("data",), (0, 0))[0]


def test_no_smoke_leaf_fails_to_divide_and_one_that_does_raises():
    """Every smoke config of the registry places on 2 x 2 and 1 x 4; a
    vocabulary of 125 rows does not divide over 'model' 2 and raises
    ValueError, as JAX's NamedSharding does."""
    for arch in ("phi3-medium-14b", "dbrx-132b", "musicgen-large",
                 "falcon-mamba-7b", "recurrentgemma-2b",
                 "llama-3.2-vision-11b", "nemotron-4-15b", "qwen2-72b",
                 "llama4-scout-17b-a16e", "deepseek-67b"):
        p = get_model(smoke_config(arch)).init(torch.Generator(),
                                              device="meta")
        for model in (2, 4):
            mesh = make_host_mesh(model, devices=["meta"] * 4)
            tree_map(lambda x, s: place(x, mesh, s), p, param_specs(p))
    cfg = _cfg("dense", vocab=125)
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(cfg, _tc("/nonexistent-unused"), mesh=_mesh((2, 2)))


# ---------------------------------------------------------------------------
# the Trainer, the launcher, the production mesh
# ---------------------------------------------------------------------------
def _stop_after_2(tr):
    orig = tr._batch

    def hooked(step):
        if step == 1:
            tr._stop = True
        return orig(step)
    tr._batch = hooked


def test_trainer_2x2_resumes_and_takes_other_layouts(tmp_path):
    """musicgen smoke: a straight 4-step run on 2 x 2; a run stopped after
    2 steps resumed on 2 x 2 equals it bit for bit (losses of steps 2-3,
    params, moments); step-2 checkpoints written on data 2, on one device
    and from the replicated layout restore onto 2 x 2 byte for byte
    and continue within tolerance."""
    cfg = smoke_config("musicgen-large")
    m22 = _mesh((2, 2))
    straight = Trainer(cfg, _tc(tmp_path / "s"), mesh=m22)
    losses = {h["step"]: h["loss"] for h in straight.run()["history"]}
    for name, kw in (("2x2", dict(mesh=m22)), ("data2", dict(mesh=_mesh(
            (2, 1)))), ("one", dict(device="cpu"))):
        writer = Trainer(cfg, _tc(tmp_path / name), **kw)
        _stop_after_2(writer)
        assert writer.run()["final_step"] == 2
        saved = writer.full_state()
        if name == "data2":            # the same state, replicated
            rep = replicated(_mesh((2, 1)), saved)
            CheckpointManager(tmp_path / "rep", async_save=False).save(
                2, tree_map(place_leaf, saved, rep), shardings=rep)
            tr = Trainer(cfg, _tc(tmp_path / "rep"), mesh=m22)
            assert tr.maybe_restore() and _same(tr.full_state(), saved)
        tr = Trainer(cfg, _tc(tmp_path / name), mesh=m22)
        assert tr.maybe_restore() and tr.start_step == 2
        assert _same(tr.full_state(), saved)
        got = {h["step"]: h["loss"] for h in tr.run()["history"]}
        assert sorted(got) == [2, 3]
        if name == "2x2":
            assert all(got[s] == losses[s] for s in got)
            assert _same(tr.full_state(), straight.full_state())
        else:
            for s in got:
                assert got[s] == pytest.approx(losses[s], rel=1e-5), name
    shutil.rmtree(tmp_path)


def test_launch_train_mesh_host_model_2(tmp_path, capsys):
    assert launch_train.main([
        "--arch", "phi3-medium-14b", "--smoke", "--steps", "2", "--batch",
        "4", "--seq", "16", "--mesh", "host", "--model", "2", "--device",
        "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["final_step"] == 2 and not out["interrupted"]
    per = out["resident_bytes_per_device"]
    assert sorted(per) == ["cpu (data 0, model 0)", "cpu (data 0, model 1)"]
    assert len({b["total"] for b in per.values()}) == 1
    assert CheckpointManager(tmp_path).latest_step() == 2
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "phi3-medium-14b", "--smoke",
                           "--mesh", "none", "--model", "2"])


def test_phi3_full_depth_on_the_production_mesh_of_meta_devices():
    """launch/specs.py's abstract params and S-AdaMax state of
    phi3-medium-14b at full depth (40 layers), placed by the JAX specs on
    the 16 x 16 production mesh of meta devices: each position holds
    under 1 GB, where the replicated layout holds the whole ~168 GB.
    Nothing is allocated."""
    cfg = get_config("phi3-medium-14b")
    params = abstract_params(cfg, get_model(cfg))
    state = abstract_opt_state(shift_adamax(1e-3), params)
    mesh = make_production_mesh(devices=["meta"] * 256)
    specs = param_specs(params)
    placed = tree_map(lambda x, s: place(x, mesh, s), params, specs)
    st = tree_map(lambda x, s: place(x, mesh, s), state,
                  state_shardings(state, params, specs, ()))
    whole = sum(x.numel() * x.element_size()
                for x in tree_leaves((params, state)))
    assert whole > 1.6e11
    per = resident_bytes((placed, st), mesh)
    assert len(per) == 256
    assert max(per.values()) < 1e9
    assert all(p.device.type == "meta" for a in tree_leaves(placed)
               for p in a.flat)
    print(f"phi3-medium-14b, 40 layers: params + S-AdaMax state "
          f"{whole / 1e9:.2f} GB whole, {max(per.values()) / 1e9:.4f} GB "
          f"a position of the 16 x 16 mesh")


def test_init_placed_state_mirrors_the_pieces():
    """The state initialised on the pieces: moments of each piece's shape
    at its mesh index, shared where the pieces are; one counter a
    device."""
    mesh = make_host_mesh(2, devices=["cpu"] * 4)
    cfg = _cfg("dense")
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = param_specs(params)
    p = tree_map(lambda x, s: place(x, mesh, s), params, specs)
    st = init_placed_state(default_optimizer(cfg, LR), p, mesh)
    for a, m in zip(tree_leaves(p), tree_leaves(st.m), strict=True):
        for ix in np.ndindex(*mesh.devices.shape):
            assert m[ix].shape == a[ix].shape and not m[ix].any()
            for jx in np.ndindex(*mesh.devices.shape):
                assert (a[ix] is a[jx]) == (m[ix] is m[jx])
    assert len({id(t) for t in st.step.flat}) == 1
    step = make_train_step(get_model(cfg), default_optimizer(cfg, LR),
                           mesh=mesh, specs=specs)
    p2, st2, _ = step(p, st, _t(_batch(cfg)))
    assert all(int(t) == 1 for t in st2.step.flat)
    assert all(a[ix] is b[ix] for a, b in zip(tree_leaves(p), tree_leaves(p2))
               for ix in np.ndindex(*mesh.devices.shape))
