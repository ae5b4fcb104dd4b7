"""The port's data-parallel training over a mesh (`train.step.
make_train_step(mesh=)`, `Trainer(mesh=)`, `CheckpointManager.restore(
shardings=)`, `launch/train.py --mesh`) on the CPU, meshes over repeated
CPU devices (`make_host_mesh(model, devices=["cpu"] * n)`).

The JAX package's sharded step is GSPMD over its param shardings, which
computes the single-device step's function; so the oracle of a sharded
step is the single-device step of the port (every family) and of the JAX
package (dense and moe):

  * a one-shard mesh gives the single-device step bit for bit (params,
    optimizer state, metrics), accum 1 and 2;
  * data 2, data 4 and 2 x 2 meshes, accum 1 and 2, smoke size, every
    family: the loss and metrics to LOSS_REL, the gradients the optimizer
    is given and the moments to GRAD_REL of each tensor's largest
    magnitude (the shards' float32 sums are taken in another order than
    one backward's), params held through the moments (`_torch_moments`);
  * the MoE hazard: the keep mask, positions and drop_frac of every
    layer's routing equal the single-device step's exactly, at capacity
    factor 1.0 (routes dropped), and the shards' slices of it tile it;
  * the 'bbp' hazard: every draw of the shards (replays under remat
    included) is its rows of the single-device step's draw at that site,
    or the whole of a weight's;
  * the Trainer resumes across meshes: on the mesh that wrote the
    checkpoint bit for bit, on data 4 and one device within tolerance,
    every restored leaf byte-equal to what was saved;
  * `restore(shardings=)` -> `join` round trips, packed leaves included,
    and `save` of a placed tree writes whole arrays.

Tolerances: LOSS_REL = 1e-6 (a mean of the shards' means against one
mean); GRAD_REL = 1e-5 (the largest measured is 1.0e-6); against JAX,
tests/test_torch_lm_train.py's 1e-5 (loss) and 5e-5 (gradients).
"""
import importlib
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_train import (  # noqa: F401 (_one_thread: autouse fixture)
    FAMILIES, GRAD_REL, JAX_GRAD_REL, JAX_LOSS_REL, LOSS_REL, ROWS, _batch,
    _cfg, _close, _held, _masters, _mesh, _one_thread, _record_draws,
    _single, _step,
)
from _torch_parity import jax_to_np, to_port
from repro.configs.smoke import smoke_config as jax_smoke
from repro.models.api import get_model as jax_get_model
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.smoke import smoke_config
from repro_torch.core.packed import PackedWeight
from repro_torch.launch import train as launch_train
from repro_torch.launch.shardings import (
    join_leaf, param_shardings, replicated,
)
from repro_torch.models.api import get_model
from repro_torch.optim.base import tree_leaves, tree_map
from repro_torch.train.trainer import TrainConfig, Trainer

C = importlib.import_module("repro_torch.models.common")

MESHES = {"data2": (2, 1), "data4": (4, 1), "2x2": (2, 2)}


# ---------------------------------------------------------------------------
# the step: one shard bit for bit, more shards within tolerance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_shard_mesh_is_the_single_device_step(family, accum):
    cfg = _cfg(family)
    got = _step(cfg, _masters(family), _batch(cfg), mesh=_mesh((1, 1)),
                accum=accum)
    want = _single(family, accum)
    assert got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got[:3]), tree_leaves(want[:3]), strict=True))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_is_the_single_device_step(family, mesh, accum):
    cfg = _cfg(family)
    got = _step(cfg, _masters(family), _batch(cfg), mesh=_mesh(MESHES[mesh]),
                accum=accum)
    counts = _held(got, _single(family, accum), (LOSS_REL, GRAD_REL))
    print(f"{family} {mesh} accum {accum}: params off by more than "
          f"{GRAD_REL}: {counts}")


def test_batch_must_split_over_the_shards():
    cfg = _cfg("dense")
    with pytest.raises(ValueError, match="does not split"):
        _step(cfg, _masters("dense"), _batch(cfg, rows=6),
              mesh=_mesh((4, 1)))
    with pytest.raises(ValueError, match="does not split"):
        _step(cfg, _masters("dense"), _batch(cfg, rows=4),
              mesh=_mesh((4, 1)), accum=2)


# ---------------------------------------------------------------------------
# against the JAX package's single-device step (dense and moe)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sharded_step_is_the_jax_single_device_step(family):
    """The 2 x 2 step's loss, metrics and gradients against JAX's
    value_and_grad of the loss on the whole batch (the sharded step's
    function), from JAX's init."""
    arch, over = FAMILIES[family]
    jcfg = jax_smoke(arch).scaled(**dict(over, remat=False))
    cfg = _cfg(family)
    jmodel = jax_get_model(jcfg)
    jp = jax_to_np(jmodel.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg, seed=1)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, key=None), has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, g, m = _step(cfg, jp, batch, mesh=_mesh((2, 2)))
    want = dict(jax_to_np(metrics), loss=np.asarray(loss))
    assert set(m) == set(want)
    for k in m:
        assert m[k] == pytest.approx(float(want[k]), rel=JAX_LOSS_REL,
                                     abs=1e-7), k
    _close(g, to_port(jax_to_np(grads)), JAX_GRAD_REL, "grads")


# ---------------------------------------------------------------------------
# the hazards: MoE routes over the global batch, 'bbp' draws by rows
# ---------------------------------------------------------------------------
def _record_routes(monkeypatch):
    seen = {"route": [], "shard": []}
    route, shard_route = C.moe_route, C.shard_route

    def rec_route(*a, **kw):
        r = route(*a, **kw)
        seen["route"].append(r)
        return r

    def rec_shard(*a, **kw):
        r = shard_route(*a, **kw)
        seen["shard"].append(r)
        return r
    monkeypatch.setattr(C, "moe_route", rec_route)
    monkeypatch.setattr(C, "shard_route", rec_shard)
    return seen


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_routes_are_the_global_batchs(monkeypatch, accum):
    """At capacity factor 1.0 routes are dropped: the shards' keep masks,
    positions, experts and drop_frac are the single-device step's, every
    layer and microbatch (remat replays included), exactly."""
    cfg = _cfg("moe", remat=True)
    seen = _record_routes(monkeypatch)
    _step(cfg, _masters("moe"), _batch(cfg), accum=accum)
    one = seen["route"][:]
    assert not seen["shard"]
    assert any(float(r["drop_frac"]) > 0 for r in one)
    seen["route"].clear()
    mesh = _mesh((4, 1))
    _step(cfg, _masters("moe"), _batch(cfg), mesh=mesh, accum=accum)
    whole, shards = seen["route"], seen["shard"]
    # one routing forward per microbatch (no gradient: no remat replay);
    # the single-device step routes each layer in its forward and again
    # in remat's replay, forwards first in each microbatch
    assert len(whole) == cfg.n_layers * accum
    layer_calls = len(one) // accum
    assert layer_calls == 2 * cfg.n_layers
    for i, r in enumerate(whole):
        mbi, layer = divmod(i, cfg.n_layers)
        ref = one[mbi * layer_calls + layer]
        for k in ("keep", "pos", "expert", "gate_idx"):
            assert torch.equal(r[k], ref[k]), (i, k)
        assert float(r["drop_frac"]) == float(ref["drop_frac"])
        assert r["cap"] == ref["cap"]
    # each shard's slices of a layer's routes tile it, in shard order
    per = len(shards) // (4 * accum)
    for i, r in enumerate(whole):
        mbi, layer = divmod(i, cfg.n_layers)
        parts = [shards[(mbi * 4 + j) * per + layer] for j in range(4)]
        for k in ("keep", "pos", "expert"):
            assert torch.equal(torch.cat([p[k] for p in parts]), r[k])
        assert all(float(p["drop_frac"]) == float(r["drop_frac"])
                   for p in parts)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_bbp_draws_are_the_global_batchs(monkeypatch, family):
    """quant 'bbp', remat on: each shard's draw at each call of a site (the
    forward's and remat's replay) is its rows of the single-device step's
    draw there (a weight's, the whole of it); the step's losses agree."""
    cfg = _cfg(family, quant="bbp", remat=True)
    seen = _record_draws(monkeypatch)
    want = _step(cfg, _masters(family), _batch(cfg), gen_seed=3)
    one = seen[:]
    seen.clear()
    got = _step(cfg, _masters(family), _batch(cfg), mesh=_mesh((2, 1)),
                gen_seed=3)
    calls = len(one)
    # a MoE first routes the whole batch in a forward without gradient
    # (no replay), which draws what the single-device forward draws
    pre = len(seen) - 2 * calls
    assert pre == (calls // 2 if cfg.n_experts else 0), (pre, calls)
    for (site, per_row, u), (s, pr, v) in zip(one[:pre], seen[:pre]):
        assert (s, pr) == (site, per_row) and torch.equal(u, v), site
    seen = seen[pre:]
    shards = [seen[:calls], seen[calls:]]
    half = ROWS // 2
    for i, (site, per_row, u) in enumerate(one):
        for j, part in enumerate(shards):
            s, pr, v = part[i]
            assert (s, pr) == (site, per_row)
            want_u = u[j * half:(j + 1) * half] if per_row else u
            assert torch.equal(v, want_u), (site, j)
    assert got[3]["loss"] == pytest.approx(want[3]["loss"], rel=LOSS_REL)


# ---------------------------------------------------------------------------
# the Trainer across meshes, the launcher
# ---------------------------------------------------------------------------
def _tc(ckpt_dir, **kw):
    base = dict(steps=4, global_batch=8, seq_len=16, ckpt_every=2,
                ckpt_dir=str(ckpt_dir), log_every=1, lr=1e-2, keep=1)
    base.update(kw)
    return TrainConfig(**base)


def _stop_after_2(tr):
    orig = tr._batch

    def hooked(step):
        if step == 1:
            tr._stop = True
        return orig(step)
    tr._batch = hooked


def test_trainer_resumes_across_meshes(tmp_path):
    """data 2: a straight 4-step run; a run stopped after 2 steps; resumed
    on data 2 it equals the straight run bit for bit (losses of steps 2-3,
    params, moments); resumed on data 4 and on one device it restores
    every leaf byte for byte and stays within tolerance."""
    cfg = smoke_config("musicgen-large")
    straight = Trainer(cfg, _tc(tmp_path / "s"), mesh=_mesh((2, 1)))
    out_s = straight.run()
    killed = Trainer(cfg, _tc(tmp_path / "k"), mesh=_mesh((2, 1)))
    _stop_after_2(killed)
    assert killed.run()["final_step"] == 2
    saved = CheckpointManager(tmp_path / "k").restore(
        2, straight.full_state())
    losses = {h["step"]: h["loss"] for h in out_s["history"]}
    for where, kw in (("data2", dict(mesh=_mesh((2, 1)))),
                      ("data4", dict(mesh=_mesh((4, 1)))),
                      ("one", dict(device="cpu"))):
        shutil.copytree(tmp_path / "k", tmp_path / where)
        tr = Trainer(cfg, _tc(tmp_path / where), **kw)
        assert tr.maybe_restore() and tr.start_step == 2
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tr.full_state()), tree_leaves(saved), strict=True))
        out = tr.run()
        got = {h["step"]: h["loss"] for h in out["history"]}
        assert sorted(got) == [2, 3]
        if where == "data2":
            assert all(got[s] == losses[s] for s in got)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(tr.full_state()),
                tree_leaves(straight.full_state()), strict=True))
        else:
            for s in got:
                assert got[s] == pytest.approx(losses[s], rel=1e-5), where
        if "mesh" in kw:
            per = tr.resident_bytes_per_device()
            assert len(per) == kw["mesh"].devices.size
            assert len({b["total"] for b in per.values()}) == 1


def test_trainer_mesh_checkpoints_hold_whole_arrays(tmp_path):
    """A data-2 trainer's checkpoint is the single-device trainer's format:
    the same leaf names and shapes; the JSON summary of the launcher."""
    cfg = smoke_config("phi3-medium-14b")
    tr = Trainer(cfg, _tc(tmp_path / "m", steps=2), mesh=_mesh((2, 1)))
    tr.run()
    one = Trainer(cfg, _tc(tmp_path / "o", steps=2), device="cpu")
    one.run()
    names = [json.loads((d / "step_2" / "manifest.json").read_text())
             ["leaves"] for d in (tmp_path / "m", tmp_path / "o")]
    assert [(e["name"], e["shape"]) for e in names[0]] == \
        [(e["name"], e["shape"]) for e in names[1]]
    with pytest.raises(ValueError, match="not both"):
        Trainer(cfg, _tc(tmp_path), mesh=_mesh((2, 1)), device="cpu")


def test_launch_train_mesh_host_on_cpu(tmp_path, capsys):
    assert launch_train.main([
        "--arch", "phi3-medium-14b", "--smoke", "--steps", "2", "--batch",
        "4", "--seq", "16", "--mesh", "host", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["final_step"] == 2 and not out["interrupted"]
    assert CheckpointManager(tmp_path).latest_step() == 2
    with pytest.raises(ValueError, match="needs 256 devices"):
        launch_train.main(["--arch", "phi3-medium-14b", "--smoke",
                           "--mesh", "production"])


# ---------------------------------------------------------------------------
# restore(shardings=) and save of a placed tree
# ---------------------------------------------------------------------------
def test_restore_onto_shardings_round_trips(tmp_path):
    """A frozen tree (PackedWeights with and without folds) and fp32
    masters saved whole, restored onto param_shardings of a 2 x 2 mesh:
    each piece has its spec's shape (a PackedWeight's words split, its
    threshold and flip whole), and join gives back what was saved; a
    placed tree saved with its shardings writes whole arrays."""
    cfg = smoke_config("nemotron-4-15b")
    model = get_model(cfg)
    masters = model.init(torch.Generator().manual_seed(0), device="cpu")
    frozen = model.freeze(masters)
    mesh = _mesh((2, 2))
    mgr = CheckpointManager(tmp_path, keep=10, async_save=False)
    for step, tree in ((1, masters), (2, frozen)):
        mgr.save(step, tree)
        sh = param_shardings(mesh, tree)
        placed = mgr.restore(step, tree, sh)
        back = tree_map(join_leaf, placed, sh)
        for a, b in zip(tree_leaves(back), tree_leaves(tree), strict=True):
            if isinstance(b, PackedWeight):
                assert isinstance(a, PackedWeight) and a.fold == b.fold
                assert torch.equal(a.packed, b.packed)
                for x, y in ((a.thresh, b.thresh), (a.flip, b.flip)):
                    assert (x is None) == (y is None)
                    assert x is None or torch.equal(x, y)
            else:
                assert torch.equal(a, b)
        wq = placed["blocks"]["attn"]["wq"]
        assert wq.shape == (2, 2)
        if step == 2:
            w = tree["blocks"]["ffn"]["w_up"]
            pieces = placed["blocks"]["attn"]["wq"].flat[0]
            assert isinstance(pieces, PackedWeight)
            up = placed["blocks"]["ffn"]["w_up"]
            assert all(p.thresh is not None and p.thresh.shape ==
                       w.thresh.shape for p in up.flat)
        mgr.save(step + 10, placed, shardings=sh)
        again = mgr.restore(step + 10, tree)
        for a, b in zip(tree_leaves(again), tree_leaves(tree), strict=True):
            x, y = (a.packed, b.packed) if isinstance(b, PackedWeight) \
                else (a, b)
            assert torch.equal(x, y)
    # a None entry restores the plain leaf
    sh = replicated(mesh, masters)
    sh["embed"] = None
    out = mgr.restore(1, masters, sh)
    assert isinstance(out["embed"], torch.Tensor)
    assert isinstance(out["lm_head"], np.ndarray)
