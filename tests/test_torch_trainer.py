"""The port's LM trainer, its data, optimizers and checkpoints, against the
JAX package's where it has a counterpart, on the CPU at smoke size:

  * `SyntheticLM` batches equal JAX's to the token;
  * AdamW, SGD and EF-SignSGD's numerics against JAX's (1e-6 of each
    tensor's largest magnitude: float32 elementwise ops, an ulp apart where
    pow, sqrt or a mean round differently; signs and step counts exactly),
    and each optimizer's `donate` path equal to its functional one bit for
    bit;
  * the `Trainer`: the loss falls, a killed run resumes bit for bit,
    SIGTERM saves, the straggler watchdog, mode 'bbp', the clip (the
    counterparts of tests/test_trainer.py);
  * the `CheckpointManager`: round trip, async, gc, the packed format, the
    older layout (tests/test_checkpoint.py's counterparts), and checkpoints
    written by either package restored by the other (fp32 masters with
    S-AdaMax state, and packed_binary; words bit for bit);
  * a packed checkpoint restored to PackedWeights and served: greedy
    tokens equal the JAX engine's on the same checkpoint.
"""
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel, jax_to_np, np_to_jax, to_port
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.checkpoint.manager import _leaf_names as jax_leaf_names
from repro.configs.smoke import smoke_config as jax_smoke
from repro.core.bitpack import pack_bits as j_pack_bits
from repro.core.packed import PackedWeight as JaxPackedWeight
from repro.data.synthetic import LMDataConfig as JLMDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.kernels import tune
from repro.models.api import get_model as jax_get_model
from repro.optim.shift_adamax import shift_adamax as j_shift_adamax
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.checkpoint.manager import (
    CheckpointManager, leaves_with_names,
)
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import words_to_numpy
from repro_torch.core.packed import PackedWeight, freeze_params
from repro_torch.data.synthetic import LMDataConfig, SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.optim.base import tree_leaves, tree_map
from repro_torch.optim.shift_adamax import shift_adamax
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.trainer import TrainConfig, Trainer

jadamw = importlib.import_module("repro.optim.adamw")
jef = importlib.import_module("repro.optim.ef_signsgd")
tadamw = importlib.import_module("repro_torch.optim.adamw")
tef = importlib.import_module("repro_torch.optim.ef_signsgd")

REL = 1e-6
LM = "phi3-medium-14b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the trainer runs tens of small steps, which
    other workers' threads would otherwise crowd out."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tc(ckpt_dir, **kw):
    base = dict(steps=25, global_batch=8, seq_len=32, ckpt_every=10,
                ckpt_dir=str(ckpt_dir), log_every=5, lr=1e-2)
    base.update(kw)
    return TrainConfig(**base)


def _grads_tree(rng):
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "a": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                  "s": np.float32(rng.normal())}}


def _close(got, want, what):
    """The port's tree against JAX's, leaf by leaf in JAX's order (None
    holds no leaf in either)."""
    got = [x for _, x in leaves_with_names(got)]
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (b, a) in enumerate(zip(got, want)):
        b, a = b.numpy(), np.asarray(a)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} leaf {i}")
        else:
            assert_rel(b, a, rel=REL, what=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (3, 17, 0, 1), (3, 17, 1, 2), (5, 2, 3, 4)])
def test_synthetic_lm_matches_jax(seed, step, host, hosts):
    kw = dict(vocab=97, seq_len=33, global_batch=8, seed=seed, branching=3)
    got = SyntheticLM(LMDataConfig(**kw)).batch(step, host_id=host,
                                                 n_hosts=hosts)
    want = JSyntheticLM(JLMDataConfig(**kw)).batch(step, host_id=host,
                                                   n_hosts=hosts)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
OPTS = {"adamw": (lambda m: m.adamw(0.01, weight_decay=0.1)),
        "sgd": (lambda m: m.sgd(0.05)),
        "sgd_momentum": (lambda m: m.sgd(0.05, momentum=0.9))}


@pytest.mark.parametrize("kind", list(OPTS))
def test_optimizer_updates_match_jax(kind):
    """Three steps from init on both sides, the same gradients: updates and
    state; the port's donate path equals its functional one bit for bit."""
    rng = np.random.default_rng(1)
    params = _grads_tree(rng)
    jopt, topt = OPTS[kind](jadamw), OPTS[kind](tadamw)
    jst, tst = jopt.init(np_to_jax(params)), topt.init(to_port(params))
    dst = topt.init(to_port(params))
    for _ in range(3):
        g = _grads_tree(rng)
        ju, jst = jopt.update(np_to_jax(g), jst, np_to_jax(params))
        tu, tst = topt.update(to_port(g), tst, to_port(params))
        du, dst = topt.update(to_port(g), dst, to_port(params), donate=True)
        _close(tu, ju, f"{kind} update")
        _close(tst, jst, f"{kind} state")
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves((tu, tst)), tree_leaves((du, dst)), strict=True))


def test_shift_adamax_donate_is_bit_exact():
    rng = np.random.default_rng(2)
    params = _grads_tree(rng)
    opt = shift_adamax(1e-3)
    st, dst = opt.init(to_port(params)), opt.init(to_port(params))
    for _ in range(3):
        g = _grads_tree(rng)
        u, st = opt.update(to_port(g), st)
        du, dst = opt.update(to_port(g), dst, donate=True)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves((u, st)), tree_leaves((du, dst)), strict=True))


def test_ef_signsgd_matches_jax():
    rng = np.random.default_rng(3)
    params = _grads_tree(rng)
    jst, tst = jef.init_ef(np_to_jax(params)), tef.init_ef(to_port(params))
    for _ in range(2):
        g = _grads_tree(rng)
        js, jsc, jst = jef.ef_signsgd_compress(np_to_jax(g), jst)
        ts, tsc, tst = tef.ef_signsgd_compress(to_port(g), tst)
        _close(ts, js, "signs")
        _close(tsc, jsc, "scales")
        _close(tst.error, jst.error, "residual")
        assert all(x.dtype == torch.int8 for x in tree_leaves(ts))
    sums = tree_map(lambda s: s.to(torch.int32) * 3, ts)
    want = jef.ef_signsgd_decompress(
        jax.tree.map(lambda s: s.astype(jnp.int32) * 3, js), jsc, 4)
    _close(tef.ef_signsgd_decompress(sums, tsc, 4), want, "decompressed")
    assert tef.compressed_bytes(to_port(params)) == \
        jef.compressed_bytes(np_to_jax(params))


# ---------------------------------------------------------------------------
# the Trainer (tests/test_trainer.py's counterparts)
# ---------------------------------------------------------------------------
def test_loss_decreases(tmp_path):
    tr = Trainer(smoke_config("musicgen-large"), _tc(tmp_path, steps=40),
                 device="cpu")
    losses = [h["loss"] for h in tr.run()["history"]]
    assert losses[-1] < losses[0], losses


def test_resume_after_kill_is_bit_exact(tmp_path):
    """20 steps, 'killed'; a fresh Trainer resumes from step 20 and runs to
    30: its losses and its final params and optimizer state equal an
    uninterrupted 30-step run's bit for bit."""
    cfg = smoke_config("musicgen-large")
    Trainer(cfg, _tc(tmp_path / "a", steps=20), device="cpu").run()
    tr2 = Trainer(cfg, _tc(tmp_path / "a", steps=30), device="cpu")
    assert tr2.maybe_restore() and tr2.start_step == 20
    out2 = tr2.run()
    assert out2["final_step"] == 30
    tr3 = Trainer(cfg, _tc(tmp_path / "b", steps=30), device="cpu")
    out3 = tr3.run()
    l2 = {h["step"]: h["loss"] for h in out2["history"]}
    l3 = {h["step"]: h["loss"] for h in out3["history"]}
    common = sorted(set(l2) & set(l3))
    assert common and all(l2[s] == l3[s] for s in common)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((tr2.params, tr2.opt_state)),
        tree_leaves((tr3.params, tr3.opt_state)), strict=True))


def test_sigterm_saves_final_checkpoint(tmp_path):
    tr = Trainer(smoke_config("musicgen-large"), _tc(tmp_path, steps=1000),
                 device="cpu")
    orig, calls = tr._batch, []

    def hooked(step):
        calls.append(step)
        if len(calls) == 5:
            tr._stop = True           # as the SIGTERM handler does
        return orig(step)

    tr._batch = hooked
    out = tr.run()
    assert out["interrupted"]
    assert tr.ckpt.latest_step() == out["final_step"] == 5


def test_straggler_watchdog(tmp_path, monkeypatch):
    """Step 8 stalls 60x the others (on the trainer's clock, which the test
    drives: a loaded host makes wall times of 50 ms steps vary too much
    for a sleep to be told apart): it is recorded as a straggler, and the
    first step, however slow, does not seed the EMA."""
    import repro_torch.train.trainer as trainer_mod
    now = [0.0]
    monkeypatch.setattr(trainer_mod.time, "time", lambda: now[0])
    tr = Trainer(smoke_config("musicgen-large"),
                 _tc(tmp_path, steps=12, straggler_factor=2.5), device="cpu")
    orig = tr._batch

    def timed(step):
        now[0] += {0: 30.0, 8: 3.0}.get(step, 0.05)
        return orig(step)

    tr._batch = timed
    out = tr.run()
    assert out["stragglers"] == [8], (out, tr.step_times)


def test_bbp_stochastic_training_runs(tmp_path):
    cfg = smoke_config(LM).scaled(quant="bbp")
    out = Trainer(cfg, _tc(tmp_path, steps=6), device="cpu").run()
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_binary_weights_stay_clipped(tmp_path):
    tr = Trainer(smoke_config("musicgen-large"), _tc(tmp_path, steps=15,
                                                     lr=0.1), device="cpu")
    tr.run()
    assert float(tr.params["blocks"]["attn"]["wq"].abs().max()) <= 1.0


def test_mesh_and_shardings_name_the_sharded_item(tmp_path):
    """The two sharded entry points: Trainer(mesh=) over a one-shard mesh
    trains as one device does, bit for bit; restore(shardings=) places a
    leaf by its Sharding (a None entry: the plain leaf), and join gives it
    back."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import Sharding, join
    cfg = smoke_config(LM)
    tr = Trainer(cfg, _tc(tmp_path / "m", steps=3),
                 mesh=make_host_mesh(devices=["cpu"]))
    one = Trainer(cfg, _tc(tmp_path / "o", steps=3), device="cpu")
    losses = [[h["loss"] for h in t.run()["history"]] for t in (tr, one)]
    assert losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tr.full_state()), tree_leaves((one.params,
                                                   one.opt_state)),
        strict=True))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.arange(8.0).reshape(4, 2), "v": torch.zeros(2)})
    mesh = make_host_mesh(devices=["cpu"] * 2)
    out = mgr.restore(1, {"w": torch.zeros(4, 2), "v": torch.zeros(2)},
                      shardings={"w": Sharding(mesh, ("data",)), "v": None})
    assert out["w"].shape == (2, 1) and out["w"][1, 0].shape == (2, 2)
    assert torch.equal(join(out["w"], mesh, ("data",)),
                       torch.arange(8.0).reshape(4, 2))
    assert isinstance(out["v"], torch.Tensor)


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_checkpoint.py's counterparts)
# ---------------------------------------------------------------------------
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"blocks": {"wq": torch.randn(3, 8, 16, generator=g),
                       "scale": torch.ones(3, 8)},
            "embed": torch.rand(32, 8, generator=g) * 2 - 1,
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = _tree(0)
    mgr.save(10, tree)
    out = mgr.restore(10, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(out), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not list(tmp_path.glob("*.tmp"))


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = _tree(1)
    mgr.save(5, tree)
    tree["embed"].zero_()          # the save copied the values already
    mgr.wait()
    assert mgr.latest_step() == 5
    assert float(mgr.restore(5, tree)["embed"].abs().max()) > 0


def test_gc_keeps_last_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, {"w": torch.zeros(4)})
    assert mgr.all_steps() == [4, 5]


def test_packed_binary_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = {"wq": torch.rand(64, 128) * 2 - 1, "scale": torch.ones(64)}
    mgr.save(1, tree, packed_binary=True, binary_keys={"wq"})
    out = mgr.restore(1, tree)
    assert isinstance(out["wq"], PackedWeight)
    assert out["wq"].shape == (64, 128) and out["wq"].k == 64
    signs = torch.where(tree["wq"] >= 0, 1.0, -1.0)
    assert torch.equal(out["wq"].unpack(), signs)
    assert torch.equal(mgr.restore(1, tree, unpack=True)["wq"], signs)
    assert torch.equal(out["scale"], tree["scale"])
    assert (tmp_path / "step_1" / "arrays.npz").stat().st_size < 64 * 128 * 4 / 8


def test_legacy_layout_restores_as_signs(tmp_path):
    """The older layout: sign bits packed along the last logical axis and
    no "format" key; both packages restore it as +-1 floats."""
    w = np.random.default_rng(4).uniform(-1, 1, (6, 40)).astype(np.float32)
    step = tmp_path / "step_3"
    step.mkdir()
    np.savez(step / "arrays.npz", leaf_0=np.asarray(j_pack_bits(
        jnp.asarray(w))), leaf_1=np.arange(4, dtype=np.float32))
    (step / "manifest.json").write_text(json.dumps({"step": 3, "leaves": [
        {"name": "a", "key": "leaf_0", "shape": [6, 40], "dtype": "float32",
         "packed": True},
        {"name": "b", "key": "leaf_1", "shape": [4], "dtype": "float32",
         "packed": False}]}))
    signs = np.where(w >= 0, 1.0, -1.0)
    got = CheckpointManager(tmp_path).restore(
        3, {"a": torch.zeros(6, 40), "b": torch.zeros(4)})
    np.testing.assert_array_equal(got["a"].numpy(), signs)
    want = JaxManager(tmp_path).restore(3, {"a": jnp.zeros((6, 40)),
                                            "b": jnp.zeros(4)})
    np.testing.assert_array_equal(np.asarray(want["a"]), signs)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    """JAX masters and an S-AdaMax state after one step's moments."""
    cfg = jax_smoke(arch)
    opt = j_shift_adamax(1e-3)

    def make(key):
        p = jax_get_model(cfg).init(key)
        g = jax.tree.map(lambda x: jnp.full_like(x, 0.5), p)
        return p, opt.update(g, opt.init(p), p)[1]
    return jax.jit(make)(jax.random.PRNGKey(3))


def _by_name(pairs):
    return {name: leaf for name, leaf in pairs}


@pytest.mark.parametrize("arch", [LM, "recurrentgemma-2b"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch):
    jp, jst = _jax_state(arch)
    JaxManager(tmp_path, async_save=False).save(4, (jp, jst))
    like = to_port(jax_to_np((jp, jst)))
    got = CheckpointManager(tmp_path).restore(4, like)
    assert type(got[1]).__name__ == "AdaMaxState"
    jl = jax.tree_util.tree_leaves((jp, jst))
    want = dict(zip(jax_leaf_names((jp, jst)), jl))
    named = _by_name(leaves_with_names(got))
    assert list(named) == list(want)           # JAX's order, JAX's names
    for name, leaf in named.items():
        assert str(leaf.dtype).split(".")[1] == str(want[name].dtype)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("arch", [LM, "recurrentgemma-2b"])
def test_port_checkpoint_restores_into_jax(tmp_path, arch):
    jp, jst = _jax_state(arch)
    tree = to_port(jax_to_np((jp, jst)))
    CheckpointManager(tmp_path, async_save=False).save(6, tree)
    manifest = json.loads((tmp_path / "step_6" / "manifest.json").read_text())
    assert [e["name"] for e in manifest["leaves"]] == jax_leaf_names((jp, jst))
    got = JaxManager(tmp_path).restore(6, (jp, jst))
    assert type(got[1]).__name__ == "AdaMaxState"
    for name, a, b in zip(jax_leaf_names((jp, jst)),
                          jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves((jp, jst)), strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def _words_equal(port_pw, jax_pw):
    np.testing.assert_array_equal(words_to_numpy(port_pw.packed),
                                  np.asarray(jax_pw.packed))
    assert port_pw.k == jax_pw.k and port_pw.kind == jax_pw.kind


def test_packed_checkpoints_cross_both_ways(tmp_path):
    """packed_binary=True on fp32 masters, written by each package and
    restored by the other: PackedWeights with equal words; the manifests'
    dtypes name the masters' float32."""
    jp, _ = _jax_state(LM)
    tp = to_port(jax_to_np(jp))
    JaxManager(tmp_path / "j", async_save=False).save(1, jp,
                                                      packed_binary=True)
    CheckpointManager(tmp_path / "t", async_save=False).save(
        1, tp, packed_binary=True)
    from_jax = CheckpointManager(tmp_path / "j").restore(1, tp)
    from_port = JaxManager(tmp_path / "t").restore(1, jp)
    frozen = freeze_params(tp)
    for name, leaf in leaves_with_names(from_jax):
        want = _by_name(leaves_with_names(frozen))[name]
        if isinstance(want, PackedWeight):
            assert isinstance(leaf, PackedWeight) and leaf.orig_dtype == \
                torch.float32
            assert torch.equal(leaf.packed, want.packed), name
        else:
            assert torch.equal(leaf, want), name
    jnamed = dict(zip(jax_leaf_names(from_port), jax.tree_util.tree_leaves(
        from_port, is_leaf=lambda x: isinstance(x, JaxPackedWeight))))
    for name, leaf in leaves_with_names(frozen):
        if isinstance(leaf, PackedWeight):
            assert isinstance(jnamed[name], JaxPackedWeight)
            assert jnamed[name].orig_dtype == "float32"
            _words_equal(leaf, jnamed[name])
    for d in ("j", "t"):
        m = json.loads((tmp_path / d / "step_1" / "manifest.json").read_text())
        assert {e["dtype"] for e in m["leaves"]} == {"float32"}


def test_frozen_tree_with_folds_crosses_to_jax(tmp_path):
    """A frozen nemotron tree (its sq_relu w_up carries the folded
    threshold) saved by the port restores in JAX with words, thresholds,
    flips and the fold."""
    cfg = smoke_config("nemotron-4-15b")
    model = get_model(cfg)
    frozen = model.freeze(model.init(torch.Generator().manual_seed(0),
                                     device="cpu"))
    CheckpointManager(tmp_path, async_save=False).save(2, frozen)
    jcfg = jax_smoke("nemotron-4-15b")
    jm = jax_get_model(jcfg)
    like = jm.freeze(jm.init(jax.random.PRNGKey(0)))
    got = JaxManager(tmp_path).restore(2, like)
    w_up, j_up = frozen["blocks"]["ffn"]["w_up"], got["blocks"]["ffn"]["w_up"]
    _words_equal(w_up, j_up)
    assert j_up.fold == w_up.fold == "act:sq_relu"
    np.testing.assert_array_equal(np.asarray(j_up.thresh), w_up.thresh.numpy())
    np.testing.assert_array_equal(np.asarray(j_up.flip), w_up.flip.numpy())
    back = CheckpointManager(tmp_path).restore(2, frozen)
    assert torch.equal(back["blocks"]["ffn"]["w_up"].thresh, w_up.thresh)


@pytest.fixture
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.usefixtures("_flush_denormals")
def test_restored_packed_checkpoint_serves_jax_tokens(tmp_path):
    """Train two steps, save the masters with packed_binary=True, restore
    them as PackedWeights in each package and serve greedily (the default
    engine: whole prompts, float cache): the port's tokens equal the JAX
    engine's, and equal those of the port's engine on freeze(masters)."""
    cfg = smoke_config(LM)
    tr = Trainer(cfg, _tc(tmp_path / "run", steps=2), device="cpu")
    tr.run()
    tr.ckpt.save(2, tr.params, packed_binary=True)
    tr.ckpt.wait()
    port = CheckpointManager(tmp_path / "run").restore(2, tr.params)
    assert isinstance(port["blocks"]["attn"]["wq"], PackedWeight)
    jcfg = jax_smoke(LM)
    jlike = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    jaxp = JaxManager(tmp_path / "run").restore(2, jlike)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3)]
    got = ServingEngine(cfg, port, slots=2, max_len=24).generate(
        [Request(p, max_new_tokens=6) for p in prompts])
    frozen = ServingEngine(cfg, tr.params, freeze=True, slots=2,
                           max_len=24).generate(
        [Request(p, max_new_tokens=6) for p in prompts])
    with tune.gspmd_safe():
        want = JaxEngine(jcfg, jaxp, slots=2, max_len=24).generate(
            [JaxRequest(p, max_new_tokens=6) for p in prompts])
    for a, b, c in zip(got, frozen, want, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
