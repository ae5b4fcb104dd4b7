"""The port's EF-SignSGD data-parallel step (`train.compressed`) against the
JAX package's on the CPU, phi3-medium-14b and musicgen-large at smoke
size, SGD:

  * on a one-device mesh against JAX's own shard_map step
    (`repro.train.compressed`), two steps from the same state;
  * on data 4 (`["cpu"] * 4`) against an oracle built here from JAX's
    value_and_grad of the loss on each shard's row block and JAX's
    `compress_leaf`: the int8 signs summed in int32, the scales averaged,
    g_hat = scale_mean x sign_sum / n, the other leaves averaged in float32;
  * over 6 steps at data 2 the compressed step's loss tracks the dense
    step's within 0.08 (JAX's own bound, tests/test_compressed.py), and
    the residuals are non-zero.

Tolerance. Gradients of the two packages agree to REL = 5e-5 of each
tensor's largest magnitude (tests/test_torch_lm_train.py); a sign of g + e
within that of 0 is rounding, and may part. So every param (residual) off
by more than REL of the largest update (residual), and two ulps of the
param, must sit where some shard's g + e is within REL of its largest
magnitude in the reference; the losses agree to 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_np, np_leaves, to_port
from repro.configs.smoke import smoke_config as jax_smoke
from repro.models.api import get_model as jax_get_model
from repro.optim.adamw import sgd as j_sgd
from repro.train.compressed import (
    init_ef_sharded as j_init_ef, make_compressed_train_step as j_make_step,
)
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import join, place
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import sgd
from repro_torch.optim.base import tree_leaves, tree_map
from repro_torch.train.compressed import (
    compressed_leaf, init_ef_sharded, make_compressed_train_step,
)
from repro_torch.train.step import make_train_step

jef = importlib.import_module("repro.optim.ef_signsgd")

LR, REL, LOSS_REL, ARCH = 0.02, 5e-5, 1e-5, "phi3-medium-14b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _batch(rows=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 128, (rows, seq)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's init (numpy), its model and its loss's value_and_grad, jitted
    once (every call below is on a 2-row block)."""
    jcfg = jax_smoke(ARCH)
    model = jax_get_model(jcfg)
    params = jax_to_np(model.init(jax.random.PRNGKey(0)))
    vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, key=None),
                                    has_aux=True))
    return model, params, vg


def _flags(tree, path=()) -> list:
    """`compressed_leaf` of every leaf of a numpy tree, in `np_leaves`
    order."""
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in _flags(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [f for i, v in enumerate(tree) for f in _flags(v, path + (i,))]
    return [compressed_leaf(path, np.asarray(tree))]


def _like(tree, leaves):
    """The numpy tree of `tree`'s structure with `leaves` in `np_leaves`
    order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(tree)


def _oracle(vg, np_params, np_err, batch, n):
    """One step of the compressed algorithm from JAX's parts: (loss, new
    params, new residuals per shard, g + e per shard), numpy leaves in
    `np_leaves` order."""
    p = jax.tree.map(jnp.asarray, np_params)
    b = batch["tokens"].shape[0] // n
    comp = _flags(np_params)
    leaves = np_leaves(np_params)
    losses, signs, scales, floats, errs, corrs = [], [], [], [], [], []
    for i in range(n):
        (loss, _), g = vg(p, {"tokens": jnp.asarray(
            batch["tokens"][i * b:(i + 1) * b])})
        losses.append(float(loss))
        sg, sc, fl, er, co = [], [], [], [], []
        for c, gl, e in zip(comp, np_leaves(jax_to_np(g)), np_err[i]):
            if c:
                s, scale, new_e = jef.compress_leaf(jnp.asarray(gl),
                                                    jnp.asarray(e))
                sg.append(np.asarray(s, np.int32))
                sc.append(np.float32(scale))
                er.append(np.asarray(new_e))
                co.append(np.asarray(jnp.asarray(gl, jnp.float32)
                                     + jnp.asarray(e)))
                fl.append(None)
            else:
                sg.append(None), sc.append(None), co.append(None)
                er.append(e)
                fl.append(np.asarray(gl, np.float32))
        signs.append(sg), scales.append(sc), floats.append(fl)
        errs.append(er), corrs.append(co)
    new_p = []
    for j, (c, p0) in enumerate(zip(comp, leaves)):
        if c:
            ssum = sum(s[j] for s in signs).astype(np.int32)
            smean = np.float32(sum(s[j] for s in scales) / np.float32(n))
            ghat = smean * ssum.astype(np.float32) / np.float32(n)
        else:
            ghat = sum(f[j] for f in floats) / np.float32(n)
        new_p.append((p0 + np.float32(-LR) * ghat).astype(np.float32))
    return float(np.mean(losses)), new_p, errs, corrs


def _hold(got_p, got_e, want_p, want_e, p0, corrs):
    """Params and per-shard residuals within the module doc's tolerance,
    or parted at a noise-floor sign of g + e. Returns the count of parted
    elements."""
    parted = 0
    for j, (a, b, base) in enumerate(zip(got_p, want_p, p0)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        step = np.abs(b - np.asarray(base, np.float64)).max()
        off = np.abs(a - b) > REL * step + 2 * np.spacing(
            np.abs(b).astype(np.float32))
        floor = np.zeros(a.shape, bool)
        for co in corrs:
            if co[j] is not None:
                floor |= np.abs(co[j]) <= REL * np.abs(co[j]).max()
        assert not (off & ~floor).any(), f"param leaf {j}"
        parted += int(off.sum())
        for i, co in enumerate(corrs):
            ea = np.asarray(got_e[i][j], np.float64)
            eb = np.asarray(want_e[i][j], np.float64)
            off = np.abs(ea - eb) > REL * max(np.abs(eb).max(), 1e-30)
            if co[j] is None:
                assert not off.any(), f"residual leaf {j} shard {i}"
                continue
            near = np.abs(co[j]) <= REL * np.abs(co[j]).max()
            assert not (off & ~near).any(), f"residual leaf {j} shard {i}"
    return parted


def _port_step(np_params, np_err, batch, n):
    """One port compressed step on a data-n mesh of the CPU from numpy
    params and per-shard residuals (None: zeros): (loss, params, residuals
    per shard), numpy leaves in `np_leaves` order."""
    mesh = make_host_mesh(devices=["cpu"] * n)
    params = to_port(np_params)
    opt = sgd(LR)
    if np_err is None:
        err = init_ef_sharded(params, mesh)
    else:
        err = tree_map(lambda *es: place(torch.stack(es), mesh, ("data",)),
                       *[to_port(_like(np_params, e)) for e in np_err])
    step = make_compressed_train_step(get_model(smoke_config(ARCH)), opt,
                                      mesh)
    p, _, e, m = step(tree_map(lambda x: place(x, mesh, ()), params),
                      tree_map(lambda x: place(x, mesh, ()),
                               opt.init(params)), err,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    p = np_leaves(to_numpy_tree(tree_map(lambda a: join(a, mesh, ()), p)))
    e = np_leaves(to_numpy_tree(tree_map(
        lambda a: join(a, mesh, ("data",)), e)))
    return float(m["loss"]), p, [[x[i] for x in e] for i in range(n)]


def test_one_device_matches_jax_compressed_step(jax_side):
    """Two steps, each from the same params and residuals on both sides
    (JAX's after the first)."""
    model, params, vg = jax_side
    mesh = jax.make_mesh((1,), ("data",))
    jstep = j_make_step(model, j_sgd(LR), mesh)
    p = jax.tree.map(jnp.asarray, params)
    opt = j_sgd(LR)
    o, ef = opt.init(p), j_init_ef(p, 1)
    np_err = None
    for k in range(2):
        batch = _batch(rows=2, seed=k)
        jp, o, ef, m = jstep(p, o, ef, {"tokens": jnp.asarray(
            batch["tokens"])})
        want_p = np_leaves(jax_to_np(jp))
        want_e = [[x[0] for x in np_leaves(jax_to_np(ef))]]
        start = np_leaves(jax_to_np(p))
        err0 = [[np.zeros(x.shape, np.float32) for x in start]] \
            if np_err is None else np_err
        _, _, _, corrs = _oracle(vg, jax_to_np(p), err0, batch, 1)
        loss, got_p, got_e = _port_step(jax_to_np(p), np_err, batch, 1)
        assert loss == pytest.approx(float(m["loss"]), rel=LOSS_REL)
        parted = _hold(got_p, got_e, want_p, want_e, start, corrs)
        print(f"step {k}: {parted} params parted at noise-floor signs")
        p, np_err = jp, want_e


def test_data4_matches_the_jax_oracle(jax_side):
    """From JAX's init and non-zero residuals (those of one earlier oracle
    step), one data-4 step against the oracle."""
    _, params, vg = jax_side
    batch = _batch()
    zeros = [[np.zeros(x.shape, np.float32) for x in np_leaves(params)]
             for _ in range(4)]
    _, _, err, _ = _oracle(vg, params, zeros, _batch(seed=5), 4)
    loss_w, want_p, want_e, corrs = _oracle(vg, params, err, batch, 4)
    loss, got_p, got_e = _port_step(params, err, batch, 4)
    assert loss == pytest.approx(loss_w, rel=LOSS_REL)
    parted = _hold(got_p, got_e, want_p, want_e, np_leaves(params), corrs)
    print(f"{parted} params parted at noise-floor signs")


def test_tracks_dense_and_keeps_residuals():
    """musicgen-large (the JAX test's model), data 2, 6 steps of SGD(0.02)
    on batches of 16 x 32: each step's loss within 0.08 of the dense
    step's; the residuals are non-zero and each shard's its own."""
    cfg = smoke_config("musicgen-large")
    model, opt = get_model(cfg), sgd(LR)
    mesh = make_host_mesh(devices=["cpu"] * 2)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    pd, od = tree_map(torch.clone, p), opt.init(p)
    pc = tree_map(lambda x: place(x, mesh, ()), p)
    oc = tree_map(lambda x: place(x, mesh, ()), opt.init(p))
    ef = init_ef_sharded(p, mesh)
    cstep, dstep = make_compressed_train_step(model, opt, mesh), \
        make_train_step(model, opt)
    rng = np.random.default_rng(0)
    for _ in range(6):
        b = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (16, 32)).astype(np.int32))}
        pc, oc, ef, mc = cstep(pc, oc, ef, b)
        pd, od, md = dstep(pd, od, b)
        assert abs(float(mc["loss"]) - float(md["loss"])) < 0.08
    errs = [join(e, mesh, ("data",)) for e in tree_leaves(ef)]
    assert sum(float(e.abs().sum()) for e in errs) > 0
    wq = join(ef["blocks"]["attn"]["wq"], mesh, ("data",))
    assert not torch.equal(wq[0], wq[1])
    # embeddings and small leaves are sent in float32: no residual
    assert float(join(ef["embed"], mesh, ("data",)).abs().sum()) == 0
