"""Shared helpers of the port's mesh train tests (tests/
test_torch_mesh_train.py, tests/test_torch_placed_train.py): smoke configs
by family, numpy-seeded batches, meshes over repeated CPU devices, one step
of the port's (mesh) step with the gradients the optimizer is given, and
the holds of one step against another (module docs of those files)."""
import numpy as np
import pytest
import torch

from _torch_moments import first_step_scale, held_through_moments
from _torch_parity import assert_rel, np_leaves, to_port
from repro_torch.configs.smoke import smoke_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core import ap2 as tap2
from repro_torch.core.layers import Draws
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import join, param_specs, place
from repro_torch.models.api import get_model
from repro_torch.optim.base import Optimizer, tree_map
from repro_torch.train.step import (
    default_optimizer, init_placed_state, make_train_step, state_shardings,
)

LOSS_REL, GRAD_REL, LR = 1e-6, 1e-5, 1e-3
JAX_LOSS_REL, JAX_GRAD_REL = 1e-5, 5e-5
FAMILIES = {"dense": ("phi3-medium-14b", {}),
            "moe": ("dbrx-132b", {"capacity_factor": 1.0}),
            "audio": ("musicgen-large", {}),
            "ssm": ("falcon-mamba-7b", {}),
            "hybrid": ("recurrentgemma-2b", {}),
            "vlm": ("llama-3.2-vision-11b", {})}
ROWS, SEQ = 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread with denormals flushed, as the JAX parity tests
    run it (tests/test_torch_lm_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _cfg(family, **over):
    """The family's smoke config; remat off unless asked (the hazard
    tests below run with it on)."""
    arch, base = FAMILIES[family]
    return smoke_config(arch).scaled(**{**base, "remat": False, **over})


def _batch(cfg, seed=0, rows=ROWS, seq=SEQ):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_emb"] = rng.normal(size=(rows, cfg.n_img_tokens,
                                          cfg.d_vision)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _mesh(shape):
    data, model = shape
    return make_host_mesh(model, devices=["cpu"] * (data * model))


def _stash(opt):
    """`opt` whose state also carries the gradients it was given."""
    def update(g, s, p, donate=False):
        upd, st = opt.update(tree_map(torch.clone, g), s[0], p)
        return upd, (st, g)
    return Optimizer(init=lambda p: (opt.init(p), None), update=update)


def _specs(params, placed: bool):
    """JAX's placement (`param_specs`) or the replicated one (())."""
    return param_specs(params) if placed else tree_map(lambda _: (), params)


def _step(cfg, np_params, batch, *, mesh=None, accum=1, gen_seed=None,
          placed=False):
    """One step of the port's (mesh) step from `np_params` with stashed
    gradients: (params, opt state, gradients, metrics) as whole tensors.
    Over a mesh the params are placed by JAX's specs where `placed`, else
    replicated; the state is initialised on the pieces."""
    params = to_port(np_params)
    opt = _stash(default_optimizer(cfg, LR))
    gen = None if gen_seed is None else \
        torch.Generator().manual_seed(gen_seed)
    if mesh is None:
        step = make_train_step(get_model(cfg), opt, accum=accum)
        p, (st, g), m = step(params, opt.init(params), _t(batch), gen)
        return p, st, g, {k: float(v) for k, v in m.items()}
    specs = _specs(params, placed)
    p = tree_map(lambda x, sp: place(x, mesh, sp), params, specs)
    step = make_train_step(get_model(cfg), opt, accum=accum, mesh=mesh,
                           specs=specs)
    p, s, m = step(p, init_placed_state(opt, p, mesh), _t(batch), gen)
    ssp = state_shardings(s, p, specs, ())
    p = tree_map(lambda a, sp: join(a, mesh, sp), p, specs)
    st, g = tree_map(lambda a, sp: join(a, mesh, sp), s, ssp)
    return p, st, g, {k: float(v) for k, v in m.items()}


_MASTERS: dict = {}


def _masters(family):
    if family not in _MASTERS:
        cfg = _cfg(family)
        p = get_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
        _MASTERS[family] = to_numpy_tree(p)
    return _MASTERS[family]


_SINGLE: dict = {}


def _single(family, accum):
    key = (family, accum)
    if key not in _SINGLE:
        cfg = _cfg(family)
        _SINGLE[key] = _step(cfg, _masters(family), _batch(cfg), accum=accum)
    return _SINGLE[key]


def _close(got, want, rel, what):
    for i, (b, a) in enumerate(zip(np_leaves(to_numpy_tree(got)),
                                   np_leaves(to_numpy_tree(want)),
                                   strict=True)):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} leaf {i}")
        else:
            assert_rel(b, a, rel=rel, what=f"{what} leaf {i}")


def _exps(u_tree):
    return [tap2.ap2_exponent(1.0 / (torch.from_numpy(np.array(u)) + 1e-8))
            .numpy() for u in np_leaves(to_numpy_tree(u_tree))]


def _held(got, want, rel):
    """Hold one step's outputs `got` to `want` (both `_step`'s): metrics,
    gradients and moments to the tolerances, params through the moments."""
    p1, st1, g1, m1 = got
    p0, st0, g0, m0 = want
    assert set(m1) == set(m0)
    for k in m0:
        assert m1[k] == pytest.approx(m0[k], rel=rel[0], abs=1e-7), k
    _close(g1, g0, rel[1], "grads")
    _close(st1.m, st0.m, rel[1], "opt m")
    _close(st1.u, st0.u, rel[1], "opt u")
    assert int(st1.step) == int(st0.step)
    return held_through_moments(
        np_leaves(to_numpy_tree(p1)), np_leaves(to_numpy_tree(p0)),
        np_leaves(to_numpy_tree(st1.m)), np_leaves(to_numpy_tree(st0.m)),
        _exps(st1.u), _exps(st0.u), rel[1], first_step_scale(LR))


def _record_draws(monkeypatch):
    seen = []
    call = Draws.__call__

    def rec(self, site, like, per_row=False):
        u = call(self, site, like, per_row)
        seen.append((site, per_row, u.clone()))
        return u
    monkeypatch.setattr(Draws, "__call__", rec)
    return seen
