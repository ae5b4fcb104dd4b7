"""The port's abstract inputs (`launch/specs.py`), activation-sharding hints
(`launch/shardctx.py`) and production mesh (`launch/mesh.py`) against the
JAX package's, on the CPU:

  * `input_specs` of every arch x SHAPES cell and `abstract_params` /
    `abstract_opt_state` of every arch: leaf names, shapes and dtypes equal
    JAX's `jax.eval_shape` trees (packed words int32 for uint32), every
    leaf on the meta device (nothing allocated);
  * the spec each hint names inside `activation_sharding` equals the one
    JAX's hint hands `jax.lax.with_sharding_constraint` (captured by a
    monkeypatch here; JAX's context run on the port's mesh), on 2-axis and
    3-axis meshes, with and without a global batch and sequence sharding;
  * `make_production_mesh`'s axes and shapes, its ValueError on too few
    devices, and `place` / `join` / `batch_shards` on its 3-axis grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _leaf_names as jax_leaf_names
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.launch import shardctx as jctx
from repro.launch import specs as jspecs
from repro.models.api import get_model as jax_get_model
from repro.train.step import default_optimizer as j_default_optimizer
from repro_torch.checkpoint.manager import leaves_with_names
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch import shardctx, specs
from repro_torch.launch.mesh import (
    Mesh, _grid, batch_axes, make_production_mesh, make_serving_mesh,
)
from repro_torch.launch.shardings import batch_shards, join, place
from repro_torch.models.api import get_model
from repro_torch.train.step import default_optimizer

ARCHS = list_archs()


def _jax_leaves(tree) -> list:
    names = jax_leaf_names(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    return [(n, tuple(x.shape), "int32" if str(x.dtype) == "uint32"
             else str(x.dtype)) for n, x in zip(names, leaves, strict=True)]


def _port_leaves(tree) -> list:
    out = []
    for n, x in leaves_with_names(tree):
        assert x.device.type == "meta", n
        out.append((n, tuple(x.shape), str(x.dtype).replace("torch.", "")))
    return out


def test_shapes_are_the_jax_packages():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    got = specs.input_specs(cfg, get_model(cfg), shape)
    want = jspecs.input_specs(jcfg, jax_get_model(jcfg), shape)
    assert _port_leaves(got) == _jax_leaves(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_opt_state_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = get_model(cfg), jax_get_model(jcfg)
    params = specs.abstract_params(cfg, model)
    jparams = jspecs.abstract_params(jcfg, jmodel)
    assert _port_leaves(params) == _jax_leaves(jparams)
    state = specs.abstract_opt_state(default_optimizer(cfg), params)
    jstate = jspecs.abstract_opt_state(j_default_optimizer(jcfg), jparams)
    assert _port_leaves(state) == _jax_leaves(jstate)


# ---------------------------------------------------------------------------
# the hints
# ---------------------------------------------------------------------------
def _norm(entry):
    if isinstance(entry, tuple):
        return None if not entry else entry[0] if len(entry) == 1 \
            else entry
    return entry


HINTS = ("residual", "gathered", "ffn_hidden", "expert_buf", "attn_q",
         "batch_only")
SHAPES_3D = [(8, 16, 32), (8, 1, 32), (8, 6, 32), (6, 16, 8), (4, 16, 12)]
SHAPES_ALL = SHAPES_3D + [(8, 16, 8, 4), (8, 16, 6, 4), (8,), (8, 32),
                          (4, 8, 8, 8, 2)]


def _meshes():
    devs = ["cpu"] * 16
    return {"data4 x model4": make_serving_mesh(4, 4, devices=devs),
            "data2 x model2": make_serving_mesh(2, 2, devices=devs),
            "pod2 x data2 x model4": Mesh(_grid(devs, (2, 2, 4)),
                                          ("pod", "data", "model"))}


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("global_batch", [None, 8, 2, 1])
@pytest.mark.parametrize("mesh", ["data4 x model4", "data2 x model2",
                                  "pod2 x data2 x model4"])
def test_hint_specs_match_jax(monkeypatch, mesh, global_batch, seq_shard):
    mesh = _meshes()[mesh]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    with jctx.activation_sharding(mesh, global_batch=global_batch,
                                  seq_shard=seq_shard), \
            shardctx.activation_sharding(
                mesh, global_batch=global_batch,
                seq_shard=seq_shard) as hints:
        assert shardctx.current() is hints
        for shape in SHAPES_ALL:
            x = jnp.zeros(shape, jnp.float32)
            t = torch.zeros(shape)
            for name in HINTS:
                seen.clear()
                assert getattr(jctx, f"hint_{name}")(x) is x
                assert getattr(shardctx, f"hint_{name}")(t) is t
                want = tuple(_norm(e) for e in seen[0]) if seen else None
                assert getattr(hints, name)(shape) == want, (name, shape)
    assert shardctx.current() is None


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------
def test_production_mesh_axes_and_errors():
    one = make_production_mesh(devices=["cpu"] * 300)
    assert one.axis_names == ("data", "model")
    assert one.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert batch_axes(pods) == ("pod", "data")
    with pytest.raises(ValueError, match="needs 512 devices, have 511"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 511)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 256 devices, have 0"):
            make_production_mesh()


def test_place_join_on_the_multipod_mesh():
    """A (64, 32) tensor over ('pod', 'data') x 'model' of the 2 x 16 x 16
    grid: each piece is its block; replicas of one slice on one device are
    one tensor; join gives the tensor back; the batch shards run pod-major
    at 'model' 0."""
    mesh = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    spec = (("pod", "data"), "model")
    pieces = place(x, mesh, spec)
    assert pieces.shape == (2, 16, 16)
    assert torch.equal(pieces[1, 3, 5], x[(16 + 3) * 2:(16 + 4) * 2,
                                          10:12])
    assert torch.equal(join(pieces, mesh, spec), x)
    rows = place(x, mesh, (("pod", "data"),))
    assert rows[1, 3, 0] is rows[1, 3, 7]
    assert torch.equal(join(rows, mesh, (("pod", "data"),)), x)
    shards = batch_shards(mesh)
    assert len(shards) == 32 and shards[:2] == [(0, 0, 0), (0, 1, 0)] \
        and shards[16] == (1, 0, 0)
    with pytest.raises(ValueError, match="does not divide"):
        place(torch.zeros(48, 32), mesh, spec)
