"""The port's mesh and sharding specs (`repro_torch.launch.mesh`,
`repro_torch.launch.shardings`) against the JAX package's.

`param_specs` and `cache_shardings` must give JAX's spec for every leaf of
every family's smoke tree (fp32 masters and frozen; contiguous and paged
caches at kv_bits 0 and 1). The JAX side runs on a (1, 1) mesh over
`eval_shape` trees (nothing is computed); the port's over meta tensors.
`place` must cut the leaves into the per-shard shapes that
`tests/test_sharded_serving.py` expects of JAX's placement.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config as jax_smoke
from repro.launch import shardings as JS
from repro.models.api import get_model as jax_model
from repro_torch.configs.smoke import smoke_config
from repro_torch.core.packed import PackedWeight
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as S
from repro_torch.models.api import get_model
from repro_torch.models.transformer import init_cache
from repro_torch.optim.base import tree_map_with_path

ARCHS = ["phi3-medium-14b", "qwen2-72b", "deepseek-67b", "nemotron-4-15b",
         "musicgen-large", "llama-3.2-vision-11b", "falcon-mamba-7b",
         "recurrentgemma-2b", "dbrx-132b", "llama4-scout-17b-a16e"]
ATTN = ("dense", "moe", "audio", "vlm")


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _jax_flat(tree) -> dict:
    """{path: spec tuple} of a JAX tree of PartitionSpecs or shardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JS._path_str(p): tuple(getattr(s, "spec", s)) for p, s in leaves}


def _port_flat(params) -> dict:
    """{path: spec} of the port's `param_specs(params)`, a PackedWeight's
    children as JAX paths them ("/0" packed words, "/1" thresh, "/2"
    flip)."""
    specs, out = S.param_specs(params), {}

    def leaf(path, p):
        spec = specs
        for key in path:
            spec = spec[key]
        name = "/".join(map(str, path))
        if isinstance(p, PackedWeight):
            out.update({f"{name}/{i}": c for i, c in enumerate(spec)
                        if c is not None})
        elif spec is not None:
            out[name] = spec

    tree_map_with_path(leaf, params)
    return out


@pytest.fixture(scope="module")
def trees():
    """Every family's smoke tree in both packages, masters and frozen."""
    out = {}
    for arch in ARCHS:
        jm = jax_model(jax_smoke(arch))
        masters = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        frozen = jax.eval_shape(jm.freeze, masters)
        tm = get_model(smoke_config(arch))
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        out[arch] = ((masters, frozen), (tp, tm.freeze(tp)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, trees):
    (jm, jf), (tm, tf) = trees[arch]
    for jtree, ttree in ((jm, tm), (jf, tf)):
        want = _jax_flat(JS.param_specs(jtree))
        got = _port_flat(ttree)
        assert got == want
    # the shardings carry the same specs on a mesh of the port's
    mesh = M.make_serving_mesh(1, 1, devices=["cpu"])
    sh = S.param_shardings(mesh, tm)
    assert sh["embed"].spec == S.param_specs(tm)["embed"]


# every cache layout: each family at kv_bits 0 and 1, the attention
# families also paged (recurrent state is never paged)
CACHES = [(arch, kv_bits, paged)
          for arch in ("qwen2-72b", "musicgen-large", "llama-3.2-vision-11b",
                       "dbrx-132b", "falcon-mamba-7b", "recurrentgemma-2b")
          for kv_bits in (0, 1)
          for paged in ((False, True) if jax_smoke(arch).family in ATTN
                        else (False,))]


@pytest.mark.parametrize("arch,kv_bits,paged", CACHES)
def test_cache_shardings_match_jax(arch, kv_bits, paged):
    cfg = jax_smoke(arch).scaled(kv_bits=kv_bits)
    kw = dict(page_size=4, pool_pages=8) if paged else {}
    jm = jax_model(cfg)
    jc = jax.eval_shape(lambda: jm.init_cache(4, 16, **kw))
    tm = get_model(smoke_config(arch).scaled(kv_bits=kv_bits))
    tc = tm.init_cache(4, 16, device="meta", **kw)
    mesh = M.make_serving_mesh(1, 1, devices=["cpu"])
    for gb in (None, 4, 1):
        want = _jax_flat(JS.cache_shardings(_jax_mesh(), jc, cfg.family,
                                            global_batch=gb))
        got = {k: v.spec for k, v in S.cache_shardings(
            mesh, tc, cfg.family, global_batch=gb).items()}
        assert got == want


def test_batch_specs_match_jax():
    jm = _jax_mesh()
    mesh = M.make_serving_mesh(1, 1, devices=["cpu"])
    assert S.batch_spec(mesh) == tuple(JS.batch_spec(jm))
    batch = {"tokens": torch.zeros(4, 8), "img_emb": torch.zeros(4, 3, 2)}
    jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
          for k, v in batch.items()}
    want = _jax_flat(JS.batch_shardings(jm, jb))
    assert {k: v.spec for k, v in S.batch_shardings(mesh, batch).items()} \
        == want
    four = M.make_serving_mesh(4, 1, devices=["cpu"] * 4)
    assert S.div_batch_axes(four, 8) == ("data",)
    assert S.div_batch_axes(four, 6) == ()


def _shapes(pieces) -> set:
    return {tuple(p.shape) for p in pieces.flat}


def test_place_paged_pool_under_mesh():
    """tests/test_sharded_serving.py's placement of the paged layout on a
    2 x 2 mesh: packed pools whole on every shard, page tables split over
    'data' on the slot axis, V scales on their batch axis; a float pool's
    head_dim split over 'model'. Join gives the tensor back."""
    mesh = M.make_serving_mesh(2, 2, devices=["cpu"] * 4)
    cfg = smoke_config("qwen2-72b").scaled(kv_bits=1)
    b, max_len, ps = 8, 32, 8
    gen = torch.Generator().manual_seed(0)
    cache = init_cache(cfg, b, max_len, page_size=ps, pool_pages=16,
                       device="cpu")
    for name in cache:       # distinct values, so a join shows misplacement
        cache[name] = torch.randint(-9, 9, cache[name].shape, generator=gen
                                    ).to(cache[name].dtype)
    specs = S.cache_shardings(mesh, cache, cfg.family)
    placed = {k: S.place(v, mesh, specs[k].spec) for k, v in cache.items()}
    for name in ("k", "v"):
        assert cache[name].dtype == torch.int32
        assert _shapes(placed[name]) == {tuple(cache[name].shape)}, name
    assert cache["page_table"].shape == (b, max_len // ps)
    assert _shapes(placed["page_table"]) == {(b // 2, max_len // ps)}
    vs = cache["v_scale"]                       # (L, B, kv): batch at -2
    assert _shapes(placed["v_scale"]) == {(vs.shape[0], b // 2, vs.shape[2])}
    for name, pieces in placed.items():
        assert torch.equal(S.join(pieces, mesh, specs[name].spec),
                           cache[name])
    fcache = init_cache(smoke_config("qwen2-72b"), b, max_len, page_size=ps,
                        pool_pages=16, device="cpu")
    fk = fcache["k"]
    spec = S.cache_shardings(mesh, fcache, cfg.family)["k"].spec
    assert _shapes(S.place(fk, mesh, spec)) == \
        {tuple(fk.shape[:-1]) + (fk.shape[-1] // 2,)}


def test_place_contiguous_packed_under_mesh():
    """Contiguous kv_bits=1: the slot axis split over 'data', the int32
    word axis and T whole."""
    mesh = M.make_serving_mesh(2, 2, devices=["cpu"] * 4)
    cfg = smoke_config("qwen2-72b").scaled(kv_bits=1)
    b, max_len = 8, 32
    cache = init_cache(cfg, b, max_len, device="cpu")
    k = cache["k"]                               # (L, B, T, kv, w)
    spec = S.cache_shardings(mesh, cache, cfg.family)["k"].spec
    assert _shapes(S.place(k, mesh, spec)) == \
        {(k.shape[0], b // 2) + tuple(k.shape[2:])}
    with pytest.raises(ValueError, match="divide"):
        S.place(torch.zeros(3, 4), mesh, ("data",))


def test_mesh_construction():
    assert M.parse_mesh("2,1") == (2, 1)
    assert M.parse_mesh("4") == (4, 1)
    assert M.parse_mesh("model=2,data=3") == (3, 2)
    for bad in ("", "data=2,pipe=2", "1,2,3", "x"):
        with pytest.raises(ValueError):
            M.parse_mesh(bad)
    mesh = M.make_serving_mesh(2, 2, devices=["cpu"] * 5)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.devices.size == 4
    assert mesh.shard_name((1, 0)) == "cpu (data 1, model 0)"
    assert M.batch_axes(mesh) == ("data",)
    with pytest.raises(ValueError, match="needs 4 devices"):
        M.make_serving_mesh(2, 2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 1 devices"):
            M.make_serving_mesh(1, 1)
    host = M.make_host_mesh(2, devices=["cpu"] * 6)
    assert host.shape == {"data": 3, "model": 2}
