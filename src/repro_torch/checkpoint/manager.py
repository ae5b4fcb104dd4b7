"""Checkpoints: an async writer, atomic steps, and the paper's 1-bit packed
format for binary weights (port of `repro.checkpoint.manager`, in its
on-disk format, so each package restores the other's checkpoints).

Layout per step:  <dir>/step_<n>/
    manifest.json         {"step", "leaves": [{"name", "key", "shape",
                          "dtype", "packed", ...}]}
    arrays.npz            one entry per leaf, "leaf_<i>" (whole logical
                          arrays, or wire-format uint32 words for packed
                          leaves, with "_thresh" / "_flip" beside them)
Written to step_<n>.tmp, then renamed: a step directory is whole or absent.

Leaf order and names are the JAX package's: `jax.tree_util` flattens dicts
in sorted key order, NamedTuples in field order, sequences by index, and
None as no leaf, and names a leaf by its path, dict keys and indices as
they are, NamedTuple fields as ".<field>" ("1/.m/blocks/attn/wq" for the
first moment of wq in a (params, opt_state) tree). The JAX package's
restore reads the leaves by position into its own tree, so the port writes
them in that order; the port's restore reads them by name into `like`,
whatever order the port keeps its dicts in. Words are int32 tensors in the
port and uint32 arrays on disk (the same bits); thresholds and flips int32;
a packed leaf's "dtype" names its master's dtype.

Packed binary leaves (the deployment format): a binary weight stored as the
sign bits of the kernel wire format (`core.packed`), packed along K of w^T
into 32-bit words, the operand the XNOR-popcount kernels read. A tree
frozen by `core.packed.freeze_params` saves its `PackedWeight`s natively
(with any folded threshold); `save(tree, packed_binary=True[,
binary_keys=])` freezes an fp32-master tree at write time. `restore`
returns those leaves as `PackedWeight`s, never rebuilding fp32 masters;
`unpack=True` gives +-1 floats in the logical shape instead. Checkpoints
of the older layout (sign bits packed along the last logical axis, no
"format" key) restore as +-1 floats.

Sharded trees (`launch.shardings`): a leaf may be the object ndarray of
per-shard pieces that `place` gives. `save(..., shardings=)` joins such
leaves into whole logical arrays first, so a checkpoint never records the
mesh it was written from, and `restore(..., shardings=)` places every
leaf onto the Shardings given: a restart on another mesh, or on one
device, reshards on restore (elastic restore).
"""
from __future__ import annotations

import json
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import words_to_numpy
from repro_torch.core.bitpack import unpack_bits
from repro_torch.core.packed import (
    BINARY_WEIGHT_KEYS, PackedWeight, freeze_params,
)
from repro_torch.launch.shardings import join_leaf, place_leaf
from repro_torch.optim.base import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def leaves_with_names(tree, path: tuple = ()) -> list[tuple[str, object]]:
    """(name, leaf) of every leaf in the JAX package's flatten order
    (the module doc). PackedWeights and tensors are leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_names(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in leaves_with_names(v, path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_names(v, path + (str(i),))]
    return [("/".join(path), tree)]


_READERS = 4               # threads reading a checkpoint's leaves


def _rebuild(like, fetch, path: tuple = ()):
    """`like`'s structure with fetch(name, like leaf) at every leaf."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, fetch, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, fetch, path + (f".{f}",))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fetch, path + (str(i),))
                          for i, v in enumerate(like))
    return fetch("/".join(path), like)


def _host(x):
    """A leaf as the numpy array(s) the writer stores, copied off the
    device now (the writer may run after the caller changes the tensor)."""
    if isinstance(x, PackedWeight):
        opt = (lambda t: None if t is None
               else t.detach().to("cpu", copy=True).numpy())
        return PackedWeight(words_to_numpy(x.packed), x.k, x.kind,
                            x.conv_shape, _NAMES[x.orig_dtype],
                            thresh=opt(x.thresh), flip=opt(x.flip),
                            fold=x.fold)
    t = torch.as_tensor(x).detach()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:          # numpy has no bfloat16
        t = t.to(torch.float32)
    return name, t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, packed_binary: bool = False,
             binary_keys: set[str] | None = None, shardings=None) -> None:
        """Write `tree` as step `step`: on a thread when async_save (at most
        one outstanding; its device-to-host copy happens here, before the
        call returns), else before returning. packed_binary: store the sign
        bits of the binary-weight leaves (`core.packed.freeze_params`, exact
        key match; default keys: the weights the forward serves binarized),
        the paper's deployment format. shardings: a tree of
        `launch.shardings.Sharding` (or None) matching `tree`, whose placed
        leaves (pieces) are joined into whole arrays before anything else."""
        if shardings is not None:
            tree = tree_map(join_leaf, tree, shardings)
        if packed_binary:
            tree = freeze_params(tree, frozenset(binary_keys)
                                 if binary_keys is not None
                                 else BINARY_WEIGHT_KEYS)
        named = [(name, _host(x)) for name, x in leaves_with_names(tree)]
        if self._thread is not None:
            self._thread.join()

        def write():
            self._write(step, named)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def _write(self, step: int, named: list) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, manifest = {}, {"step": step, "leaves": []}
        for i, (name, x) in enumerate(named):
            key = f"leaf_{i}"
            if isinstance(x, PackedWeight):
                arrays[key] = x.packed
                entry = {"name": name, "key": key, "shape": list(x.shape),
                         "dtype": x.orig_dtype, "packed": True,
                         "format": "wire", "kind": x.kind, "k": x.k}
                if x.has_threshold:
                    arrays[f"{key}_thresh"] = x.thresh
                    arrays[f"{key}_flip"] = x.flip
                    entry["fold"] = x.fold
                manifest["leaves"].append(entry)
                continue
            dtype, arr = x
            arrays[key] = arr
            manifest["leaves"].append({"name": name, "key": key,
                                       "shape": list(arr.shape),
                                       "dtype": dtype, "packed": False})
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None, *,
                unpack: bool = False, device=None):
        """Restore step `step` into the structure of `like` (a tree of
        tensors, PackedWeights or placed pieces; shapes and dtypes come
        from the checkpoint), by leaf name. Each leaf lands on `device`, or
        on the device of `like`'s leaf at its place when None (the CPU for
        pieces).

        Packed-binary leaves come back as PackedWeight (words int32, the
        kernels' operand; no fp32 master is rebuilt), or with unpack=True
        as +-1 floats of the master's dtype in the logical shape.

        shardings: a tree of `launch.shardings.Sharding` matching `like`
        (None at a leaf: the plain leaf). Each leaf is then placed on its
        mesh (`launch.shardings.place_leaf`): the object ndarray of its
        per-shard pieces. A PackedWeight's spec applies to its wire words,
        (..., N, ceil(K / 32)), not the logical (K, N) weight; its
        threshold and flip stay replicated."""
        tree = self._restore(step, like, unpack, device)
        if shardings is None:
            return tree
        return tree_map(place_leaf, tree, shardings)

    def _restore(self, step: int, like, unpack: bool, device):
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        entries = {e["name"]: e for e in manifest["leaves"]}
        # the leaves are read by _READERS threads, each through its own
        # handle on the file (a zip handle is not safe to share): a read's
        # CRC and copies run outside the GIL
        local, handles = threading.local(), []

        def fetch(item):
            name, like_leaf = item
            if name not in entries:
                raise KeyError(f"step {step} has no leaf {name!r}")
            dev = device
            if dev is None:
                ref = like_leaf.packed if isinstance(like_leaf, PackedWeight) \
                    else like_leaf
                dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            if not hasattr(local, "data"):
                local.data = np.load(path / "arrays.npz")
                handles.append(local.data)
            return self._leaf(entries[name], local.data, dev, unpack)
        wanted = []
        _rebuild(like, lambda name, leaf: wanted.append((name, leaf)))
        try:
            with ThreadPoolExecutor(_READERS) as pool:
                got = dict(zip((name for name, _ in wanted),
                               pool.map(fetch, wanted)))
        finally:
            for data in handles:
                data.close()
        return _rebuild(like, lambda name, _: got[name])

    @staticmethod
    def _leaf(entry: dict, data, dev, unpack: bool):
        def tensor(a):           # np.load's fresh arrays, with no more copy
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(a).to(dev)
        arr = data[entry["key"]]
        dtype = _DTYPES[entry["dtype"]]
        if entry["packed"] and entry.get("format") == "wire":
            conv = entry.get("kind") == "conv"
            pw = PackedWeight(tensor(arr), entry["k"],
                              entry.get("kind", "dense"),
                              tuple(entry["shape"]) if conv else None, dtype)
            if entry.get("fold"):
                pw = pw.with_threshold(tensor(data[entry["key"] + "_thresh"]),
                                       tensor(data[entry["key"] + "_flip"]),
                                       entry["fold"])
            return pw.unpack() if unpack else pw
        if entry["packed"]:               # the older layout: last axis
            return unpack_bits(tensor(arr), entry["shape"][-1],
                               dtype=dtype).reshape(entry["shape"])
        if arr.dtype.kind == "V":         # a bfloat16 array written by JAX
            return tensor(arr.view(np.uint16)).view(torch.bfloat16)
        return tensor(arr).to(dtype)
