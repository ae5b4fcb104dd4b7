"""Per-device cost of a step, counted at dispatch (the port's analogue of
`repro.roofline.hlo`).

The JAX package reads its costs from the post-GSPMD HLO of a compiled step.
The port has no compiled program: it runs its step eagerly. So `count`
runs the step itself under `torch._subclasses.fake_tensor.FakeTensorMode`
(shapes, dtypes and devices; no data, no memory) over fake devices, one
per mesh position (`fake_devices`: meta:i, and lazy:i past 128 positions,
since torch keeps a device's index in 8 bits), and counts each aten op at
dispatch (`torch.utils._python_dispatch.TorchDispatchMode`). Per device
(the device of the op's output) it returns:

  * flops: matmul-class ops (mm, addmm, bmm, baddbmm, convolution, the
    scaled-dot-product attentions) as `torch.utils.flop_counter` counts
    them, plus each hand-written kernel's own formula where a kernel is
    reached (`kernel_call`; kernel 10 on falcon-mamba's prefill and
    decode). Elementwise ops add none, as in `hlo.py`.
  * hbm_bytes: operand plus result bytes of every aten op that moves data
    (views and allocations move none; a copy reads its source and writes
    its destination), each on its own device. The port runs eagerly and
    unfused, so this is each launch's traffic. It is not the JAX
    package's count, which charges a whole XLA fusion once: the port's
    elementwise chains (binarize, the STE masks, norms) are counted at
    every op.
  * collectives: bytes that arrive on a device from another (a `_to_copy`
    or `copy_` across devices), by kind -- "gather" where `core.placed`
    joins pieces, "reduce" where a gradient goes back to its pieces or is
    summed on its home device, "other" for the rest (a batch shard's rows,
    a tensor-parallel part's operand) -- with their counts and
    `total_bytes`, the shape of `hlo.parse_collectives`'s result.
    `core.placed`'s per-piece copies are charged as their ops would be
    (`charge_copies`), not dispatched.
  * memory: argument_size_in_bytes (the inputs' storages on the device),
    temp_size_in_bytes (the peak of live storage above the arguments,
    each storage counted once whatever its views) and
    output_size_in_bytes (the outputs' storages): the keys of the JAX
    package's `_mem_dict` that have a meaning here.

Ops whose output lands on the host (`cpu`: scalars, host reads) are kept
apart, under "host", from every device's numbers.

The step of a mesh runs its batch shards in turn in one process, and
updates each device's pieces in turn: units of work that repeat one shape
(`train.step.repeat_hook`). Shard j's is shard i's with every device moved
j - i places along the batch axes; device d's update is device c's with c
renamed d. With `one_shard` (the default) the first two units of a shape
are traced (the second tells which outputs move with the unit) and every
later one is replayed: its counts added where they move, its peak laid on
the devices' live bytes, its outputs made as empty tensors of their
shapes (or handed back, where an output is one of its arguments). This is
the port's analogue of `hlo.py`'s trip-count correction; the replay is
exact (tests/test_torch_roofline.py holds it to a full trace). A unit
whose work does not fit the replay (it frees a storage made before it,
keeps one that is not among its outputs, or the second is not the first
moved) runs as it is.

Outside `count` nothing of this is active: the steps run as they do, and
a kernel wrapper handed a meta tensor raises.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import defaultdict
from typing import Callable

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

KINDS = ("gather", "reduce", "other")
# the port's function that makes a cross-device copy -> its kind (the
# innermost frame of the port decides; a copy made anywhere else is
# "other")
_SITES = {"join_pieces": "gather", "split_grad": "reduce",
          "update_placed": "reduce", "sum_into": "reduce",
          "train_step": "reduce"}
# ops that move no data (an allocation or a metadata change)
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten._unsafe_view.default,
               aten.lift_fresh.default, aten.detach.default}
_COPIES = {aten._to_copy.default, aten.copy_.default}

_ACTIVE: list["_Counter"] = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors of a tree: dicts, lists, tuples (NamedTuples too),
    object ndarrays (placed leaves) and objects with tensor fields
    (`PackedWeight`)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, np.ndarray) and x.dtype == object:
        for v in x.flat:
            yield from _tensors(v)
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        for v in vars(x).values():
            if isinstance(v, (torch.Tensor, dict, list, tuple, np.ndarray)):
                yield from _tensors(v)


def _in_node(name: str) -> bool:
    """Whether the op runs inside the backward of autograd node `name`."""
    node = torch._C._current_autograd_node()
    return node is not None and node.name() == name


def _kind() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith("count.py"):
            return _SITES.get(f.f_code.co_name, "other")
        f = f.f_back
    return "other"


class _Stats:
    __slots__ = ("flops", "hbm_bytes", "coll", "coll_n", "ops", "kernels")

    def __init__(self):
        self.flops = self.hbm_bytes = self.ops = 0
        self.coll = dict.fromkeys(KINDS, 0)
        self.coll_n = dict.fromkeys(KINDS, 0)
        self.kernels: dict[str, int] = {}

    def add(self, other: "_Stats", sign: int = 1) -> None:
        self.flops += sign * other.flops
        self.hbm_bytes += sign * other.hbm_bytes
        self.ops += sign * other.ops
        for k in KINDS:
            self.coll[k] += sign * other.coll[k]
            self.coll_n[k] += sign * other.coll_n[k]
        for k, n in other.kernels.items():
            self.kernels[k] = self.kernels.get(k, 0) + sign * n

    def copy(self) -> "_Stats":
        out = _Stats()
        out.add(self)
        return out

    def report(self) -> dict:
        return {"flops": int(self.flops), "hbm_bytes": int(self.hbm_bytes),
                "collectives": {
                    "per_op": {k: int(v) for k, v in self.coll.items() if v},
                    "counts": {k: int(v) for k, v in self.coll_n.items()
                               if v},
                    "total_bytes": int(sum(self.coll.values()))},
                "ops": int(self.ops),
                "kernels": {k: v for k, v in self.kernels.items() if v}}


class _Counter(TorchDispatchMode):
    """The dispatch-level counter (module doc). Devices are keyed by name
    ("meta:3", "cpu")."""

    def __init__(self, mesh=None, one_shard: bool = True):
        super().__init__()
        self.stats: dict[str, _Stats] = defaultdict(_Stats)
        self.storages: dict[int, tuple[str, int, int]] = {}
        self.live: dict[str, int] = defaultdict(int)
        self.peak: dict[str, int] = defaultdict(int)
        self.args: dict[str, int] = defaultdict(int)
        self.quiet = 0
        self.epoch = 0            # storages made before a window are older
        self.window: dict | None = None
        self.mesh, self.one_shard = mesh, one_shard
        self.templates: dict = {}
        self.failed: set = set()

    # -- storages ------------------------------------------------------------
    def track(self, t: torch.Tensor, arg: bool = False) -> None:
        st = t.untyped_storage()
        key = StorageWeakRef(st).cdata
        if key in self.storages:
            return
        dev, n = str(t.device), st.nbytes()
        self.storages[key] = (dev, n, self.epoch)
        self.live[dev] += n
        if arg:
            self.args[dev] += n
        if self.live[dev] > self.peak[dev]:
            self.peak[dev] = self.live[dev]
        w = self.window
        if w is not None:
            d = self.live[dev] - w["base"].get(dev, 0)
            if d > w["peak"].get(dev, 0):
                w["peak"][dev] = d
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        entry = self.storages.pop(key, None)
        if entry is None:
            return
        dev, n, epoch = entry
        self.live[dev] -= n
        w = self.window
        if w is not None and epoch < w["epoch"]:
            w["ok"] = False       # a shard freed a storage older than it

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.index_put.default and _in_node("IndexBackward0"):
            # autograd's backward of x[idx] accumulates into its fresh
            # zeros in place for a plain tensor, and out of place (a second
            # buffer of x's size) only for a tensor subclass or under a
            # dispatch mode (FunctionsManual's index_backward), as every
            # counted op is: the card's step runs the former
            func = aten.index_put_.default
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if self.quiet or not outs:
            return out
        dev = str(outs[0].device)
        st = self.stats[dev]
        st.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            st.flops += int(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
        if func.is_view or func in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if func in _COPIES:
            src = ins[1] if func is aten.copy_.default else ins[0]
            n = _nbytes(outs[0])
            self.stats[str(src.device)].hbm_bytes += _nbytes(src)
            st.hbm_bytes += n
            if src.device != outs[0].device:
                kind = _kind()
                st.coll[kind] += n
                st.coll_n[kind] += 1
            return out
        for t in ins:
            self.stats[str(t.device)].hbm_bytes += _nbytes(t)
        for t in outs:
            st.hbm_bytes += _nbytes(t)
        return out

    @contextlib.contextmanager
    def silent(self):
        """Ops that only make tensors: tracked as storage, not counted."""
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    # -- the one-shard replay ------------------------------------------------
    def _mover(self, kind: str, j0, j1) -> Callable[[str], str]:
        """Device name -> where it goes when unit j0's work is unit j1's.
        A batch shard ("shard", j the shard's number): every device moves
        j1 - j0 shards along the batch axes (their indices row-major, the
        other axes kept). A device's update ("device", j its name): j0
        becomes j1. A device off the mesh stays."""
        if kind == "device":
            return lambda name: j1 if name == j0 else name
        from repro_torch.launch.mesh import batch_axes
        mesh, shift = self.mesh, j1 - j0
        shape, names = mesh.devices.shape, mesh.axis_names
        ba = [i for i, a in enumerate(names) if a in batch_axes(mesh)]
        sizes = [shape[i] for i in ba]
        n = int(np.prod(sizes)) if sizes else 1
        where = {str(d): ix for ix, d in np.ndenumerate(mesh.devices)}

        def move(name: str) -> str:
            ix = where.get(name)
            if ix is None or not shift:
                return name
            b = int(np.ravel_multi_index([ix[i] for i in ba], sizes))
            sub = np.unravel_index((b + shift) % n, sizes)
            new = list(ix)
            for i, j in zip(ba, sub):
                new[i] = int(j)
            return str(mesh.devices[tuple(new)])
        return move

    def repeat(self, kind: str, j, fn: Callable, args: tuple):
        """Unit j's fn(*args) (a batch shard's work, or a device's
        optimizer update): traced, or replayed from the first traced unit
        of its signature. The first two units of a signature are traced:
        the second tells which outputs move with the unit (a row's
        activations, a replica's gradient) and which stay (a piece's
        gradient lands on the piece's device whichever shard computes
        it)."""
        if not self.one_shard or self.mesh is None or self.window is not None:
            return fn(*args)
        sig = (kind, id(fn), tuple((tuple(t.shape), t.dtype)
                                   for t in _tensors(args)))
        if sig in self.failed:
            return fn(*args)
        tpl = self.templates.get(sig)
        if tpl is not None and "moves" in tpl:
            return self._replay(tpl, j, args)
        out, rec = self._traced(kind, j, fn, args)
        if rec is None:
            self.failed.add(sig)
        elif tpl is None:
            self.templates[sig] = rec
        else:
            moves = self._moves(tpl, rec)
            if moves is None:
                self.failed.add(sig)
            else:
                tpl["moves"] = moves
        return out

    def _traced(self, kind: str, j, fn: Callable, args: tuple):
        """(fn(*args), its record: the counts it added per device, its
        peak above the live bytes it started from, its outputs' layout:
        each a new storage's view or one of its arguments), the record
        None where the unit does not fit a replay."""
        before = {d: s.copy() for d, s in self.stats.items()}
        self.epoch += 1
        self.window = {"base": dict(self.live), "peak": {},
                       "epoch": self.epoch, "ok": True}
        try:
            out = fn(*args)
        finally:
            w, self.window = self.window, None
        deltas = {}
        for d, s in self.stats.items():
            delta = s.copy()
            if d in before:
                delta.add(before[d], -1)
            deltas[d] = delta
        end = {d: self.live[d] - w["base"].get(d, 0) for d in self.live}
        argpos = {id(t): k for k, t in enumerate(_tensors(args))}
        leaves, spec = tree_flatten(out)
        recs, stores, index = [], [], {}
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                recs.append(("value", t))
                continue
            key = StorageWeakRef(t.untyped_storage()).cdata
            entry = self.storages.get(key)
            if entry is None or entry[2] != w["epoch"]:
                if id(t) not in argpos:
                    return out, None      # made before, not an argument
                recs.append(("arg", argpos[id(t)]))
                continue
            if key not in index:
                index[key] = len(stores)
                stores.append((entry[1], t.dtype, entry[0]))
            elif stores[index[key]][1] != t.dtype:
                return out, None
            recs.append(("tensor", tuple(t.shape), t.stride(),
                         t.storage_offset(), index[key]))
        kept: dict[str, int] = defaultdict(int)
        for n, dtype, dev in stores:
            kept[dev] += n
            if n % dtype.itemsize:
                return out, None
        if not w["ok"] or any(end.get(d, 0) != kept.get(d, 0)
                              for d in set(end) | set(kept)):
            return out, None     # it freed an older storage or kept more
        return out, {"kind": kind, "j": j, "deltas": deltas,
                     "peak": w["peak"], "spec": spec, "leaves": recs,
                     "stores": stores}

    def _moves(self, tpl: dict, rec: dict) -> list[bool] | None:
        """Per output storage of `tpl`, whether it moves with the unit,
        read from a second traced unit `rec`; None where the second's
        counts, peak or outputs are not the first's moved."""
        def layout(leaves):      # a view's offset may differ by unit
            return [r[:3] + r[4:] if r[0] == "tensor" else r for r in leaves]
        if layout(rec["leaves"]) != layout(tpl["leaves"]) \
                or rec["spec"] != tpl["spec"] \
                or len(rec["stores"]) != len(tpl["stores"]):
            return None
        move = self._mover(tpl["kind"], tpl["j"], rec["j"])
        moved: dict[str, _Stats] = defaultdict(_Stats)
        for d, delta in tpl["deltas"].items():
            moved[move(d)].add(delta)
        peak = {move(d): pk for d, pk in tpl["peak"].items() if pk}
        devs = set(moved) | set(rec["deltas"])
        if any(moved[d].report() != rec["deltas"].get(d, _Stats()).report()
               for d in devs) \
                or peak != {d: p for d, p in rec["peak"].items() if p}:
            return None          # the units' work is not one moved shape
        out = []
        for (n0, t0, d0), (n1, t1, d1) in zip(tpl["stores"], rec["stores"]):
            if (n0, t0) != (n1, t1) or d1 not in (d0, move(d0)):
                return None
            out.append(d1 != d0)
        return out

    def _replay(self, tpl: dict, j, args: tuple):
        move = self._mover(tpl["kind"], tpl["j"], j)
        for d, delta in tpl["deltas"].items():
            self.stats[move(d)].add(delta)
        for d, pk in tpl["peak"].items():
            m = move(d)
            self.peak[m] = max(self.peak[m], self.live[m] + pk)
        argl = list(_tensors(args))
        leaves = []
        with self.silent():
            bases = [torch.empty(n // dtype.itemsize, dtype=dtype,
                                 device=move(dev) if moves else dev)
                     for (n, dtype, dev), moves in zip(tpl["stores"],
                                                       tpl["moves"])]
            for rec in tpl["leaves"]:
                if rec[0] == "value":
                    leaves.append(rec[1])
                elif rec[0] == "arg":
                    leaves.append(argl[rec[1]])
                else:
                    _, shape, stride, offset, k = rec
                    leaves.append(bases[k].as_strided(shape, stride, offset))
        return tree_unflatten(leaves, tpl["spec"])

    # -- the report ------------------------------------------------------------
    def report(self, devices: list[str], outputs) -> dict:
        outs: dict[str, int] = defaultdict(int)
        seen = set()
        for t in _tensors(outputs):
            key = StorageWeakRef(t.untyped_storage()).cdata
            if key not in seen:
                seen.add(key)
                outs[str(t.device)] += t.untyped_storage().nbytes()
        per = {}
        for d in dict.fromkeys(devices + [d for d in self.stats
                                          if d != "cpu"]):
            r = self.stats[d].report() if d in self.stats \
                else _Stats().report()
            r["memory"] = {
                "argument_size_in_bytes": int(self.args[d]),
                "output_size_in_bytes": int(outs[d]),
                "temp_size_in_bytes": int(max(0, self.peak[d]
                                              - self.args[d]))}
            per[d] = r
        host = self.stats["cpu"].report() if "cpu" in self.stats \
            else _Stats().report()
        return {"devices": per, "host": host}


def fake_mode():
    """The FakeTensorMode a count runs under: make the step's inputs inside
    it (on `meta:i` devices) and call `count` inside it too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    # its op cache is keyed on every argument's metadata: a step's ops
    # rarely repeat one key, so hashing costs more than it saves
    mode.cache_enabled = False
    return mode


# The device types a fake position may take. torch keeps a device's index
# in 8 bits (0-127 read back as written), so one type names 128 positions;
# "lazy" is the one other type a CPU-only build lets a fake tensor carry.
FAKE_TYPES = ("meta", "lazy")
MAX_POSITIONS = 128 * len(FAKE_TYPES)


def fake_devices(n: int, last: int = 1) -> list[torch.device]:
    """n fake devices, one per mesh position, in mesh order (row-major,
    `last` the size of the mesh's last axis, 'model'). Up to 128: meta:0
    on. Past that, the first half of each row of the last axis on meta,
    the second half on lazy: a batch shard runs on its row's 'model' 0
    device, and `torch.utils.checkpoint` (remat) knows no lazy device.
    More than MAX_POSITIONS (the multi-pod mesh's 512) raise ValueError:
    torch cannot name them apart."""
    if n <= 128:
        return [torch.device("meta", i) for i in range(n)]
    if n > MAX_POSITIONS or last % 2 or n % last:
        raise ValueError(
            f"{n} positions (rows of {last}): torch.device keeps its index "
            f"in 8 bits, so the fake devices "
            f"({', '.join(t + ':0-127' for t in FAKE_TYPES)}) name at most "
            f"{MAX_POSITIONS}, half of each row on each type")
    half = last // 2
    return [torch.device(FAKE_TYPES[(i % last) // half],
                         (i // last) * half + i % half) for i in range(n)]


def counting(device: torch.device) -> bool:
    """Whether a kernel wrapper handed a tensor on `device` is inside a
    count on a fake position (it then charges its kernel's own work with
    `kernel_call`)."""
    return bool(_ACTIVE) and device.type in FAKE_TYPES


def count(fn: Callable, *args, mesh=None, one_shard: bool = True,
          **kwargs) -> dict:
    """fn(*args, **kwargs) counted per device (module doc). Call it inside
    `fake_mode()` with inputs made there. `mesh`: the step's mesh (its
    devices are reported even where nothing ran, and its batch shards are
    replayed from the first with `one_shard`). Returns {"devices": {name:
    {flops, hbm_bytes, collectives, ops, kernels, memory}}, "host": {...},
    "result": fn's return value}."""
    from repro_torch.train import step as train_step
    c = _Counter(mesh, one_shard)
    for t in _tensors((args, kwargs)):
        c.track(t, arg=True)
    devices = [] if mesh is None else [str(d) for d in mesh.devices.flat]
    hook = train_step.repeat_hook
    _ACTIVE.append(c)
    train_step.repeat_hook = c.repeat
    try:
        with c:
            out = fn(*args, **kwargs)
    finally:
        train_step.repeat_hook = hook
        _ACTIVE.pop()
    rep = c.report(devices, out)
    rep["result"] = out
    return rep


def kernel_call(name: str, device: torch.device, *, flops: int,
                nbytes: int, outputs: list[tuple]) -> list[torch.Tensor]:
    """A hand-written kernel's call on a fake device inside `count`: its
    own formula's flops and bytes charged to `device`, one launch under
    `kernels[name]`, and its outputs (each (shape, dtype)) made empty on
    the device. Outside a count there is no kernel for a meta device:
    ValueError."""
    if not _ACTIVE:
        raise ValueError(f"no {name} kernel for device {device}")
    c = _ACTIVE[-1]
    with c.silent():
        outs = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype in outputs]
    st = c.stats[str(device)]
    st.flops += int(flops)
    st.hbm_bytes += int(nbytes)
    st.ops += 1
    st.kernels[name] = st.kernels.get(name, 0) + 1
    return outs


def charge_copies(copies: list[tuple], kind: str) -> None:
    """Copies inside a count, each (source tensor, destination device,
    bytes), charged as a copy op charges them (the bytes read on the
    source's device, written on the destination's, and arriving there as
    a collective of `kind` where the two differ) without dispatching them:
    `core.placed`'s gathers and gradient splits, whose per-piece copies
    would otherwise be most of a step's ops on a large mesh."""
    c = _ACTIVE[-1]
    if c.quiet:
        return
    for src, dst, n in copies:
        c.stats[str(src.device)].hbm_bytes += n
        st = c.stats[str(dst)]
        st.hbm_bytes += n
        st.ops += 1
        if src.device != dst:
            st.coll[kind] += n
            st.coll_n[kind] += 1


def total(rep: dict, key: str) -> int:
    """The sum over devices of a count's `key` ("flops", "hbm_bytes")."""
    return sum(d[key] for d in rep["devices"].values())


def busiest(rep: dict) -> dict:
    """The per-device numbers a roofline row reads: the largest of each
    over the devices (the step ends when its slowest device does)."""
    devs = list(rep["devices"].values())
    coll = max(devs, key=lambda d: d["collectives"]["total_bytes"])
    return {"flops": max(d["flops"] for d in devs),
            "hbm_bytes": max(d["hbm_bytes"] for d in devs),
            "collectives": coll["collectives"],
            "memory": {k: max(d["memory"][k] for d in devs)
                       for k in devs[0]["memory"]}}


