"""Meshes (port of `repro.launch.mesh`).

A `Mesh` is a grid of devices with named axes, ('data', 'model'), or
('pod', 'data', 'model') for the multi-pod production mesh: the serving
scheduler shards its slot batch and the train step its batch rows over the
batch axes ('pod', 'data'), and 'model' is the axis the tensor-parallel
kernel wrappers (`kernels.sharded`) split.
The JAX package's mesh is one controller driving every device; so is this
one: one process holds every shard's tensors, each on its own device, and
steps through the shards in turn. A device may repeat, so one card can
hold a whole mesh (`devices=[torch.device("cuda", 0)] * 4`, the port's
analogue of the JAX tests' forced host device count), and the CPU tests
build theirs over `["cpu"] * 4`.

    mesh = make_serving_mesh(2, 2)              # four cards, one per shard
    mesh = make_serving_mesh(2, 2, devices=["cuda:0"] * 4)   # one card
    data, model = parse_mesh("data=2,model=1")
    mesh = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)

The roofline's per-card peaks are the H100 SXM 80GB's (the JAX package
keeps a TPU v5e's here): datasheet figures, not measurements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.tune import HBM_BYTES_PER_S


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on a grid: `devices` an object ndarray of torch.device whose
    shape is the axes' sizes in `axis_names` order."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's `shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, **index: int) -> torch.device:
        """The device at the named axes' indices (0 for an axis not
        given)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]

    def shard_name(self, index: tuple[int, ...]) -> str:
        """`"cuda:0 (data 0, model 1)"`: a shard's device and place, which
        tells repeated devices apart."""
        where = ", ".join(f"{a} {i}" for a, i in zip(self.axis_names, index))
        return f"{self.devices[index]} ({where})"


def visible_devices() -> list[torch.device]:
    """One entry per visible CUDA card (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devices, shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(shape, dtype=object)
    flat = [torch.device(d) for d in devices]
    for i, d in enumerate(flat):
        grid.flat[i] = d
    return grid


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The JAX package's production mesh: (16, 16) as ('data', 'model'), or
    (2, 16, 16) as ('pod', 'data', 'model') with `multi_pod` ('pod' is pure
    data parallelism across pods). Over the first 256 (512) of `devices`
    (default: the visible cards); raises ValueError when there are fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = visible_devices() if devices is None else list(devices)
    need = math.prod(shape)
    if need > len(devs):
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} {axes} needs "
            f"{need} devices, have {len(devs)} (pass devices=, which may "
            f"repeat one device)")
    return Mesh(_grid(devs[:need], shape), axes)


def make_host_mesh(model: int = 1, devices=None) -> Mesh:
    """('data', 'model') mesh over every device of `devices` (default: the
    visible cards)."""
    devs = visible_devices() if devices is None else list(devices)
    n = len(devs)
    if not n or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return Mesh(_grid(devs, (n // model, model)), ("data", "model"))


def parse_mesh(spec: str) -> tuple[int, int]:
    """Parse a `--mesh` flag value into (data, model) axis sizes.

    Accepts bare sizes ('2,1', '4') or named ('data=2,model=1' in either
    order); a single number is the data axis with model=1. A bad spec
    raises ValueError."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty mesh spec: {spec!r}")
    if any("=" in p for p in parts):
        kv = dict(p.split("=", 1) for p in parts)
        unknown = set(kv) - {"data", "model"}
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)} in "
                             f"{spec!r}")
        return int(kv.get("data", 1)), int(kv.get("model", 1))
    if len(parts) > 2:
        raise ValueError(f"mesh spec has >2 axes: {spec!r}")
    data = int(parts[0])
    model = int(parts[1]) if len(parts) == 2 else 1
    return data, model


def make_serving_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """('data', 'model') mesh over the first data*model of `devices`
    (default: the visible cards, one per shard). Unlike `make_host_mesh` it
    need not cover every device, so a serving job can pin a sub-mesh.
    Raises ValueError when there are fewer devices than shards."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    devs = visible_devices() if devices is None else list(devices)
    need = data * model
    if need > len(devs):
        raise ValueError(
            f"mesh {data}x{model} needs {need} devices, have {len(devs)} "
            f"(pass devices=, which may repeat one device)")
    return Mesh(_grid(devs[:need], (data, model)), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# H100 SXM 80GB peaks used by the roofline analysis (per card; NVIDIA H100
# Tensor Core GPU datasheet). Datasheet peaks, not measurements: a number
# priced with them is an upper bound on rate, never a reading. The link
# term assumes a collective stays inside one NVLink domain (NVLink 4: 900
# GB/s both ways, 450 GB/s each way), as the JAX package's assumes one ICI
# link.
PEAK_FLOPS_BF16 = 989.4e12    # dense bf16 tensor-core FLOP/s
HBM_BW = HBM_BYTES_PER_S      # B/s of HBM3 (kernels.tune, one source)
LINK_BW = 450e9               # B/s per direction of NVLink 4
