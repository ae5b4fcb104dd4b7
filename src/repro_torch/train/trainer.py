"""The fault-tolerant LM training loop (port of `repro.train.trainer`).

  * a checkpoint every `ckpt_every` steps (async), restore-from-latest on
    start: a killed and restarted run continues bit for bit (the synthetic
    data and the step's binarization noise are pure functions of the step,
    and every op of the step is deterministic);
  * preemption safety: SIGTERM / SIGINT set a stop flag; the loop stops
    before the next step and writes a final synchronous checkpoint, as it
    does at the end of every run;
  * a straggler watchdog: an EMA of the step's wall time; steps slower
    than `straggler_factor` x EMA are recorded (the first step of a run,
    which builds and warms up, never seeds the EMA);
  * the history every `log_every` steps and at the last.

    trainer = Trainer(cfg, TrainConfig(steps=..., ckpt_dir=...))
    out = trainer.run()          # {"final_step", "history", "stragglers",
                                 #  "interrupted"}

The model runs on `device` (None: the CUDA card; it raises without one),
or over `mesh` (a `launch.mesh.Mesh`), as the JAX trainer places it: the
params drawn once from the seed on the mesh's first device, as on one
device, and placed by `launch.shardings.param_shardings` (rows over
'data', ZeRO-3; columns, rows or experts over 'model'); the optimizer
state initialised on the pieces, so its moments mirror their params and
its counters replicate (`train.step.init_placed_state`); the step
`train.step.make_train_step(mesh=, specs=)`. Its checkpoints hold whole
logical arrays, so a run resumes on any mesh, or on one device, from a
checkpoint written on any other (elastic restore; also a replicated
layout's), and continues bit for bit on the mesh it was written from.

    trainer = Trainer(cfg, tc, mesh=make_host_mesh(devices=["cpu"] * 2))
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import LMDataConfig, SyntheticLM
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardctx import activation_sharding
from repro_torch.launch.shardings import (
    Sharding, join_leaf, param_shardings, param_specs, place_leaf,
    resident_bytes,
)
from repro_torch.models.api import get_model
from repro_torch.optim.base import Optimizer, tree_map
from repro_torch.train.step import (
    default_optimizer, init_placed_state, make_train_step, state_shardings,
)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 1e-3
    accum: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0
    data_branching: int = 4


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The binarization noise of step `step` (mode 'bbp'): a fresh
    generator on `device` seeded from `seed` and the step, so a resumed
    run draws what the uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) & 0x7FFF_FFFF_FFFF_FFFF)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *,
                 mesh: Mesh | None = None,
                 optimizer: Optimizer | None = None, device=None):
        """`device` runs a single-device trainer; with a `mesh` it must be
        None (the mesh names its devices)."""
        if mesh is not None and device is not None:
            raise ValueError("pass a mesh or a device, not both: the mesh "
                             "names its devices")
        self.cfg, self.tc, self.mesh = cfg, tc, mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices.flat[0]
        self.model = get_model(cfg)
        self.opt = optimizer or default_optimizer(cfg, tc.lr)
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep)
        self.data = SyntheticLM(LMDataConfig(
            vocab=cfg.vocab, seq_len=tc.seq_len,
            global_batch=tc.global_batch, seed=tc.seed,
            branching=tc.data_branching))
        self._stop = False
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.history: list[dict] = []
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.params = self.model.init(gen, device=self.device)
        self.shardings, specs = None, None
        if mesh is None:
            self.opt_state = self.opt.init(self.params)
        else:
            specs = param_specs(self.params)
            p_sh = param_shardings(mesh, self.params)
            self.params = tree_map(place_leaf, self.params, p_sh)
            self.opt_state = init_placed_state(self.opt, self.params, mesh)
            self.shardings = (p_sh, state_shardings(
                self.opt_state, self.params, p_sh, Sharding(mesh, ())))
        self.train_step = make_train_step(self.model, self.opt,
                                          accum=tc.accum, mesh=mesh,
                                          specs=specs)
        self.start_step = 0
        self._saved_step: int | None = None

    # ------------------------------------------------------------ lifecycle
    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.params, self.opt_state = self.ckpt.restore(
            latest, (self.params, self.opt_state), self.shardings)
        self.start_step = self._saved_step = latest
        return True

    def full_state(self) -> tuple:
        """(params, opt_state) as whole tensors (over a mesh, the pieces
        joined on the first piece's device)."""
        if self.mesh is None:
            return self.params, self.opt_state
        return tree_map(join_leaf, (self.params, self.opt_state),
                        self.shardings)

    def resident_bytes_per_device(self) -> dict:
        """What each shard of the mesh holds, in bytes: {shard: {"params",
        "opt_state", "total"}}, keyed `"cuda:0 (data 0, model 1)"` (repeated
        devices stay apart): its own pieces (a piece that shards on one
        device share, such as a replicated leaf's, counted at each)."""
        if self.mesh is None:
            raise ValueError("resident_bytes_per_device needs a mesh")
        p = resident_bytes(self.params, self.mesh)
        s = resident_bytes(self.opt_state, self.mesh)
        return {k: {"params": p[k], "opt_state": s[k],
                    "total": p[k] + s[k]} for k in p}

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            self._stop = True
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass                    # not the main thread
        return old

    def _batch(self, step: int) -> dict:
        """The global batch of `step` on the (first) device; the mesh step
        cuts each shard's rows from it (`train.step.split_rows`)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    def _save(self, step: int) -> None:
        self.ckpt.save(step, (self.params, self.opt_state),
                       shardings=self.shardings)
        self._saved_step = step

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        """The loop from the latest checkpoint (over a mesh inside its
        `launch.shardctx.activation_sharding`, as the JAX trainer runs)."""
        old = self._install_signal_handlers()
        ctx = contextlib.nullcontext() if self.mesh is None \
            else activation_sharding(self.mesh)
        try:
            with ctx:
                return self._run()
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run(self) -> dict:
        self.maybe_restore()
        tc = self.tc
        ema = None
        final = self.start_step
        for step in range(self.start_step, tc.steps):
            if self._stop:
                break
            t0 = time.time()
            batch = self._batch(step)
            gen = step_generator(tc.seed + 17, step, self.device) \
                if self.cfg.quant == "bbp" else None
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch, gen)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.step_times.append(dt)
            if step == self.start_step:
                pass
            elif ema is None:
                ema = dt
            else:
                if dt > tc.straggler_factor * ema:
                    self.straggler_steps.append(step)
                ema = 0.9 * ema + 0.1 * dt
            if step % tc.log_every == 0 or step == tc.steps - 1:
                self.history.append({"step": step, "loss": loss,
                                     "sec": round(dt, 3)})
            if (step + 1) % tc.ckpt_every == 0:
                self._save(step + 1)
            final = step + 1
        # the final synchronous checkpoint, also the preemption path (a
        # periodic save of this very step only needs to finish)
        self.ckpt.async_save = False
        if self._saved_step != final:
            self._save(final)
        self.ckpt.wait()
        return {"final_step": final, "history": self.history,
                "stragglers": self.straggler_steps,
                "interrupted": self._stop}
