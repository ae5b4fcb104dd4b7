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

The model runs on `device` (None: the CUDA card; it raises without one).
A sharded run over a mesh waits for ROADMAP Queue A item 6.
"""
from __future__ import annotations

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
from repro_torch.models.api import get_model
from repro_torch.optim.base import Optimizer
from repro_torch.train.step import default_optimizer, make_train_step


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
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                 optimizer: Optimizer | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError("training over a mesh waits for the "
                                      "sharded trainer (ROADMAP Queue A "
                                      "item 6)")
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
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
        self.opt_state = self.opt.init(self.params)
        self.train_step = make_train_step(self.model, self.opt,
                                          accum=tc.accum)
        self.start_step = 0
        self._saved_step: int | None = None

    # ------------------------------------------------------------ lifecycle
    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.params, self.opt_state = self.ckpt.restore(
            latest, (self.params, self.opt_state))
        self.start_step = self._saved_step = latest
        return True

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
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    def _save(self, step: int) -> None:
        self.ckpt.save(step, (self.params, self.opt_state))
        self._saved_step = step

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        old = self._install_signal_handlers()
        try:
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
