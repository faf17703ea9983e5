"""Fault-tolerant training loop: checkpoint and restart, failure
injection, straggler accounting.

The port of the JAX package's ``train/loop.py`` on one device:

  state  = (params, opt)           # nested dicts of tensors on the device
  data   = deterministic (seed, step) pipeline -> same batches after restart
  ckpt   = atomic + async (ckpt.CheckpointManager)

* ``inject_failure_at`` raises mid-run; a fresh ``run()`` on the same
  directory restores the latest committed step and reproduces the same
  loss trajectory.
* Stragglers: every step's wall time (the injectable ``clock`` around
  the step, ending in a synchronize: reading the loss) is kept, and a
  step slower than ``straggler_factor`` times the median of the last 32
  is flagged.
* History: ``{"step", "loss", "grad_norm", "wall_s"}`` every
  ``log_every`` steps and at the last.

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticDataset
from ..dist.sharding import Runtime
from ..models.config import ModelConfig
from .train_step import TrainConfig, make_train_state, make_train_step

__all__ = ["LoopConfig", "TrainLoop"]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    keep: int = 3
    straggler_factor: float = 3.0
    inject_failure_at: Optional[int] = None   # raise to simulate a node loss


class TrainLoop:
    def __init__(self, cfg: ModelConfig, rt: Runtime, data: DataConfig,
                 tc: Optional[TrainConfig] = None,
                 lc: Optional[LoopConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self.cfg, self.rt = cfg, rt
        self.tc = tc or TrainConfig()
        self.lc = lc or LoopConfig(total_steps=100)
        self.device = resolve_device(device)
        self.data = SyntheticDataset(cfg, data, rt, self.device)
        self.clock = clock
        self.step_fn = make_train_step(cfg, rt, self.tc)
        self.mgr = (CheckpointManager(self.lc.ckpt_dir, self.lc.keep)
                    if self.lc.ckpt_dir else None)
        self.history: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, opt = make_train_state(self.cfg, self.rt, gen, self.tc,
                                       device=self.device)
        return {"params": params, "opt": opt}

    def _maybe_restore(self, state):
        start = 0
        if self.mgr is not None:
            try:
                state, extra = self.mgr.restore_latest(state)
                start = int(extra.get("next_step", 0))
            except FileNotFoundError:
                pass
        return state, start

    # -- run --------------------------------------------------------------
    def run(self, seed: int = 0) -> Dict[str, Any]:
        state = self.init_state(seed)
        state, start = self._maybe_restore(state)
        times: List[float] = []
        for step in range(start, self.lc.total_steps):
            if self.lc.inject_failure_at is not None and \
                    step == self.lc.inject_failure_at:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.data.batch(step)
            t0 = self.clock()
            params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                                batch, step)
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])   # waits for the step
            dt = self.clock() - t0
            times.append(dt)
            med = float(np.median(times[-32:]))
            if len(times) > 4 and dt > self.lc.straggler_factor * med:
                self.straggler_steps.append(step)
            if step % self.lc.log_every == 0 or step == self.lc.total_steps - 1:
                self.history.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "wall_s": dt})
            if self.mgr is not None and (step + 1) % self.lc.ckpt_every == 0:
                self.mgr.save(step + 1, state, {"next_step": step + 1})
        if self.mgr is not None:
            self.mgr.save(self.lc.total_steps, state,
                          {"next_step": self.lc.total_steps})
            self.mgr.wait()
        return {"state": state, "history": self.history,
                "stragglers": self.straggler_steps}
