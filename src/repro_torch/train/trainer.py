"""The trainer loop (port of ``repro.train.trainer``): the train step on
one device, async checkpointing, auto-resume, preemption drain, straggler
watchdog and bounded retry.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StepWatchdog, retry_step)
from repro_torch.train.step import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    keep_ckpts: int = 3


@dataclass
class Trainer:
    cfg: ModelConfig
    rc: RunConfig
    tc: TrainerConfig
    dataset: SyntheticLM
    mesh: object = None
    metrics_cb: Optional[Callable[[int, dict], None]] = None
    device: str = "cuda"

    history: list = field(default_factory=list)

    def run(self) -> dict:
        """Train from a fresh state (parameters from a generator seeded
        with ``tc.seed``) or from the latest checkpoint in ``tc.ckpt_dir``;
        returns {"state", "history", "stragglers", "final"}."""
        if self.mesh is not None:
            raise NotImplementedError(
                "training on a mesh is not ported yet: meshes and "
                "collectives are ROADMAP item 27; the port trains on one "
                "device (mesh=None)")
        step_fn = make_train_step(self.cfg, self.rc,
                                  total_steps=self.tc.total_steps)
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        state = init_train_state(self.cfg, self.rc, gen, self.device)
        start = 0
        ckpt = Checkpointer(self.tc.ckpt_dir, self.tc.keep_ckpts) \
            if self.tc.ckpt_dir else None
        if ckpt:
            state, resumed = elastic_restore(self.tc.ckpt_dir, state)
            if resumed is not None:
                start = resumed
                log.info("resumed from step %d", start)

        watchdog = StepWatchdog()
        last_metrics: dict = {}
        with PreemptionGuard() as guard:
            for step in range(start, self.tc.total_steps):
                batch = self.dataset.batch(step, device=self.device)
                t0 = time.perf_counter()
                state, metrics = retry_step(step_fn, state, batch)
                # float() waits for the step's device work
                last_metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                watchdog.observe(step, dt)
                last_metrics["step_time_s"] = dt
                if step % self.tc.log_every == 0 or \
                        step == self.tc.total_steps - 1:
                    self.history.append({"step": step, **last_metrics})
                    log.info("step %d %s", step, last_metrics)
                    if self.metrics_cb:
                        self.metrics_cb(step, last_metrics)
                if ckpt and ((step + 1) % self.tc.ckpt_every == 0
                             or guard.should_stop):
                    ckpt.save(step + 1, state)
                if guard.should_stop:
                    log.warning("preempted at step %d; checkpoint taken", step)
                    break
        if ckpt:
            ckpt.wait()
        return {"state": state, "history": self.history,
                "stragglers": watchdog.stragglers,
                "final": last_metrics}
