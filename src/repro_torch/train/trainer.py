"""The trainer loop (port of ``repro.train.trainer``): the train step on
one device or on a mesh, async checkpointing, auto-resume, preemption
drain, straggler watchdog and bounded retry.

On a mesh (a ``DeviceMesh`` over every rank of the default process group)
each rank keeps its shard of every state leaf, placed by
``spec_tree(train_state_specs, make_axes(mesh, rc).resolve)`` (ZeRO-1
moments included), and trains on its rows of ``SyntheticLM.batch(step)``
split over the batch axes (``repro_torch.train.step``).  A checkpoint
holds full arrays in the reference's format: the shards are gathered
leaf by leaf by every rank and copied to rank 0's host, which writes.  A
resume reads each full array on the host and keeps this rank's block of
it under the current mesh's placements, whatever mesh wrote the
checkpoint.  A fresh state is drawn leaf by leaf the same way, so the
state's init, checkpoint and resume hold no more than one whole leaf on a
device at a time (the step gathers a whole stacked leaf per forward).
"""
from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import (Checkpointer, latest_step,
                                               restore_checkpoint)
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.sharding import (NO_AXES, gather_shard,
                                         local_shard, make_axes)
from repro_torch.models.params import tree_map
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StepWatchdog, retry_step)
from repro_torch.train.step import (init_train_state, make_train_step,
                                    state_placements, train_state_specs)

log = logging.getLogger("repro_torch.train")


def _own_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full``: a copy where it is a part (so the
    whole is freed), ``full`` itself where it is all of it."""
    block = local_shard(full, spec, mesh)
    return full if block.shape == full.shape else block.clone()


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
        mesh = self.mesh
        ax = make_axes(mesh, self.rc) if mesh is not None else NO_AXES
        step_fn = make_train_step(self.cfg, self.rc,
                                  total_steps=self.tc.total_steps, ax=ax)
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        specs = keep = None
        if mesh is not None:
            specs = state_placements(self.cfg, self.rc, ax)
            keep = tree_map(lambda spec: functools.partial(
                _own_block, spec=spec, mesh=mesh), specs)
            n_rows = ax.batch_size()
            if self.dataset.global_batch % n_rows:
                raise ValueError(f"global batch "
                                 f"{self.dataset.global_batch} does not "
                                 f"split over {n_rows} data ranks")
            state = init_train_state(self.cfg, self.rc, gen, self.device,
                                     place=keep)
        else:
            state = init_train_state(self.cfg, self.rc, gen, self.device)
        start = 0
        ckpt = Checkpointer(self.tc.ckpt_dir, self.tc.keep_ckpts) \
            if self.tc.ckpt_dir else None
        if ckpt:
            state, resumed = self._restore(state, keep)
            if resumed is not None:
                start = resumed
                log.info("resumed from step %d", start)

        watchdog = StepWatchdog()
        last_metrics: dict = {}
        with PreemptionGuard() as guard:
            for step in range(start, self.tc.total_steps):
                batch = self.dataset.batch(step, device=self.device)
                if mesh is not None:
                    batch = {k: local_shard(v, (ax.batch,), mesh)
                             for k, v in batch.items()}
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
                stop = self._agree(guard.should_stop)
                if ckpt and ((step + 1) % self.tc.ckpt_every == 0 or stop):
                    self._save(ckpt, step + 1, state, specs)
                if stop:
                    log.warning("preempted at step %d; checkpoint taken", step)
                    break
        if ckpt:
            ckpt.wait()
        if mesh is not None:
            dist.barrier()        # rank 0's checkpoint is on disk
        return {"state": state, "history": self.history,
                "stragglers": watchdog.stragglers,
                "final": last_metrics}

    def _agree(self, stop: bool) -> bool:
        """On a mesh, stop when any rank was told to (every rank must take
        the same checkpoint, which is a collective)."""
        if self.mesh is None:
            return stop
        flag = torch.tensor([int(stop)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _save(self, ckpt: Checkpointer, step: int, state, specs) -> None:
        """Checkpoint full arrays: on a mesh every rank gathers the shards
        of one leaf at a time, rank 0 copies it to its host and writes."""
        if self.mesh is None:
            ckpt.save(step, state)
            return
        writer = dist.get_rank() == 0

        def to_host(t, spec):
            full = gather_shard(t, spec, self.mesh)
            return full.to("cpu", copy=True) if writer else None
        with torch.no_grad():
            host = tree_map(to_host, state, specs)
        if writer:
            ckpt.save(step, host, copy=False)

    def _restore(self, state, keep):
        """The latest checkpoint in ``tc.ckpt_dir``: (state, step), or
        (state, None) without one.  On a mesh each full array is read on
        the host and this rank keeps its block (``keep``)."""
        if self.mesh is None:
            return elastic_restore(self.tc.ckpt_dir, state)
        step = latest_step(self.tc.ckpt_dir)
        if step is None:
            return state, None
        like = tree_map(lambda t, leaf: torch.empty(
            leaf.shape, dtype=t.dtype, device="meta"), state,
            train_state_specs(self.cfg, self.rc))
        return restore_checkpoint(self.tc.ckpt_dir, step, like,
                                  device=self.device, place=keep), step
