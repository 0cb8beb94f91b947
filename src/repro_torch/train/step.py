"""The train step (port of ``repro.train.step``): autograd over the model
loss with microbatch gradient accumulation, mixed precision (float32
parameters, compute in the ``RunConfig``'s dtype, cast per call), global
norm clipping, the WSD schedule, AdamW and optional int8-EF gradient
compression.

``train_step(state, batch) -> (state, metrics)`` updates the state's
tensors in place (the reference's trainer donates them) and returns it
with its step advanced.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import Leaf, from_jax, init_tree, leaves
from repro_torch.optim.adamw import OptState, adamw_init_specs, adamw_update
from repro_torch.optim.schedule import lr_schedule


class TrainState(NamedTuple):
    step: torch.Tensor      # () int32
    params: dict
    opt: OptState


def train_state_specs(cfg: ModelConfig, rc: RunConfig) -> TrainState:
    """Leaf-spec tree for the whole TrainState (init + checkpoint), for
    every block kind; a frontend's embeddings are inputs, not leaves."""
    pspecs = T.model_specs(cfg)
    return TrainState(
        step=Leaf((), init="zeros"),
        params=pspecs,
        opt=adamw_init_specs(pspecs, compression=rc.grad_compression))


def init_train_state(cfg: ModelConfig, rc: RunConfig,
                     generator: torch.Generator,
                     device="cuda") -> TrainState:
    """Random parameters from ``generator`` (a generator on ``device``),
    zero moments and residuals, step 0."""
    specs = train_state_specs(cfg, rc)
    params = init_tree(specs.params, generator,
                       getattr(torch, rc.param_dtype), device)

    def zeros(tree):
        return None if tree is None else init_tree(
            tree, generator, torch.float32, device)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        opt=OptState(zeros(specs.opt.m), zeros(specs.opt.v),
                     zeros(specs.opt.ef)))


def train_state_from_jax(cfg: ModelConfig, rc: RunConfig, state_np,
                         device="cuda") -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (``step``,
    ``params``, ``opt.m``, ``opt.v``, ``opt.ef``) as the port's, on
    ``device``; every leaf must have its spec's shape."""
    specs = train_state_specs(cfg, rc)

    def convert(spec, tree):
        if (spec is None) != (tree is None):
            raise ValueError("the state's int8-EF residuals do not match "
                             f"grad_compression={rc.grad_compression!r}")
        return None if spec is None else from_jax(spec, tree, device)
    return TrainState(
        step=torch.tensor(np.asarray(state_np.step), dtype=torch.int32,
                          device=device),
        params=convert(specs.params, state_np.params),
        opt=OptState(convert(specs.opt.m, state_np.opt.m),
                     convert(specs.opt.v, state_np.opt.v),
                     convert(specs.opt.ef, state_np.opt.ef)))


def _unflat(like, it):
    """``like``'s dict structure, its leaves taken from ``it`` in
    ``leaves`` order."""
    if isinstance(like, dict):
        return {k: _unflat(v, it) for k, v in like.items()}
    return next(it)


def make_train_step(cfg: ModelConfig, rc: RunConfig,
                    total_steps: int = 10_000):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    scalar tensors: ``loss``, ``aux``, ``grad_norm`` and ``lr``."""

    def grads_of(params, batch):
        diff = [p.detach().requires_grad_(True) for p in leaves(params)]
        tree = _unflat(params, iter(diff))

        def value_and_grad(mb):
            total, met = T.loss_fn(cfg, rc, tree, mb)
            grads = torch.autograd.grad(total, diff)
            return (total.detach(), {k: v.detach() for k, v in met.items()},
                    grads)

        n = rc.microbatches
        if n <= 1:
            l, met, g = value_and_grad(batch)
            return l, met, _unflat(params, iter(g))
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} % microbatches {n}")
        acc_l = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        acc_g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in diff]
        for i in range(n):
            mb = {k: x[i * (b // n):(i + 1) * (b // n)]
                  for k, x in batch.items()}
            l, met, g = value_and_grad(mb)
            acc_l = acc_l + l / n
            for a, gi in zip(acc_g, g):
                a.add_(gi.float() / n)
        return acc_l, met, _unflat(params, iter(acc_g))

    def train_step(state: TrainState, batch: dict):
        l, met, g = grads_of(state.params, batch)
        lr = lr_schedule(state.step, base_lr=rc.learning_rate,
                         warmup=rc.warmup_steps, total=total_steps,
                         kind=rc.schedule)
        params, opt, om = adamw_update(
            state.params, g, state.opt, state.step, lr=lr,
            weight_decay=rc.weight_decay, grad_clip=rc.grad_clip,
            compression=rc.grad_compression)
        metrics = {**met, **om, "loss": l, "lr": lr}
        return TrainState(state.step + 1, params, opt), metrics

    return train_step
