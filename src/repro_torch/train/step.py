"""The train step (port of ``repro.train.step``): autograd over the model
loss with microbatch gradient accumulation, mixed precision (float32
parameters, compute in the ``RunConfig``'s dtype, cast per call), global
norm clipping, the WSD schedule, AdamW and optional int8-EF gradient
compression.

``train_step(state, batch) -> (state, metrics)`` updates the state's
tensors in place (the reference's trainer donates them) and returns it
with its step advanced.

On a mesh (``ax`` with a ``DeviceMesh``) the step is explicit FSDP: every
state tensor is this rank's shard, placed by
``spec_tree(train_state_specs(cfg, rc), ax.resolve)``, and the batch is
this rank's rows.  The weights are all-gathered before the forward; the
forward and backward run on the local rows (the model ranks of one data
group compute the same rows); each rank's loss seeds its own backward,
and every collective's backward is its exact adjoint, so a shard's
gradient, summed over the ranks that hold it and divided by the world
size, is the mean over the data ranks of the whole batch's gradient.
The update then runs on the shards, with the global norm and the int8
scale all-reduced (``adamw_update(mesh=)``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.mesh import axis_names, chips, mesh_shape
from repro_torch.launch.sharding import (NO_AXES, Axes, all_reduce_sum,
                                         gather_shard, spec_axes)
from repro_torch.models import transformer as T
from repro_torch.models.params import (Leaf, from_jax, init_tree, leaves,
                                       spec_tree, tree_map)
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
        step=Leaf((), (), init="zeros"),
        params=pspecs,
        opt=adamw_init_specs(pspecs, zero1=rc.zero1,
                             compression=rc.grad_compression))


def init_train_state(cfg: ModelConfig, rc: RunConfig,
                     generator: torch.Generator,
                     device="cuda", place=None) -> TrainState:
    """Random parameters from ``generator`` (a generator on ``device``),
    zero moments and residuals, step 0.  ``place`` (a ``TrainState`` of
    callables) maps each leaf to what is kept of it as it is made
    (``init_tree``)."""
    specs = train_state_specs(cfg, rc)
    place = place or tree_map(lambda _: None, specs)

    def make(tree, keep, dtype):
        return None if tree is None else init_tree(tree, generator, dtype,
                                                   device, keep)
    step = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(
        step=step if place.step is None else place.step(step),
        params=make(specs.params, place.params,
                    getattr(torch, rc.param_dtype)),
        opt=OptState(make(specs.opt.m, place.opt.m, torch.float32),
                     make(specs.opt.v, place.opt.v, torch.float32),
                     make(specs.opt.ef, place.opt.ef, torch.float32)))


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


def state_placements(cfg: ModelConfig, rc: RunConfig, ax: Axes):
    """The resolved spec of every ``TrainState`` leaf on ``ax``'s mesh.
    A parameter and its moments must be placed alike: ZeRO-1 retags only
    parameters with no logical axis, which no config has."""
    specs = spec_tree(train_state_specs(cfg, rc), ax.resolve)
    for moments in (specs.opt.m, specs.opt.v):
        if leaves(moments) != leaves(specs.params):
            raise NotImplementedError(
                "a moment placed apart from its parameter (ZeRO-1 on a "
                "parameter with no logical axis) is not supported")
    return specs


def make_train_step(cfg: ModelConfig, rc: RunConfig,
                    total_steps: int = 10_000, *, ax: Axes = NO_AXES):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    scalar tensors: ``loss``, ``aux``, ``grad_norm`` and ``lr``.  With a
    mesh in ``ax`` the state is this rank's shards and the batch its rows
    (module docstring); the metrics are the whole batch's."""
    mesh = ax.mesh
    specs = state_placements(cfg, rc, ax).params if mesh is not None \
        else None

    def whole(tree):
        """The model's weights from this rank's shards."""
        if mesh is None:
            return tree
        return tree_map(lambda t, spec: gather_shard(t, spec, mesh), tree,
                        specs)

    def reduce_grads(g):
        """Sum each shard's gradient over the ranks that hold it, then
        divide by the world size, in place."""
        sizes = mesh_shape(mesh)

        def one(t, spec):
            for a, n in sizes.items():
                if n > 1 and a not in spec_axes(spec):
                    dist.all_reduce(t, group=mesh.get_group(a))
            return t.div_(chips(mesh))
        return tree_map(one, g, specs)

    def grads_of(params, batch):
        diff = [p.detach().requires_grad_(True) for p in leaves(params)]

        def value_and_grad(mb):
            tree = whole(_unflat(params, iter(diff)))
            total, met = T.loss_fn(cfg, rc, tree, mb, ax=ax)
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
        if mesh is not None and chips(mesh) > 1:     # one rank: as is
            with torch.no_grad():
                g = reduce_grads(g)
                world, everyone = chips(mesh), axis_names(mesh)
                l = all_reduce_sum(l, mesh, everyone) / world
                met = {k: all_reduce_sum(v, mesh, everyone) / world
                       for k, v in met.items()}
        lr = lr_schedule(state.step, base_lr=rc.learning_rate,
                         warmup=rc.warmup_steps, total=total_steps,
                         kind=rc.schedule)
        params, opt, om = adamw_update(
            state.params, g, state.opt, state.step, lr=lr,
            weight_decay=rc.weight_decay, grad_clip=rc.grad_clip,
            compression=rc.grad_compression, mesh=mesh, specs=specs)
        metrics = {**met, **om, "loss": l, "lr": lr}
        return TrainState(state.step + 1, params, opt), metrics

    return train_step
