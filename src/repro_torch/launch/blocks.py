"""Single-superblock step functions (port of ``repro.launch.blocks``).

The reference's compiled step runs its superblocks as a scan, whose body
XLA's cost analysis visits once, so its dry run also compiles one
superblock and scales it.  The port's step is eager and its trace visits
every superblock, so the dry run (``launch/dryrun.py``) traces the step
whole and uses none of these.  They stay as the reference's public
functions, held to it numerically: each does what one superblock of the
step does, under the run config's remat policy (the backward recomputes
the forward).

On a mesh a block's inputs are what a rank computes on: its rows of the
activations and the block's weights whole (the train step gathers its
weights before the forward, the inference step each block's just before
it), and a decode block's cache is the rank's block of it, as
``transformer.decode_step`` keeps it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.launch.inputs import _fp32_state, _struct
from repro_torch.launch.sharding import Axes
from repro_torch.models import transformer as T
from repro_torch.models.params import leaves, shape_tree, tree_map


def computed_on(ax: Axes):
    """The placement (``Axes.resolve``'s signature) of what a rank
    computes on: its own rows of a batch dimension, every other dimension
    whole (the step gathers its shards first)."""
    def resolve(axes: tuple, shape: tuple) -> tuple:
        return tuple(e if name == "batch" else None
                     for name, e in zip(axes, ax.resolve(axes, shape)))
    return resolve


def _superblock_fwd(cfg: ModelConfig, rc: RunConfig, ax: Axes):
    pattern = cfg.block_pattern()

    def fn(x, positions, *block_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (kind, is_moe) in enumerate(pattern):
            x, a = T.apply_block(cfg, rc, block_params[j], x, kind, is_moe,
                                 j, positions, ax=ax)
            aux = aux + a
        return x, aux
    return fn


def train_block_fn(cfg: ModelConfig, rc: RunConfig, ax: Axes, seq_len: int):
    """fwd+bwd of one superblock: fn(block_params, x) -> (the gradients
    of sum(y) + aux with respect to the block's parameters, a tuple of
    trees like ``block_params``, and with respect to ``x``; the real step
    propagates dx), under the configured remat policy."""
    fwd = T._remat(rc, _superblock_fwd(cfg, rc, ax))

    def fn(block_params, x):
        params = [tree_map(lambda t: t.detach().requires_grad_(True), p)
                  for p in block_params]
        x = x.detach().requires_grad_(True)
        positions = torch.arange(seq_len, device=x.device)
        y, aux = fwd(x, positions, *params)
        grads = iter(torch.autograd.grad(
            torch.sum(y.float()) + aux,
            [t for p in params for t in leaves(p)] + [x]))
        out = tuple(tree_map(lambda _: next(grads), p) for p in block_params)
        return out, next(grads)
    return fn


def prefill_block_fn(cfg: ModelConfig, rc: RunConfig, ax: Axes,
                     seq_len: int):
    """fn(block_params, x) -> y: one superblock's forward."""
    fwd = _superblock_fwd(cfg, rc, ax)

    def fn(block_params, x):
        positions = torch.arange(seq_len, device=x.device)
        return fwd(x, positions, *block_params)[0]
    return fn


def decode_block_fn(cfg: ModelConfig, rc: RunConfig, ax: Axes):
    pattern = cfg.block_pattern()

    def fn(block_params, x, cache, pos):
        new = {}
        for j, (kind, is_moe) in enumerate(pattern):
            x, new[f"b{j}"] = T.apply_block_decode(
                cfg, rc, block_params[j], x, cache[f"b{j}"], pos, kind,
                is_moe, j, ax=ax)
        return x, new
    return fn


def block_input_specs(cfg: ModelConfig, rc: RunConfig, shape: ShapeConfig,
                      ax: Axes):
    """(block_params, x [, cache, pos]) structs for the block module,
    placed as a rank computes on them (``computed_on``).

    With gradient accumulation a train step's block runs on the micro
    batch, so the block module is traced at global_batch / microbatches
    (and the roofline scales it by microbatches x n_superblocks).  The
    cache is placed as the whole decode step's (``inputs.decode_specs``),
    its SSM ``h`` float32."""
    on = computed_on(ax)
    bp = tuple(shape_tree(s, getattr(torch, rc.param_dtype), on, ax.mesh)
               for s in T.superblock_param_specs(cfg))
    b = shape.global_batch
    if shape.kind == "train" and rc.microbatches > 1:
        if b % rc.microbatches:
            raise ValueError(f"batch {b} % microbatches {rc.microbatches}")
        b //= rc.microbatches
    s = 1 if shape.kind == "decode" else shape.seq_len
    xs = _struct(ax, (b, s, cfg.d_model), ("batch", None, None),
                 getattr(torch, rc.compute_dtype))
    if shape.kind != "decode":
        return (bp, xs)
    step_ax = ax.for_batch(b)
    cache = shape_tree(T.cache_specs(cfg, b, shape.seq_len, stacked=False),
                       torch.bfloat16, step_ax.resolve, ax.mesh)
    return (bp, xs, _fp32_state(cache)["blocks"],
            _struct(ax, (), (), torch.int32))
