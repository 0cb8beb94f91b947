"""Pipeline parallelism (port of ``repro.train.pipeline``): a GPipe-style
microbatch ring over one mesh axis (production target: the ``pod`` axis —
inter-pod links are the slowest, and a pipeline crosses them once per
microbatch instead of per-layer collective).

``pipelined(stage_fn, mesh, axis_name)`` returns ``f(stage_params,
microbatches) -> outputs`` where

  * stage_params has a leading stage axis (``stack_stage_params``); the
    rank at position s of ``axis_name`` runs stage s's slice,
  * microbatches is (n_micro, micro_batch, ...) and flows through the ring
    by point-to-point sends to the next stage; the schedule runs
    ``n_micro + n_stages − 1`` ticks (the GPipe bubble: (S−1)/(M+S−1) idle
    fraction — pick M ≫ S),
  * at the end the last stage's outputs are all-reduced over the axis, so
    every stage returns them.

Neither gloo nor NCCL sends a rank to itself, so with one stage the ring
is a local copy.  ``f`` is the forward only; the reference's trainer does
not reach it either.  Equality with the serial stack is held on 4 gloo
ranks in tests/test_torch_pipeline.py.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.params import tree_map


def pipelined(stage_fn, mesh, axis_name: str = "stage"):
    """Build the pipelined apply function.

    stage_fn(stage_params, x) -> y — one stage's compute (same signature
    and output shape as input on every stage)."""
    n_stages = mesh_shape(mesh)[axis_name]
    group = mesh.get_group(axis_name) if n_stages > 1 else None

    def peer(i: int) -> int:
        return dist.get_global_rank(group, i % n_stages)

    @torch.no_grad()
    def run(stage_params, xs):
        stage = mesh.get_local_rank(axis_name)
        params = tree_map(lambda v: v[stage], stage_params)
        n_micro = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        ys = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            inp = xs[min(t, n_micro - 1)] if stage == 0 else buf
            out = stage_fn(params, inp)
            t_out = t - (n_stages - 1)
            if stage == n_stages - 1 and t_out >= 0:
                ys[t_out] = out
            if n_stages == 1:
                buf = out
                continue
            out = out.contiguous()
            buf = torch.empty_like(out)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, out, peer(stage + 1), group),
                    dist.P2POp(dist.irecv, buf, peer(stage - 1), group)]):
                req.wait()
        if n_stages > 1:
            # the last stage's outputs, replicated
            if stage != n_stages - 1:
                ys.zero_()
            dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=group)
        return ys

    return run


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe idle fraction = (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> stacked tree with leading stage
    axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)
