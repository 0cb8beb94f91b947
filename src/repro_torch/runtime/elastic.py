"""Elastic scaling (port of ``repro.runtime.elastic``): rebuild the mesh
from the ranks that are running and reshard the latest checkpoint onto it.

The data pipeline is stateless in (step, shard), checkpoints hold full
arrays, and ``elastic_restore`` places each onto the *new* mesh by its
template leaf's placements, so a job that loses (or gains) ranks resumes
from the last checkpoint at a different world size with no
reconfiguration beyond ``make_current_mesh()``.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                               _unflatten, latest_step,
                                               restore_checkpoint)
from repro_torch.launch.mesh import compat_make_mesh


def current_mesh_shape(n: int, prefer_model: int = 0) -> tuple:
    """(data, model) for ``n`` ranks: model = ``prefer_model`` if it
    divides n, else the largest power of two <= sqrt(n) that divides n."""
    if prefer_model and n % prefer_model == 0:
        model = prefer_model
    else:
        model = 1
        while model * 2 <= math.isqrt(n) and n % (model * 2) == 0:
            model *= 2
    return n // model, model


def make_current_mesh(prefer_model: int = 0):
    """Build the best (data, model) mesh from the running ranks: the
    default process group's world size, or one rank when no group runs
    (then ``compat_make_mesh`` asks for a group: start one first with
    ``repro_torch.launch.mesh.init_distributed``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return compat_make_mesh(current_mesh_shape(n, prefer_model),
                            ("data", "model"))


def elastic_restore(ckpt_dir: str, template_state):
    """Restore the latest checkpoint onto (a possibly different) mesh.

    template_state: a tree of tensors with the state's structure, shapes
    and dtypes; a leaf that is a DTensor (placed on the NEW mesh) is
    restored as a DTensor with its mesh and placements, every other leaf
    onto its device.  Returns (state, step) or (template_state, None) when
    no checkpoint exists."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    step = latest_step(ckpt_dir)
    if step is None:
        return template_state, None
    full = restore_checkpoint(ckpt_dir, step, template_state)
    like = [leaf for _, leaf in _flatten_with_paths(template_state)]
    got = [leaf for _, leaf in _flatten_with_paths(full)]
    out = [distribute_tensor(g, t.device_mesh, t.placements)
           if isinstance(t, DTensor) else g for t, g in zip(like, got)]
    return _unflatten(template_state, out), step
