"""Meshes (port of ``repro.launch.mesh``): torch ``DeviceMesh``es over the
ranks of the default process group.  Functions, not module-level meshes:
importing this module creates no process group.

A mesh here is what ``init_device_mesh`` returns.  The sharding layer also
takes a stand-in with only ``.shape`` (a dict of axis sizes) and
``.axis_names``, so that placements can be resolved for the 256- and
512-chip production meshes that no process group here can build.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

SINGLE_POD = (16, 16)                 # 256 chips/pod
MULTI_POD = (2, 16, 16)               # 2 pods = 512 chips

#: the torchrun variables a multi-process launch sets
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: str = "cuda") -> None:
    """Start the default process group unless one is running: NCCL for
    ``device="cuda"``, gloo for ``"cpu"``.  Under ``torchrun`` (its
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_*`` variables) it joins the
    launch; without them it starts a one-rank group on an in-process
    store."""
    if dist.is_initialized():
        return
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if all(k in os.environ for k in _LAUNCH_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _device_type() -> str:
    """The device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def compat_make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks (rank-major, the last axis fastest, as
    ``jax.make_mesh`` lays devices), on the group's device type.  The
    group must be running and hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("compat_make_mesh: no process group; start one "
                           "(init_distributed) first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes)


def axis_names(mesh) -> tuple:
    """A mesh's axis names (a ``DeviceMesh`` or a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def chips(mesh) -> int:
    return int(math.prod(mesh_shape(mesh).values()))
