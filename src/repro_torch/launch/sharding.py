"""Logical-axis -> mesh-axis resolution (port of ``repro.launch.sharding``)
and the explicit collectives that place and move shards on a mesh.

Default placement, the "2D FSDP+TP" layout:

  logical axis        mesh axis
  ---------------     -------------------------------
  embed / dinner_in   data   (FSDP rows; weights all-gathered before use)
  ffn / heads / kv_heads / dinner / experts / vocab
                      model  (tensor / expert / vocab parallel)
  batch               (pod, data)
  seq (SP/cache)      model  (sequence-sharded KV cache & residual stream)
  layers / state / conv / head_dim / dt_rank
                      None   (never sharded)

Divisibility fallback: a dim whose size does not divide the mesh axis stays
unsharded (e.g. minicpm's 36 heads, mixtral's 8 experts on a 16-way model
axis, kv=8 heads).  A mesh axis is used at most once per param (priority =
dim order), so (experts, embed, ffn) resolves to ('model', 'data', None).

``Axes.resolve`` gives one entry per dimension: ``None``, a mesh-axis name
or a tuple of names, equal entry for entry to the reference's
``PartitionSpec``.  ``to_placements`` turns such a spec into DTensor
placements.  The model itself runs on plain tensors, never on DTensors:
``shard``, ``act`` and ``heads_act`` are identities (in the reference they
are layout hints that leave the numbers unchanged), and the trainer moves
shards with the collectives below, each an autograd function whose
backward is its forward's exact adjoint.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_names, mesh_shape

# logical -> preferred mesh axis (in resolution priority per param)
WEIGHT_RULES = {
    "experts": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "dinner": "model",
    "embed": "data",
    "layers": None,
    "head_dim": None,
    "state": None,
    "conv": None,
    "dt_rank": None,
    None: None,
}


@dataclass(frozen=True)
class Axes:
    """Physical mesh context the model code shards against."""
    mesh: object = None            # DeviceMesh, a stand-in, or None
    batch: tuple = ("data",)       # ("pod","data") multi-pod
    tp: str = "model"
    fsdp: str = "data"             # "" disables 2D weight sharding
    seq_parallel: bool = False

    def size(self, name: str) -> int:
        if self.mesh is None or not name:
            return 1
        return mesh_shape(self.mesh)[name]

    def batch_size(self) -> int:
        out = 1
        for a in self.batch:
            out *= self.size(a)
        return out

    def _candidates(self, name) -> tuple:
        """Ordered mesh-axis candidates for one logical axis."""
        if name == "batch":
            return self.batch
        if name == "seq":
            # cache/sequence sharding: model primary; data joins when the
            # batch left it idle
            return ("data", "model")
        mesh_axis = WEIGHT_RULES.get(name, None)
        if mesh_axis == "data":
            mesh_axis = self.fsdp or None
        if mesh_axis == "model":
            mesh_axis = self.tp or None
        return (mesh_axis,) if mesh_axis else ()

    # -- weight/cache resolution ---------------------------------------------
    def resolve(self, axes: tuple, shape: tuple) -> tuple:
        used: set = set()
        out = []
        for name, dim in zip(axes, shape):
            chosen, prod = [], 1
            for a in self._candidates(name):
                if not a or a in used or self.size(a) <= 1:
                    continue
                if dim % (prod * self.size(a)) == 0:
                    chosen.append(a)
                    prod *= self.size(a)
            if not chosen:
                out.append(None)
            else:
                used.update(chosen)
                out.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
        return tuple(out)

    # -- activation constraints ----------------------------------------------
    def shard(self, x, *axes):
        """The reference's layout constraint: the identity here, with or
        without a mesh (activations are plain local tensors)."""
        return x

    def act(self, x):
        """Residual-stream constraint (B, S, D): the identity."""
        return self.shard(x, self.batch, None, None)

    def heads_act(self, x):
        """(B, S, H|KV, HD) constraint: the identity."""
        return self.shard(x, self.batch, None, self.tp, None)


def make_axes(mesh, run_cfg=None) -> Axes:
    names = axis_names(mesh) if mesh is not None else ()
    batch = tuple(a for a in ("pod", "data") if a in names) or ("data",)
    return Axes(mesh=mesh, batch=batch,
                tp="model" if (mesh is None or "model" in names) else "",
                fsdp=(run_cfg.fsdp_axis if run_cfg else "data")
                if (mesh is None or "data" in names) else "",
                seq_parallel=bool(run_cfg and run_cfg.seq_parallel))


NO_AXES = Axes(mesh=None)


# -- placements ---------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    """A spec entry's mesh axes, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> tuple:
    """Every mesh axis a resolved spec shards over."""
    return tuple(a for e in spec for a in _entry_axes(e))


def to_placements(spec, mesh) -> tuple:
    """DTensor placements (one per mesh axis) of a resolved spec.  A
    tensor dim split over several mesh axes is split major axis first;
    DTensor lists the shards of one dim in mesh-axis order, which is the
    same order where those axes are in mesh order (every spec ``resolve``
    gives for this package's meshes)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if name in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicas(spec, mesh) -> int:
    """How many ranks hold each element of a tensor placed by ``spec``."""
    sizes = mesh_shape(mesh)
    held = spec_axes(spec)
    n = 1
    for a, s in sizes.items():
        if a not in held:
            n *= s
    return n


def local_shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    sizes = mesh_shape(mesh)
    out = full
    for d, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
        if n > 1:
            out = out.tensor_split(n, dim=d)[idx]
    return out


# -- differentiable collectives ----------------------------------------------

class _AllGather(torch.autograd.Function):
    """Concatenate the group's tensors along ``dim``.  Backward: the sum
    of every rank's gradient, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient to other consumers
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return g.tensor_split(n, dim=ctx.dim)[me].contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """Split dim 0 into the group's size, send block i to rank i, and
    stack the received blocks along dim 0.  It is its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    """The group's sum.  Backward: the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x``'s blocks from the ranks along mesh ``axis``, concatenated
    along ``dim`` in rank order (differentiable)."""
    if mesh_shape(mesh)[axis] == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Block i of ``x``'s dim 0 to rank i along ``axis``; block j of the
    result from rank j (differentiable)."""
    if mesh_shape(mesh)[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis))


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along every mesh axis in ``axes``
    (differentiable)."""
    sizes = mesh_shape(mesh)
    for a in axes:
        if sizes[a] > 1:
            x = _AllReduceSum.apply(x, mesh.get_group(a))
    return x


def gather_shard(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local_shard`` under ``spec``
    (differentiable: the gradient of a block is the sum, over the ranks
    that gathered it, of their gradients of that block)."""
    out = local
    for d, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            out = all_gather(out, mesh, a, d)
    return out
