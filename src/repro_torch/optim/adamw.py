"""AdamW with float32 master state, global-norm clipping and optional int8
error-feedback gradient compression (port of ``repro.optim.adamw``).

Trees are the port's nested dicts of tensors.  ``OptState`` keeps the
reference's fields, so a checkpoint of it has the reference's leaf paths
(``.m[...]``, ``.v[...]``, ``.ef[...]``) and restores in either package.
The update follows the reference's order of operations: clip, then int8
error feedback, then the moments, bias correction and decoupled decay.  It
runs under ``torch.no_grad()`` and writes params, moments and residuals in
place, where the reference's trainer donates their buffers: the trees
passed in are the trees returned, so a leaf of ``m`` must not share its
storage with a leaf of ``v``.

ZeRO-1 retags the logical axes of an unsharded parameter's moments, as
the reference does.  On a mesh (``mesh=`` with the parameters' resolved
placements) every tensor is this rank's shard: the global norm and the
int8 error-feedback scale, which are whole-tree and whole-leaf
quantities, are all-reduced over the mesh (the squared norm summed, each
element counted once; the scale's maximum), so clipping equals one
device's.  A leaf above ``UPDATE_SLICE`` elements is updated in slices along
its first axis (without int8 EF, whose scale is the whole leaf's): the
same elementwise arithmetic, with one slice's temporaries, about four of
its size, where the whole leaf's would not fit beside the state (a
stacked Mamba ``in_proj`` of 24 layers at full width is 6.4 GB).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_names
from repro_torch.launch.sharding import (all_reduce_, all_reduce_sum,
                                         replicas)
from repro_torch.models.params import (Leaf, leaves, tree_map,
                                       tree_map_leaves)


#: the largest leaf, in elements, that the update takes in one piece
UPDATE_SLICE = 1 << 28


class OptState(NamedTuple):
    m: dict
    v: dict
    ef: Optional[dict]  # error-feedback residuals (int8 compression)


def adamw_init_specs(param_specs, *, zero1: bool,
                     compression: str) -> OptState:
    """Spec tree for the optimizer state: zero moments of the parameters'
    shapes, and zero residuals with ``compression="int8_ef"``.  ZeRO-1
    retags the first dim of a parameter with no logical axis as 'embed'
    (FSDP), so its moments shard over data."""
    def moment(leaf: Leaf) -> Leaf:
        axes = leaf.axes
        if zero1 and all(a is None for a in axes) and leaf.shape:
            axes = ("embed",) + axes[1:]
        return Leaf(leaf.shape, axes, init="zeros")
    ef = tree_map_leaves(lambda l: Leaf(l.shape, l.axes, init="zeros"),
                         param_specs) if compression == "int8_ef" else None
    return OptState(m=tree_map_leaves(moment, param_specs),
                    v=tree_map_leaves(moment, param_specs), ef=ef)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def _mesh_global_norm(tree, mesh, specs) -> torch.Tensor:
    """The global norm of a tree of shards: each rank's squared sums, each
    divided by how many ranks hold that shard, summed over the mesh."""
    sq = sum(leaves(tree_map(
        lambda g, spec: torch.sum(torch.square(g.float()))
        / replicas(spec, mesh), tree, specs)))
    return torch.sqrt(all_reduce_sum(sq, mesh, axis_names(mesh)))


def _quantize_int8_ef(g: torch.Tensor, e: torch.Tensor, amax_of=None):
    """int8 error-feedback: returns (dequantized g_hat, new residual).
    ``amax_of`` maps this tensor's largest magnitude to the whole leaf's
    (a mesh's all-reduce), where ``g`` is a shard."""
    gf = g.float() + e
    amax = gf.abs().max()
    if amax_of is not None:
        amax = amax_of(amax)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, gf - g_hat


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, step, *, lr, beta1=0.9,
                 beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                 compression: str = "none", mesh=None, specs=None):
    """Returns (new_params, new_opt, metrics): ``params`` and ``opt``'s
    trees, updated in place.  ``step`` (int or tensor) is the update's
    0-based index; ``lr`` a float or a scalar tensor.  On a ``mesh``,
    every tensor is this rank's shard, placed by ``specs`` (a tree like
    ``params`` of ``Axes.resolve`` entries, which the moments and
    residuals share)."""
    amax_of = None
    if mesh is None:
        gnorm = global_norm(grads)
    else:
        gnorm = _mesh_global_norm(grads, mesh, specs)

        def amax_of(x):
            return all_reduce_(x.clone(), mesh, axis_names(mesh),
                               op=dist.ReduceOp.MAX)
    clip = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if grad_clip else 1.0)
    stepf = torch.as_tensor(step).to(torch.float32) + 1
    bc1 = 1.0 - torch.pow(beta1, stepf)
    bc2 = 1.0 - torch.pow(beta2, stepf)

    def upd(p, g, m, v, e):
        n = min(-(-p.numel() // UPDATE_SLICE), p.shape[0] if p.dim() else 1)
        if n > 1 and e is None:
            for part in zip(*(t.tensor_split(n) for t in (p, g, m, v))):
                upd_piece(*part, None)
        else:
            upd_piece(p, g, m, v, e)
        return p

    def upd_piece(p, g, m, v, e):
        g = g.float() * clip
        if e is not None:
            g, residual = _quantize_int8_ef(g, e, amax_of)
            e.copy_(residual)
        m.copy_(beta1 * m + (1 - beta1) * g)
        v.copy_(beta2 * v + (1 - beta2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.float()
        p.copy_(p.float() - lr * update)

    if compression == "int8_ef":
        tree_map(upd, params, grads, opt.m, opt.v, opt.ef)
    else:
        tree_map(lambda p, g, m, v: upd(p, g, m, v, None), params, grads,
                 opt.m, opt.v)
    return params, opt, {"grad_norm": gnorm}
