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

There is no ZeRO-1 here (the reference's ``zero1`` retags logical
sharding axes): the port trains on one device, and its specs carry no
axes.  A leaf above ``UPDATE_SLICE`` elements is updated in slices along
its first axis (without int8 EF, whose scale is the whole leaf's): the
same elementwise arithmetic, with one slice's temporaries, about four of
its size, where the whole leaf's would not fit beside the state (a
stacked Mamba ``in_proj`` of 24 layers at full width is 6.4 GB).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.params import Leaf, leaves, tree_map


#: the largest leaf, in elements, that the update takes in one piece
UPDATE_SLICE = 1 << 28


class OptState(NamedTuple):
    m: dict
    v: dict
    ef: Optional[dict]  # error-feedback residuals (int8 compression)


def adamw_init_specs(param_specs, *, compression: str) -> OptState:
    """Spec tree for the optimizer state: zero moments of the parameters'
    shapes, and zero residuals with ``compression="int8_ef"``."""
    def zeros(leaf: Leaf) -> Leaf:
        return Leaf(leaf.shape, init="zeros")
    ef = tree_map(zeros, param_specs) if compression == "int8_ef" else None
    return OptState(m=tree_map(zeros, param_specs),
                    v=tree_map(zeros, param_specs), ef=ef)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def _quantize_int8_ef(g: torch.Tensor, e: torch.Tensor):
    """int8 error-feedback: returns (dequantized g_hat, new residual)."""
    gf = g.float() + e
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, gf - g_hat


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, step, *, lr, beta1=0.9,
                 beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                 compression: str = "none"):
    """Returns (new_params, new_opt, metrics): ``params`` and ``opt``'s
    trees, updated in place.  ``step`` (int or tensor) is the update's
    0-based index; ``lr`` a float or a scalar tensor."""
    gnorm = global_norm(grads)
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
            g, residual = _quantize_int8_ef(g, e)
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
