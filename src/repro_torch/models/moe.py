"""Mixture-of-experts with banked dispatch (port of ``repro.models.moe``):
the paper's arbitration math applied to expert routing.

Experts are banks; a top-k routed token is k memory requests; its
position in the expert is the carry-chain arbiter's grant cycle (the
exclusive count of earlier requests to the same expert); the capacity
factor is the cycle budget, and requests over it are dropped.

Two implementations, as in the reference:
  * ``gshard``  — einsum dispatch and combine through a (G, S, E, C)
    one-hot;
  * ``scatter`` — index-based dispatch: tokens go straight into their
    (E, C) slots and come back by a gather.

Priority order is GShard's: all first choices (token order), then all
second choices.  The reference's sharding constraints (``ax.shard``,
``moe_legacy_shard``) are layout hints with no meaning here and are
dropped.  On a mesh the groups are cut from the whole batch's tokens, as
the reference's GSPMD cuts them: where a data rank's rows hold whole
groups it routes them itself, the load-balance statistics averaged over
the batch axes so the aux loss is the whole batch's; where a group spans
data ranks, the rows are gathered over the batch axes, the whole batch is
routed on every rank and each keeps its own rows (``_whole_batch``).
``moe_impl="a2a"`` takes the
expert-parallel all-to-all layer (``repro_torch.models.moe_a2a``) where
``a2a_applicable``, else ``gshard``, as the reference does.
The router reaches no kernel: its grant positions come from the
``moe_dispatch`` registry entry's ``ref`` (``grant_positions``), as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.sharding import (NO_AXES, Axes, all_reduce_sum,
                                         gather_shard, local_shard)
from repro_torch.models.layers import _act
from repro_torch.models.params import Leaf, fan_in_scale


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": Leaf((d, e), ("embed", None), scale=fan_in_scale(d)),
        "w1": Leaf((e, d, f), ("experts", "embed", "ffn"),
                   scale=fan_in_scale(d)),
        "w3": Leaf((e, d, f), ("experts", "embed", "ffn"),
                   scale=fan_in_scale(d)),
        "w2": Leaf((e, f, d), ("experts", "ffn", "embed"),
                   scale=fan_in_scale(f)),
    }


def capacity(cfg: ModelConfig, group_len: int) -> int:
    """Slots per expert for a group of ``group_len`` tokens: the capacity
    factor times the group's ``experts_per_token`` requests spread over
    ``n_experts``, rounded up to a multiple of 4, at least 4."""
    c = cfg.capacity_factor * cfg.experts_per_token * group_len / cfg.n_experts
    return max(4, -(-int(c) // 4) * 4)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) is a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(cfg: ModelConfig, p: dict, x: torch.Tensor, ax: Axes = NO_AXES):
    """x: (G, S, D) -> top-k expert ids (G, S, k) int32, their combine
    weights and the load-balance loss.  Among equal probabilities the
    lower expert id ranks first, as ``jax.lax.top_k`` orders them (a
    stable descending sort; ``torch.topk`` keeps no such order)."""
    logits = torch.einsum("gsd,de->gse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    aux = _load_balance_loss(probs, top_e, cfg.n_experts, ax)
    return top_e.to(torch.int32), top_p, aux


def _load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                       n_experts: int, ax: Axes = NO_AXES) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob × token fraction per expert),
    the statistics averaged over the batch axes on a mesh."""
    frac = _one_hot(top_e[..., 0], n_experts, torch.float32).mean(dim=(0, 1))
    mean_p = probs.mean(dim=(0, 1))
    if ax.mesh is not None:
        n = ax.batch_size()
        frac = all_reduce_sum(frac, ax.mesh, ax.batch) / n
        mean_p = all_reduce_sum(mean_p, ax.mesh, ax.batch) / n
    return n_experts * torch.sum(frac * mean_p)


def arbiter_positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Grant slots for (G, S, k) requests in GShard / arbiter priority
    order: flattened to (G, k·S) with every first choice before every
    second choice, dispatched uncapped through the ``moe_dispatch``
    registry entry's ``ref`` (the capacity budget is the caller's
    ``pos < cap``), then restored to (G, S, k)."""
    from repro_torch.kernels import registry as _kernels
    g, s, k = top_e.shape
    req = top_e.permute(0, 2, 1).reshape(g, k * s)
    pos, _ = _kernels.get("moe_dispatch").ref(None, req, n_experts,
                                              capacity=k * s)
    return pos.reshape(g, k, s).permute(0, 2, 1)


def _expert_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C', D) -> (E, C', D), per-expert gated MLP."""
    dt = x.dtype
    h = _act(cfg.act, torch.einsum("ecd,edf->ecf", x, p["w1"].to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", x, p["w3"].to(dt))
    return torch.einsum("ecf,efd->ecd", h, p["w2"].to(dt))


def _groups(cfg: ModelConfig, p: dict, x: torch.Tensor, group_len: int,
            ax: Axes):
    """Cut (B, S, D) into G groups of ``group_len`` tokens and route them:
    (xg, top_e, top_p, aux, pos, kept, cap)."""
    b, s, d = x.shape
    group_len = min(group_len, b * s)
    xg = x.reshape(b * s // group_len, group_len, d)
    top_e, top_p, aux = _router(cfg, p, xg, ax)
    pos = arbiter_positions(top_e, cfg.n_experts)            # (G, S, k)
    cap = capacity(cfg, group_len)
    return xg, top_e, top_p, aux, pos, pos < cap, cap


def _spans_ranks(x: torch.Tensor, ax: Axes, group_len: int) -> bool:
    """On a mesh, whether a group of the whole batch's tokens (``x`` is
    this data rank's rows) spans more than one data rank."""
    if ax.mesh is None:
        return False
    tokens = x.shape[0] * x.shape[1]
    return tokens % min(group_len, tokens * ax.batch_size()) != 0


def _whole_batch(fn, cfg: ModelConfig, p: dict, x: torch.Tensor, ax: Axes,
                 group_len: int):
    """``fn`` on the rows of every data rank, gathered over the batch axes
    (differentiable), and this rank's rows of its output; the aux is the
    whole batch's."""
    y, aux = fn(cfg, p, gather_shard(x, (ax.batch,), ax.mesh), NO_AXES,
                group_len)
    return local_shard(y, (ax.batch,), ax.mesh), aux


def moe_gshard(cfg: ModelConfig, p: dict, x: torch.Tensor,
               ax: Axes = NO_AXES, group_len: int = 1024):
    """Einsum (GShard) banked dispatch.  x: (B, S, D) -> (B, S, D), aux."""
    if _spans_ranks(x, ax, group_len):
        return _whole_batch(moe_gshard, cfg, p, x, ax, group_len)
    b, s, d = x.shape
    xg, top_e, top_p, aux, pos, kept, cap = _groups(cfg, p, x, group_len, ax)
    g, e = xg.shape[0], cfg.n_experts
    disp = _dispatch_mask(top_e, pos, kept, e, cap, x.dtype)
    expert_in = torch.einsum("gsec,gsd->gecd", disp, xg)
    expert_in = expert_in.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    eo = _expert_ffn(cfg, p, expert_in)
    eo = eo.reshape(e, g, cap, d).permute(1, 0, 2, 3)
    weights = _combine_weights(top_e, top_p, pos, kept, e, cap, x.dtype)
    out = torch.einsum("gsec,gecd->gsd", weights, eo)
    return out.reshape(b, s, d), aux


def _dispatch_mask(top_e, pos, kept, n_experts, cap, dtype):
    """(G, S, k) -> (G, S, E, C) 0/1 dispatch mask (drops masked requests)."""
    e_oh = _one_hot(top_e, n_experts, dtype)                  # (G,S,k,E)
    c_oh = _one_hot(torch.where(kept, pos, cap), cap, dtype)  # (G,S,k,C)
    return torch.einsum("gske,gskc->gsec", e_oh, c_oh)


def _combine_weights(top_e, top_p, pos, kept, n_experts, cap, dtype):
    e_oh = _one_hot(top_e, n_experts, dtype)
    c_oh = _one_hot(torch.where(kept, pos, cap), cap, dtype)
    w = top_p.to(dtype) * kept.to(dtype)
    return torch.einsum("gske,gskc,gsk->gsec", e_oh, c_oh, w)


def moe_scatter(cfg: ModelConfig, p: dict, x: torch.Tensor,
                ax: Axes = NO_AXES, group_len: int = 1024):
    """Index-based banked dispatch: tokens scattered straight into their
    (E, C) slots (no S×E×C einsum), the expert outputs gathered back."""
    if _spans_ranks(x, ax, group_len):
        return _whole_batch(moe_scatter, cfg, p, x, ax, group_len)
    b, s, d = x.shape
    xg, top_e, top_p, aux, pos, kept, cap = _groups(cfg, p, x, group_len, ax)
    g, e, k = xg.shape[0], cfg.n_experts, cfg.experts_per_token
    group_len = xg.shape[1]
    # flat slot ids per request; dropped requests land in a trash slot
    slot = torch.where(kept, top_e.long() * cap + pos, e * cap)
    slot2 = slot.reshape(g, group_len * k)
    rows = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, e * cap + 1, d))
    buf[rows, slot2] = torch.repeat_interleave(xg, k, dim=1)
    ein = buf[:, :-1].reshape(g, e, cap, d).permute(1, 0, 2, 3)
    eo = _expert_ffn(cfg, p, ein.reshape(e, g * cap, d))
    eo = eo.reshape(e, g, cap, d).permute(1, 0, 2, 3).reshape(g, e * cap, d)
    eo = torch.cat([eo, x.new_zeros((g, 1, d))], dim=1)
    got = eo[rows, slot2].reshape(g, group_len, k, d)
    w = (top_p * kept).to(x.dtype)
    out = torch.einsum("gskd,gsk->gsd", got, w)
    return out.reshape(b, s, d), aux


def moe(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor, *,
        ax: Axes = NO_AXES):
    """The MoE FFN the ``RunConfig`` names: ``scatter``, ``a2a`` where the
    mesh has expert-parallel axes for it, else ``gshard``."""
    if rc.moe_impl == "scatter":
        return moe_scatter(cfg, p, x, ax)
    if rc.moe_impl == "a2a":
        from repro_torch.models.moe_a2a import a2a_applicable, moe_a2a
        if a2a_applicable(cfg, ax, x.shape[1]):
            return moe_a2a(cfg, p, x, ax)
    return moe_gshard(cfg, p, x, ax)
