"""Expert-parallel MoE through an all-to-all (port of
``repro.models.moe_a2a``), with explicit collectives on the mesh's
groups where the reference has a ``shard_map``.

Layout (requires E % tp == 0 or tp % E == 0, and S % tp == 0):

  * the caller holds its data rank's rows (B_loc, S, D), the same on every
    model rank, and the MoE weights whole (``make_train_step`` gathers
    them before the forward); each (data=i, model=j) rank takes the j-th
    sequence tile of its rows and, of the expert weights, its E/tp
    experts (the one expert it co-owns when E < tp).  The reference's
    ``shard_map`` takes FSDP blocks over 'data' and gathers them back
    inside; whole weights need neither;
  * each rank routes its T_loc tokens with the arbiter math
    (``grant_positions``) into an (E, C, D) send buffer — banks = experts,
    the paper's controller; ``frac`` and ``mean_p`` of the aux loss are
    averaged over every rank;
  * an all-to-all over 'model' exchanges expert slices: every rank ends
    with (E_loc, tp·C, D), the tokens of ALL model ranks for ITS E/tp
    experts;
  * the local expert FFN, the reverse all-to-all, the weighted combine,
    and the sequence tiles all-gathered over 'model' back into the
    caller's rows.

Every collective is an autograd function whose backward is its exact
adjoint (``repro_torch.launch.sharding``), because training reaches this
layer.  Equivalence with ``moe_gshard`` is held on 4 gloo ranks in
tests/test_torch_moe_a2a.py.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.arbiter import grant_positions
from repro_torch.launch.mesh import axis_names, chips
from repro_torch.launch.sharding import (Axes, all_gather, all_reduce_sum,
                                         all_to_all, local_shard)
from repro_torch.models.layers import _act
from repro_torch.models.moe import capacity


def a2a_applicable(cfg: ModelConfig, ax: Axes, seq_len: int) -> bool:
    tp = ax.size(ax.tp)
    if ax.mesh is None or tp <= 1 or seq_len % tp != 0:
        return False
    # E ≥ tp: E/tp experts per device; E < tp: tp/E devices co-own one
    # expert via capacity-split virtual experts.
    return cfg.n_experts % tp == 0 or tp % cfg.n_experts == 0


def moe_a2a(cfg: ModelConfig, p: dict, x: torch.Tensor, ax: Axes):
    """x: this data rank's rows (B_loc, S, D) -> ((B_loc, S, D), aux), the
    output the same on every model rank and ``aux`` on every rank.
    ``p`` holds the MoE weights whole.  Callers guard ``a2a_applicable``
    (a mesh of any tp runs, tp = 1 included).

    E ≥ tp: classic EP (E/tp experts per rank).  E < tp: each expert is
    co-owned by r = tp/E ranks as r *virtual experts* that split its
    capacity (request pos c goes to virtual copy c % r at slot c // r) —
    the arbiter math untouched, each rank computing with its one
    expert's weights."""
    mesh, tp_axis = ax.mesh, ax.tp
    tp = ax.size(tp_axis)
    e, k = cfg.n_experts, cfg.experts_per_token
    r = max(1, tp // e)                      # ranks per expert
    split_experts = r > 1
    b, s, d = x.shape
    if s % tp:
        raise ValueError(f"moe_a2a: seq {s} must divide by tp={tp}")

    # ---- this rank's sequence tile ----
    x_loc = local_shard(x, (None, tp_axis, None), mesh)

    bl, sl, _ = x_loc.shape
    t = bl * sl
    cap = capacity(cfg, t)
    cap = -(-cap // r) * r                   # divisible by the split
    cap_v = cap // r
    dt = x.dtype
    xt = x_loc.reshape(t, d)

    # ---- routing ----
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: among equal probabilities the lower
    # expert id first, as jax.lax.top_k orders them
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss with statistics averaged over ALL ranks (frac,
    # mean_p averaged over every token before the product — as gshard)
    everyone = axis_names(mesh)
    n_ranks = chips(mesh)
    onehot = (top_e[:, 0, None] == torch.arange(e, device=x.device))
    frac = all_reduce_sum(onehot.float().mean(dim=0), mesh,
                          everyone) / n_ranks
    mean_p = all_reduce_sum(probs.mean(dim=0), mesh, everyone) / n_ranks
    aux = e * torch.sum(frac * mean_p)

    # ---- arbiter dispatch into the (E·r, C/r, D) send buffer ----
    req_e = top_e.t().reshape(k * t)                     # priority order
    pos = grant_positions(req_e, e).long()
    kept = pos < cap
    vexp = req_e * r + pos % r           # virtual expert (r=1: = req_e)
    vpos = pos // r
    n_v = e * r                          # == tp when split
    slot = torch.where(kept, vexp * cap_v + vpos, n_v * cap_v)
    xrep = xt.repeat(k, 1)                               # (k·t, D)
    buf = x.new_zeros((n_v * cap_v + 1, d)).index_copy(0, slot, xrep)
    buf = buf[:-1].reshape(n_v, cap_v, d)

    # ---- exchange: (V, Cv, D) -> (V/tp, tp·Cv, D) ----
    recv = all_to_all(buf, mesh, tp_axis)     # block q: rank q's tokens
    recv = recv.reshape(tp, n_v // tp, cap_v, d).transpose(0, 1)
    recv = recv.reshape(n_v // tp, tp * cap_v, d)

    # ---- local expert FFN ----
    if split_experts:
        # rank j serves expert j // r
        own = mesh.get_local_rank(tp_axis) // r
        w1f, w2f, w3f = (p[n][own].to(dt) for n in ("w1", "w2", "w3"))
        xin = recv.reshape(tp * cap_v, d)       # (tp·Cv, D) one vexpert
        h = _act(cfg.act, xin @ w1f) * (xin @ w3f)
        out = (h @ w2f).reshape(1, tp * cap_v, d)
    else:
        # rank j serves experts [j·E/tp, (j+1)·E/tp)
        w1f, w2f, w3f = (local_shard(p[n], (tp_axis,), mesh).to(dt)
                         for n in ("w1", "w2", "w3"))
        h = _act(cfg.act, torch.einsum("ecd,edf->ecf", recv, w1f))
        h = h * torch.einsum("ecd,edf->ecf", recv, w3f)
        out = torch.einsum("ecf,efd->ecd", h, w2f)

    # ---- reverse exchange + combine ----
    out = out.reshape(n_v // tp, tp, cap_v, d).transpose(0, 1)
    back = all_to_all(out.contiguous(), mesh, tp_axis)
    flat = torch.cat([back.reshape(n_v * cap_v, d), x.new_zeros((1, d))])
    got = flat[slot].reshape(k, t, d)
    w = (top_p * kept.reshape(k, t).t()).to(dt)              # (t, k)
    y = torch.einsum("ktd,tk->td", got, w).reshape(bl, sl, d)
    # ---- the reference's out_spec: the sequence tiles over 'model' ----
    return all_gather(y, mesh, tp_axis, 1), aux
