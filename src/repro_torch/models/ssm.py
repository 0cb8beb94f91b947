"""Mamba-1 selective SSM block (port of ``repro.models.ssm``; falcon-mamba
and jamba's SSM layers).

Prefill runs a chunked parallel scan: the sequence is cut into chunks;
inside a chunk the recurrence h_t = a_t * h_{t-1} + b_t is a log-depth
doubling scan with the reference's ``combine`` (materializing (B, chunk,
D_inner, N) in float32), and a loop carries the state across chunk
boundaries.  Decode is the O(1) recurrent update against a (B, D_inner,
N) state plus a rolling depthwise-conv window.

The reference's scan is jitted ``jnp`` (``associative_scan`` in a
``lax.scan``), not a Pallas kernel, so here it is plain torch.  The
reference's sharding constraint on the SSM input is a layout hint and is
dropped.  On a mesh (``ax``) the weights are whole and ``x`` is this
rank's rows; the decode state is this rank's block of them, ``dinner``
split over the model axis as the reference keeps it: prefill keeps its
block of the state, and a decode step gathers the (small) state over
``dinner``, computes as on one device and keeps its block of the new one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import (NO_AXES, Axes, gather_shard,
                                         own_block)
from repro_torch.models.params import Leaf, fan_in_scale


def ssm_specs(cfg: ModelConfig) -> dict:
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    return {
        "in_proj": Leaf((d, 2 * di), ("embed", "dinner"),
                        scale=fan_in_scale(d)),
        "conv_w": Leaf((k, di), ("conv", "dinner"), scale=fan_in_scale(k)),
        "conv_b": Leaf((di,), ("dinner",), init="zeros"),
        "x_proj": Leaf((di, r + 2 * n), ("dinner", None),
                       scale=fan_in_scale(di)),
        "dt_proj": Leaf((r, di), ("dt_rank", "dinner"),
                        scale=fan_in_scale(r)),
        "dt_bias": Leaf((di,), ("dinner",), init="zeros"),
        "A_log": Leaf((di, n), ("dinner", "state"), init="ones"),
        "D_skip": Leaf((di,), ("dinner",), init="ones"),
        "out_proj": Leaf((di, d), ("dinner", "embed"),
                         scale=fan_in_scale(di)),
    }


def state_specs(cfg: ModelConfig, batch: int) -> dict:
    """An SSM block's decode state of ``batch`` rows: {"h" (B, Di, N),
    "conv" (B, K-1, Di)}, logical-axes tagged."""
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": Leaf((batch, di, n), ("batch", "dinner", "state"),
                      init="zeros"),
            "conv": Leaf((batch, k - 1, di), ("batch", "conv", "dinner"),
                         init="zeros")}


def _state_placement(cfg: ModelConfig, ax: Axes, rows: int) -> dict:
    """{name: placement} of this rank's ``rows`` rows of the decode state:
    ``ax.resolve``'s, but for the batch entry (the rows are the rank's
    already)."""
    specs = state_specs(cfg, rows * ax.batch_size())
    return {name: (None,) + ax.resolve(leaf.axes, leaf.shape)[1:]
            for name, leaf in specs.items()}


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, Di) with kernel (K, Di)."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :s] * w[i]
    return out + b


def _ssm_inputs(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u: (..., S, Di) post-conv activations -> (delta, B, C, A)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    dt = u.dtype
    proj = torch.einsum("...sd,dk->...sk", u, p["x_proj"].to(dt))
    dt_raw, bmat, cmat = torch.split(proj, [r, n, n], dim=-1)
    delta = F.softplus(
        torch.einsum("...sr,rd->...sd", dt_raw, p["dt_proj"].to(dt))
        + p["dt_bias"].to(dt))                                  # (...,S,Di)
    a = -torch.exp(p["A_log"].float())                          # (Di, N)
    return delta, bmat, cmat, a


def _scan_chunk(carry_h: torch.Tensor, abar: torch.Tensor,
                bbar: torch.Tensor) -> tuple:
    """Inclusive scan of h_t = abar_t h_{t-1} + bbar_t inside one chunk.

    abar/bbar: (B, L, Di, N) float32; carry_h: (B, Di, N).  A doubling
    scan over axis 1 with the reference's ``combine`` ((a1, b1) then (a2,
    b2) is (a1·a2, a2·b1 + b2)): ceil(log2 L) rounds, each combining every
    position with the one ``step`` before it."""
    a_cum, b_cum = abar, bbar
    length, step = abar.shape[1], 1
    while step < length:
        a_lo, b_lo = a_cum[:, :-step], b_cum[:, :-step]
        a_hi, b_hi = a_cum[:, step:], b_cum[:, step:]
        a_cum = torch.cat([a_cum[:, :step], a_lo * a_hi], dim=1)
        b_cum = torch.cat([b_cum[:, :step], a_hi * b_lo + b_hi], dim=1)
        step *= 2
    h = a_cum * carry_h[:, None] + b_cum                        # (B,L,Di,N)
    # the carry is a copy: a view would keep the whole chunk's states alive
    # in the prefill cache
    return h[:, -1].clone(), h


def mamba_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  chunk: int = 256, *, ax: Axes = NO_AXES):
    """x: (B, S, D) -> (y (B, S, D), decode-ready state cache {"h" (B, Di,
    N) float32, "conv" (B, K-1, Di)}).  S must be a multiple of the chunk
    (``min(chunk, S)``).  On a mesh the cache is this rank's block."""
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    dt = x.dtype
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(dt))
    u_pre, z = xz.chunk(2, dim=-1)
    u = F.silu(_conv_causal(u_pre, p["conv_w"].to(dt), p["conv_b"].to(dt)))
    delta, bmat, cmat, a = _ssm_inputs(cfg, p, u)

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the scan "
                         f"chunk {chunk}")
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s, chunk):
        c = slice(lo, lo + chunk)
        delta_c = delta[:, c].float()
        abar = torch.exp(delta_c[..., None] * a)
        bbar = (delta_c * u[:, c].float())[..., None] \
            * bmat[:, c].float()[..., None, :]
        h, hs = _scan_chunk(h, abar, bbar)
        ys.append(torch.einsum("blin,bln->bli", hs,
                               cmat[:, c].float()).to(dt))
    y = torch.cat(ys, dim=1)
    y = y + u * p["D_skip"].to(dt)
    y = y * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(dt))
    # a copy, so the cache does not hold the whole projection alive
    cache = {"h": h, "conv": u_pre[:, -(cfg.ssm_conv - 1):].contiguous()}
    if ax.mesh is not None:
        place = _state_placement(cfg, ax, b)
        cache = {name: own_block(t, place[name], ax.mesh)
                 for name, t in cache.items()}
    return out, cache


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, *,
                 ax: Axes = NO_AXES):
    """One-token recurrent step.  x: (B, 1, D); cache: {h, conv}, on a
    mesh this rank's block of them (returned so too)."""
    place = None
    if ax.mesh is not None:
        place = _state_placement(cfg, ax, x.shape[0])
        cache = {name: gather_shard(t, place[name], ax.mesh)
                 for name, t in cache.items()}
    dt = x.dtype
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(dt))
    u_new, z = xz.chunk(2, dim=-1)                           # (B,1,Di)
    window = torch.cat([cache["conv"].to(dt), u_new], dim=1)
    u = torch.einsum("bki,ki->bi", window, p["conv_w"].to(dt)) \
        + p["conv_b"].to(dt)
    u = F.silu(u)[:, None]                                   # (B,1,Di)
    delta, bmat, cmat, a = _ssm_inputs(cfg, p, u)
    abar = torch.exp(delta.float()[..., None] * a)[:, 0]     # (B,Di,N)
    bbar = ((delta * u).float()[..., None]
            * bmat.float()[..., None, :])[:, 0]
    h = abar * cache["h"] + bbar
    y = torch.einsum("bin,bn->bi", h, cmat[:, 0].float())
    y = y.to(dt)[:, None] + u * p["D_skip"].to(dt)
    y = y * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(dt))
    new = {"h": h, "conv": window[:, 1:]}
    if place is not None:
        new = {name: own_block(t, place[name], ax.mesh)
               for name, t in new.items()}
    return out, new
