"""Transformer building blocks (port of ``repro.models.layers``): RMSNorm,
RoPE, GQA attention (dense, blocked flash and single-token decode; sliding
window and softcap variants) and the gated MLP.

The einsums, mask value (``NEG_INF``) and casts are the reference's: the
softmax runs in float32, everything else in the activations' dtype (the
``RunConfig`` compute dtype).  Queries are (B, S, KV, G, HD) with
G = H / KV, so attention contracts against (B, T, KV, HD) without
repeating KV heads.  Attention here is plain torch, as in the reference
(where XLA, not a Pallas kernel, computes it).

``ax`` is the mesh context, as in the reference.  The weights a layer is
given are whole and its activations are this rank's rows, so only
``attention_decode`` does anything with it: on a mesh its KV cache is
this rank's block, the positions split over the mesh axes that the batch
leaves free (``seq_axes``), and the ranks combine their partial softmaxes
by two all-reduces of float32 statistics; no cache byte moves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.sharding import (NO_AXES, Axes, all_reduce_,
                                         all_reduce_max_, own_block,
                                         shard_index)
from repro_torch.models.params import Leaf, fan_in_scale

NEG_INF = -2.0 ** 30
#: an attention block's decode cache {"k", "v"}: its logical axes
KV_AXES = ("batch", "seq", "kv_heads", "head_dim")


def rmsnorm_spec(d: int) -> Leaf:
    return Leaf((d,), ("embed",), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, ..., HD); positions: (S,) or (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs       # (..., S, HD/2)
    angles = angles[..., :, None, :]                    # (..., S, 1, HD/2)
    while angles.dim() < x.dim():
        angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = fan_in_scale(d)
    p = {
        "wq": Leaf((d, h, hd), ("embed", "heads", "head_dim"), scale=s),
        "wk": Leaf((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=s),
        "wv": Leaf((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=s),
        "wo": Leaf((h, hd, d), ("heads", "head_dim", "embed"),
                   scale=fan_in_scale(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = Leaf((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = Leaf((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    b, s = x.shape[:2]
    return q.reshape(b, s, kv, h // kv, hd), k, v


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int):
    """(Sq, Sk) boolean mask: causal + optional sliding window."""
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def attention_dense(cfg: ModelConfig, q, k, v, qpos, kpos, window: int):
    """Materialized-scores GQA attention."""
    s = torch.einsum("bskgh,btkh->bkgst", q, k) / math.sqrt(cfg.hd)
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(_mask(qpos, kpos, window), s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", p, v)


def attention_flash(cfg: ModelConfig, q, k, v, qpos, kpos, window: int,
                    block_q: int, block_k: int):
    """Online-softmax blocked attention, causal (the reference's loop over
    blocks, unrolled in Python): a key block wholly in a query block's
    future, or wholly out of its window, is skipped."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * block_q:(qi + 1) * block_q]
        qp = qpos[qi * block_q:(qi + 1) * block_q]
        bq = q_blk.shape[1]
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, kvh, g, bq, hd), dtype=torch.float32,
                          device=q.device)
        q_lo, q_hi = qi * block_q, (qi + 1) * block_q - 1
        for kj in range(nk):
            k_lo, k_hi = kj * block_k, (kj + 1) * block_k - 1
            if k_lo > q_hi:                       # strictly future block
                continue
            if window and k_hi < q_lo - window + 1:
                continue                          # fully out of window
            k_blk = k[:, k_lo:k_lo + block_k]
            v_blk = v[:, k_lo:k_lo + block_k]
            kp = kpos[k_lo:k_lo + block_k]
            s = torch.einsum("bqkgh,btkh->bkgqt", q_blk, k_blk) * scale
            s = softcap(s, cfg.attn_softcap).float()
            s = torch.where(_mask(qp, kp, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * corr + pexp.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", pexp, v_blk.float())
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(torch.einsum("bkgqh->bqkgh", o).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor, *,
              window: int = 0, positions=None, return_kv: bool = False,
              ax: Axes = NO_AXES):
    """Full-sequence (train / prefill) attention; returns (B, S, D) and,
    with ``return_kv``, the roped K/V for the prefill cache.  ``attn_impl``
    "flash", or "auto" on a sequence longer than 2 x ``flash_block``, takes
    ``attention_flash``; otherwise the dense scores.  On a mesh (``ax``)
    ``x`` is this rank's rows, each whole, so nothing changes."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    impl = rc.attn_impl
    if impl == "auto":
        impl = "flash" if s > 2 * rc.flash_block else "dense"
    if impl == "flash":
        o = attention_flash(cfg, q, k, v, positions, positions, window,
                            rc.flash_block, rc.flash_block)
    else:
        o = attention_dense(cfg, q, k, v, positions, positions, window)
    o = o.reshape(b, s, cfg.n_heads, cfg.hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


def seq_axes(ax: Axes, length: int | None = None) -> tuple:
    """The mesh axes that a KV cache's positions split over on ``ax``'s
    mesh, major first: "data" and "model" where the batch leaves them
    free, as ``Axes.resolve`` places ``KV_AXES`` (``()`` off a mesh).
    With ``length``, only those that ``resolve`` splits a cache of
    ``length`` positions over: each in turn where it divides them."""
    if ax.mesh is None:
        return ()
    out, n = [], 1
    for a in ("data", "model"):
        if a in ax.batch or ax.size(a) <= 1:
            continue
        if length is None or length % (n * ax.size(a)) == 0:
            out.append(a)
            n *= ax.size(a)
    return tuple(out)


def cache_block(kv: torch.Tensor, ax: Axes) -> torch.Tensor:
    """This rank's block of a prefill's K or V cache (B, T, KV, HD) of its
    rows: its slice of the positions over ``seq_axes(ax, T)`` (the whole
    off a mesh, or where no free axis divides T)."""
    seq = seq_axes(ax, kv.shape[1])
    if not seq:
        return kv
    return own_block(kv, (None, seq), ax.mesh)


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor, *, window: int = 0,
                     ax: Axes = NO_AXES):
    """Single-token decode against a (ring-)buffered KV cache.

    x: (B, 1, D); cache {"k","v"}: (B, T, KV, HD), T = seq_len (full cache)
    or the window (SWA ring buffer); pos: () current position.
    Returns (out (B, 1, D), new cache).

    On a mesh ``cache`` is this rank's block, its slice of the whole
    cache's positions over ``seq_axes(ax)`` (every free axis: a decode
    buffer that they divide, as ``launch.inputs.decode_specs`` places
    it).  The new K/V goes in by the
    reference's one-hot masked write, which lands only on the rank whose
    slice holds the slot; each rank's partial softmax (its maximum, sum of
    exponentials and weighted V, in float32) is combined over the
    ``seq_axes`` by a max and a sum all-reduce."""
    b = x.shape[0]
    hd = cfg.hd
    t = cache["k"].shape[1]
    seq = seq_axes(ax)
    block, n = shard_index(seq, ax.mesh) if seq else (0, 1)
    total = t * n                             # the whole cache's positions
    q, k_new, v_new = _qkv(cfg, p, x, pos[None])
    slot = pos % total if window else pos
    idx = torch.arange(block * t, (block + 1) * t, device=x.device)
    hot = (idx == slot)[None, :, None, None]
    ck = torch.where(hot, k_new.to(cache["k"].dtype), cache["k"])
    cv = torch.where(hot, v_new.to(cache["v"].dtype), cache["v"])
    if window:
        age = (slot - idx) % total
        valid = age <= torch.clamp(pos, max=total - 1)
    else:
        valid = idx <= pos
    s = torch.einsum("bqkgh,btkh->bkgqt", q, ck.to(q.dtype)) / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    if n == 1:
        pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bkgqt,btkh->bqkgh", pr, cv.to(q.dtype))
    else:
        o = _combined_softmax(s, cv, seq, ax.mesh).to(q.dtype)
    o = o.reshape(b, 1, cfg.n_heads, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, {"k": ck, "v": cv}


def _combined_softmax(s: torch.Tensor, cv: torch.Tensor, seq: tuple,
                      mesh) -> torch.Tensor:
    """softmax(s) · V over the whole cache from each rank's block of the
    scores ``s`` (B, KV, G, 1, T) and of V, in float32 -> (B, 1, KV, G,
    HD): the ranks' maxima reduced to the global one, then each rank's
    exponentials taken against it (the rescale) and its weighted V and
    sum of exponentials summed over the ranks in one all-reduce.  A rank
    with no valid position adds exp(NEG_INF - max) = 0."""
    s = s.float()
    m = s.amax(dim=-1, keepdim=True)                    # (B, KV, G, 1, 1)
    all_reduce_max_(m, mesh, (seq,))
    e = torch.exp(s - m)
    acc = torch.cat([torch.einsum("bkgqt,btkh->bkgqh", e, cv.float()),
                     e.sum(dim=-1, keepdim=True)], dim=-1)
    all_reduce_(acc, mesh, seq)
    return (acc[..., :-1] / acc[..., -1:]).permute(0, 3, 1, 2, 4)


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": Leaf((d, f), ("embed", "ffn"), scale=fan_in_scale(d)),
        "w3": Leaf((d, f), ("embed", "ffn"), scale=fan_in_scale(d)),
        "w2": Leaf((f, d), ("ffn", "embed"), scale=fan_in_scale(f)),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
        ax: Axes = NO_AXES) -> torch.Tensor:
    """The gated MLP; on a mesh (``ax``) ``x`` is this rank's rows and
    nothing changes."""
    dt = x.dtype
    h = _act(cfg.act, torch.einsum("bsd,df->bsf", x, p["w1"].to(dt)))
    h = h * torch.einsum("bsd,df->bsf", x, p["w3"].to(dt))
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(dt))
