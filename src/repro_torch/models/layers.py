"""Transformer building blocks (port of ``repro.models.layers``): RMSNorm,
RoPE, GQA attention (dense prefill and single-token decode, sliding window
and softcap variants) and the gated MLP.

The einsums, mask value (``NEG_INF``) and casts are the reference's: the
softmax runs in float32, everything else in the activations' dtype (the
``RunConfig`` compute dtype).  Queries are (B, S, KV, G, HD) with
G = H / KV, so attention contracts against (B, T, KV, HD) without
repeating KV heads.  Attention here is plain torch, as in the reference
(where XLA, not a Pallas kernel, computes it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.params import Leaf, fan_in_scale

NEG_INF = -2.0 ** 30


def rmsnorm_spec(d: int) -> Leaf:
    return Leaf((d,), init="ones")


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
        "wq": Leaf((d, h, hd), scale=s),
        "wk": Leaf((d, kv, hd), scale=s),
        "wv": Leaf((d, kv, hd), scale=s),
        "wo": Leaf((h, hd, d), scale=fan_in_scale(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((h, hd), init="zeros")
        p["bk"] = Leaf((kv, hd), init="zeros")
        p["bv"] = Leaf((kv, hd), init="zeros")
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


def attention(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor, *,
              window: int = 0, positions=None, return_kv: bool = False):
    """Full-sequence (prefill) attention; returns (B, S, D) and, with
    ``return_kv``, the roped K/V for the prefill cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    impl = rc.attn_impl
    if impl == "auto":
        impl = "flash" if s > 2 * rc.flash_block else "dense"
    if impl != "dense":
        raise NotImplementedError(
            f"attention impl {impl!r} (sequence {s}): the port has the "
            f"dense path; blocked flash attention comes with a later slice")
    q, k, v = _qkv(cfg, p, x, positions)
    o = attention_dense(cfg, q, k, v, positions, positions, window)
    o = o.reshape(b, s, cfg.n_heads, cfg.hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor, *, window: int = 0):
    """Single-token decode against a (ring-)buffered KV cache.

    x: (B, 1, D); cache {"k","v"}: (B, T, KV, HD), T = seq_len (full cache)
    or the window (SWA ring buffer); pos: () current position.
    Returns (out (B, 1, D), new cache)."""
    b = x.shape[0]
    hd = cfg.hd
    t = cache["k"].shape[1]
    q, k_new, v_new = _qkv(cfg, p, x, pos[None])
    slot = pos % t if window else pos
    idx = torch.arange(t, device=x.device)
    hot = (idx == slot)[None, :, None, None]
    ck = torch.where(hot, k_new.to(cache["k"].dtype), cache["k"])
    cv = torch.where(hot, v_new.to(cache["v"].dtype), cache["v"])
    if window:
        age = (slot - idx) % t
        valid = age <= torch.clamp(pos, max=t - 1)
    else:
        valid = idx <= pos
    s = torch.einsum("bqkgh,btkh->bkgqt", q, ck.to(q.dtype)) / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bkgqt,btkh->bqkgh", pr, cv.to(q.dtype))
    o = o.reshape(b, 1, cfg.n_heads, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, {"k": ck, "v": cv}


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": Leaf((d, f), scale=fan_in_scale(d)),
        "w3": Leaf((d, f), scale=fan_in_scale(d)),
        "w2": Leaf((f, d), scale=fan_in_scale(f)),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = _act(cfg.act, torch.einsum("bsd,df->bsf", x, p["w1"].to(dt)))
    h = h * torch.einsum("bsd,df->bsf", x, p["w3"].to(dt))
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(dt))
