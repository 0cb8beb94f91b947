"""Model assembly for the dense family (port of ``repro.models.transformer``):
parameter specs, prefill, single-token decode and the block-level decode
with its ``attn_fn`` hook (where the serving engine plugs in the banked
paged-KV attention).

The layer stack is ``n_superblocks`` repetitions of the config's
``block_pattern()``, with parameters stacked over superblocks as in the
reference; the reference scans them, the port loops.  MoE and SSM blocks
and modality frontends raise ``NotImplementedError`` in ``model_specs``,
before any weight is made: their model code is ROADMAP item 21.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.params import Leaf, fan_in_scale, stack_specs

_LATER = ("{what} blocks are not ported yet: their model code is ROADMAP "
          "item 21 (the MoE, SSM, hybrid, audio and vision families)")


def _no_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not ported yet: their "
            f"model code is ROADMAP item 21")


def _dense_only(kind: str, is_moe: bool) -> None:
    if kind != "attn":
        raise NotImplementedError(_LATER.format(what=f"{kind!r} mixer"))
    if is_moe:
        raise NotImplementedError(_LATER.format(what="MoE FFN"))


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    _dense_only(kind, is_moe)
    p = {"ln1": L.rmsnorm_spec(cfg.d_model),
         "ln2": L.rmsnorm_spec(cfg.d_model),
         "mixer": L.attn_specs(cfg),
         "ffn": L.mlp_specs(cfg)}
    if cfg.post_block_norms:
        p["ln1_post"] = L.rmsnorm_spec(cfg.d_model)
        p["ln2_post"] = L.rmsnorm_spec(cfg.d_model)
    return p


def model_specs(cfg: ModelConfig) -> dict:
    _no_frontend(cfg)
    vp, d = cfg.padded_vocab(), cfg.d_model
    specs = {
        "embed": Leaf((vp, d), scale=1.0),
        "final_norm": L.rmsnorm_spec(d),
        "blocks": {},
    }
    for j, (kind, is_moe) in enumerate(cfg.block_pattern()):
        specs["blocks"][f"b{j}"] = stack_specs(
            block_specs(cfg, kind, is_moe), cfg.n_superblocks)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Leaf((d, vp), scale=fan_in_scale(d))
    return specs


def _block_window(cfg: ModelConfig, j: int) -> int:
    if cfg.local_global:
        return cfg.local_window if j % 2 == 0 else 0
    return cfg.sliding_window


def superblock_params(params: dict, j: int, sb: int) -> dict:
    """Pattern block ``j``'s parameters in superblock ``sb`` (a view)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[sb]
    return pick(params["blocks"][f"b{j}"])


def apply_block_decode(cfg: ModelConfig, rc: RunConfig, p: dict,
                       x: torch.Tensor, cache: dict, pos: torch.Tensor,
                       kind: str, is_moe: bool, j: int, attn_fn=None):
    """One block's decode step.  ``attn_fn`` swaps the attention-cache
    implementation (same signature as ``L.attention_decode``)."""
    _dense_only(kind, is_moe)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, new_cache = (attn_fn or L.attention_decode)(
        cfg, p["mixer"], h, cache, pos, window=_block_window(cfg, j))
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
    x = x + h
    h = L.mlp(cfg, p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
    return x + h, new_cache


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           dtype) -> torch.Tensor:
    _no_frontend(cfg)
    # rows of the cast table == cast rows of the table: gather first, so
    # the whole embedding is never cast per call
    x = params["embed"][tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["lm_head"].to(x.dtype))
    logits = L.softcap(logits, cfg.final_softcap)
    vp = cfg.padded_vocab()
    if vp != cfg.vocab_size:  # mask padded vocab rows
        keep = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(keep, logits, L.NEG_INF)
    return logits


def prefill(cfg: ModelConfig, rc: RunConfig, params: dict,
            tokens: torch.Tensor):
    """Inference prefill: returns (last-position logits (B, 1, Vp), decode
    cache ``{"blocks": {"b{j}": {"k", "v"}}}`` with (n_superblocks, B, t,
    KV, HD) K/V, t = S or the window)."""
    dtype = getattr(torch, rc.compute_dtype)
    x = _embed(cfg, params, tokens, dtype)
    pattern = cfg.block_pattern()
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    caches = {f"b{j}": {"k": [], "v": []} for j in range(len(pattern))}
    for sb in range(cfg.n_superblocks):
        for j, (kind, is_moe) in enumerate(pattern):
            _dense_only(kind, is_moe)
            p = superblock_params(params, j, sb)
            w = _block_window(cfg, j)
            t = min(s, w) if w else s
            if s % t:
                raise ValueError("ring cache needs seq % window == 0")
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            h, (k, v) = L.attention(cfg, rc, p["mixer"], h, window=w,
                                    positions=positions, return_kv=True)
            caches[f"b{j}"]["k"].append(k[:, -t:])
            caches[f"b{j}"]["v"].append(v[:, -t:])
            if cfg.post_block_norms:
                h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
            x = x + h
            h = L.mlp(cfg, p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
            if cfg.post_block_norms:
                h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
            x = x + h
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(cfg, params, x[:, -1:])
    blocks = {key: {h: torch.stack(c[h]) for h in ("k", "v")}
              for key, c in caches.items()}
    return logits, {"blocks": blocks}


def decode_step(cfg: ModelConfig, rc: RunConfig, params: dict,
                token: torch.Tensor, cache: dict, pos: torch.Tensor):
    """One decode step.  token: (B, 1) int64; pos: () current position.
    Returns (logits (B, 1, Vp), new cache)."""
    dtype = getattr(torch, rc.compute_dtype)
    x = _embed(cfg, params, token, dtype)
    pattern = cfg.block_pattern()
    new = {f"b{j}": {"k": [], "v": []} for j in range(len(pattern))}
    for sb in range(cfg.n_superblocks):
        for j, (kind, is_moe) in enumerate(pattern):
            c = {h: cache["blocks"][f"b{j}"][h][sb] for h in ("k", "v")}
            x, nc = apply_block_decode(cfg, rc,
                                       superblock_params(params, j, sb), x,
                                       c, pos, kind, is_moe, j)
            for h in ("k", "v"):
                new[f"b{j}"][h].append(nc[h])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    blocks = {key: {h: torch.stack(c[h]) for h in ("k", "v")}
              for key, c in new.items()}
    return _unembed(cfg, params, x), {"blocks": blocks}
