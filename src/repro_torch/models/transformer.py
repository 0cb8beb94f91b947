"""Model assembly (port of ``repro.models.transformer``): parameter specs
for every block kind (attention or Mamba mixer, dense or MoE FFN); the
training forward (``apply_block``, ``hidden_states``, ``forward``) with its
remat policies and the loss (``loss_fn``, both cross-entropy forms, the
MoE aux term); prefill, single-token decode and the block-level decode
with its ``attn_fn`` hook (where the serving engine plugs in the banked
paged-KV attention), for the dense, MoE, SSM, hybrid, audio and vision
families.

The layer stack is ``n_superblocks`` repetitions of the config's
``block_pattern()``, with parameters stacked over superblocks as in the
reference; the reference scans them, the port loops.  The training forward
unbinds each stacked leaf once, so its gradient is one ``stack`` a leaf.
A modality frontend (audio frames, vision patches) is an input, not a
parameter: its (B, F, D) embeddings come before the token embeddings in
the training forward and the prefill, and the loss scores the text region
only.

Inference on a mesh (``prefill`` / ``decode_step`` with ``ax``): each rank
holds its shards of the parameters, placed by ``ax.resolve``, and its rows
of the batch (split over ``ax.batch``; ``Axes.for_batch`` narrows it for
a batch that does not divide the data axis).  Each leaf outside the
stack is gathered whole when first used, each block's weights just
before the block (``gather_superblock``) and dropped after it.  The
decode cache stays where the reference keeps it: each rank holds its rows
of it, an attention block's positions split over the axes the batch
leaves free (``layers.cache_block``), an SSM block's state over
``dinner``.  Model ranks compute the same rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.sharding import (NO_AXES, Axes, gather_shard,
                                         gather_superblock)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.params import (Leaf, fan_in_scale, spec_tree,
                                       stack_specs)

AUX_LOSS_COEF = 0.01

def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    p = {"ln1": L.rmsnorm_spec(cfg.d_model),
         "ln2": L.rmsnorm_spec(cfg.d_model),
         "mixer": L.attn_specs(cfg) if kind == "attn" else S.ssm_specs(cfg),
         "ffn": M.moe_specs(cfg) if is_moe else L.mlp_specs(cfg)}
    if cfg.post_block_norms:
        p["ln1_post"] = L.rmsnorm_spec(cfg.d_model)
        p["ln2_post"] = L.rmsnorm_spec(cfg.d_model)
    return p


def model_specs(cfg: ModelConfig) -> dict:
    vp, d = cfg.padded_vocab(), cfg.d_model
    specs = {
        "embed": Leaf((vp, d), ("vocab", "embed"), scale=1.0),
        "final_norm": L.rmsnorm_spec(d),
        "blocks": {},
    }
    for j, (kind, is_moe) in enumerate(cfg.block_pattern()):
        specs["blocks"][f"b{j}"] = stack_specs(
            block_specs(cfg, kind, is_moe), cfg.n_superblocks)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Leaf((d, vp), ("embed", "vocab"),
                                scale=fan_in_scale(d))
    return specs


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                stacked: bool = True) -> dict:
    """Decode-state spec tree (KV / SSM caches), logical-axes tagged, in
    ``prefill``'s layout: an attention block's {"k", "v"} over the
    sequence or its window, an SSM block's {"h", "conv"}.  stacked=False
    gives one superblock's slice (the dry run's block module)."""
    blocks = {}
    for j, (kind, _) in enumerate(cfg.block_pattern()):
        if kind == "attn":
            t = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
                else seq_len
            if cfg.local_global and j % 2 == 0:
                t = min(seq_len, cfg.local_window)
            kv = Leaf((batch, t, cfg.n_kv_heads, cfg.hd), L.KV_AXES,
                      init="zeros")
            leaf = {"k": kv, "v": kv}
        else:
            leaf = S.state_specs(cfg, batch)
        if stacked:
            leaf = stack_specs(leaf, cfg.n_superblocks)
        blocks[f"b{j}"] = leaf
    return {"blocks": blocks}


def superblock_param_specs(cfg: ModelConfig) -> tuple:
    """One (unstacked) superblock's parameter specs, a tuple over the
    config's ``block_pattern()``."""
    return tuple(block_specs(cfg, kind, is_moe)
                 for kind, is_moe in cfg.block_pattern())


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


def apply_block(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor,
                kind: str, is_moe: bool, j: int, positions=None, *,
                ax: Axes = NO_AXES):
    """Pre-norm residual block; returns (x, aux_loss).  An SSM mixer's
    state cache is dropped; a MoE FFN's load-balance loss is the aux.
    ``ax`` is the mesh the MoE FFN routes on (``NO_AXES``: one device)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        h = L.attention(cfg, rc, p["mixer"], h,
                        window=_block_window(cfg, j), positions=positions)
    else:
        h, _ = S.mamba_prefill(cfg, p["mixer"], h)
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
    x = x + h
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if is_moe:
        h, aux = M.moe(cfg, rc, p["ffn"], h, ax=ax)
    else:
        h = L.mlp(cfg, p["ffn"], h)
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
    return x + h, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matmuls
    with no batch dimension (the weight einsums, which torch runs as a
    ``bmm`` of batch 1) and recompute everything else."""
    if op in _MATMULS or (op == torch.ops.aten.bmm.default
                          and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(rc: RunConfig, fn):
    """``fn`` under the ``RunConfig``'s remat policy: "none" as is,
    "full" recomputed in the backward, "dots" recomputed but for the
    weight matmuls' outputs."""
    if rc.remat == "none":
        return fn
    if rc.remat == "dots":
        def contexts():
            return create_selective_checkpoint_contexts(_save_weight_matmuls)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=contexts)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _unbind_superblocks(tree, n: int) -> list:
    """A stacked tree as ``n`` per-superblock trees: one ``unbind`` a
    leaf, so the backward writes each stacked gradient once."""
    if isinstance(tree, dict):
        parts = {k: _unbind_superblocks(v, n) for k, v in tree.items()}
        return [{k: parts[k][sb] for k in tree} for sb in range(n)]
    return list(tree.unbind(0))


def hidden_states(cfg: ModelConfig, rc: RunConfig, params: dict,
                  tokens: torch.Tensor, frontend=None, *,
                  ax: Axes = NO_AXES):
    """Shared trunk: final-norm'd hidden states (B, S, D) + MoE aux (the
    sum over every block of every superblock).  S counts the frontend's
    positions, which come first."""
    dtype = getattr(torch, rc.compute_dtype)
    x = _embed(cfg, params, tokens, frontend, dtype)
    pattern = cfg.block_pattern()
    positions = torch.arange(x.shape[1], device=x.device)

    def superblock(x, *block_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (kind, is_moe) in enumerate(pattern):
            x, a = apply_block(cfg, rc, block_params[j], x, kind, is_moe, j,
                               positions, ax=ax)
            aux = aux + a
        return x, aux

    sb_fn = _remat(rc, superblock)
    per_sb = [_unbind_superblocks(params["blocks"][f"b{j}"],
                                  cfg.n_superblocks)
              for j in range(len(pattern))]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb in range(cfg.n_superblocks):
        x, a = sb_fn(x, *(blocks[sb] for blocks in per_sb))
        aux = aux + a
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(cfg: ModelConfig, rc: RunConfig, params: dict,
            tokens: torch.Tensor, frontend=None, *, ax: Axes = NO_AXES):
    """Training/scoring forward pass -> (logits (B, S, Vp), aux_loss)."""
    x, aux = hidden_states(cfg, rc, params, tokens, frontend, ax=ax)
    return _unembed(cfg, params, x), aux


def _sharded_ce(cfg: ModelConfig, params: dict, h: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """The reference's vocab-parallel cross-entropy, on one device: the
    log-sum-exp over the logits, the target logit from a row gather of the
    unembedding (never from indexing the full logits)."""
    if cfg.tie_embeddings:
        w = params["embed"]                      # (Vp, D)
        logits = torch.einsum("btd,vd->btv", h, w.to(h.dtype))
        tvec = w[target].to(h.dtype)             # (B, T, D)
    else:
        w = params["lm_head"]                    # (D, Vp)
        logits = torch.einsum("btd,dv->btv", h, w.to(h.dtype))
        tvec = w.t()[target].to(h.dtype)
    logits = L.softcap(logits, cfg.final_softcap).float()
    vp = cfg.padded_vocab()
    if vp != cfg.vocab_size:
        logits = logits + torch.where(
            torch.arange(vp, device=h.device) < cfg.vocab_size, 0.0,
            L.NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                # (B, T)
    tl = torch.sum(h.float() * tvec.float(), dim=-1)
    tl = L.softcap(tl, cfg.final_softcap) if cfg.final_softcap else tl
    return (lse - tl).mean()


def loss_fn(cfg: ModelConfig, rc: RunConfig, params: dict, batch: dict, *,
            ax: Axes = NO_AXES):
    """Next-token cross-entropy (+ MoE aux) over the text region; returns
    (loss + aux term, {"loss", "aux"}).  With a frontend of F positions
    the prediction at position F - 1 + t scores text token t, the first
    one included."""
    tokens = batch["tokens"]
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    target = tokens if f else tokens[:, 1:]
    if rc.ce_impl == "sharded":
        h, aux = hidden_states(cfg, rc, params, tokens,
                               batch.get("frontend"), ax=ax)
        loss = _sharded_ce(cfg, params, h[:, f - 1:-1] if f else h[:, :-1],
                           target)
    else:
        logits, aux = forward(cfg, rc, params, tokens, batch.get("frontend"),
                              ax=ax)
        pred = logits[:, f - 1:-1] if f else logits[:, :-1]
        logp = F.log_softmax(pred.float(), dim=-1)
        loss = -torch.gather(logp, -1, target[..., None])[..., 0].mean()
    return loss + AUX_LOSS_COEF * aux, {"loss": loss, "aux": aux}


def _ffn(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor,
         is_moe: bool, ax: Axes = NO_AXES) -> torch.Tensor:
    """The block's FFN on the normed residual (a MoE's aux is dropped: it
    is a training term)."""
    if is_moe:
        return M.moe(cfg, rc, p, x, ax=ax)[0]
    return L.mlp(cfg, p, x, ax=ax)


def apply_block_decode(cfg: ModelConfig, rc: RunConfig, p: dict,
                       x: torch.Tensor, cache: dict, pos: torch.Tensor,
                       kind: str, is_moe: bool, j: int, attn_fn=None, *,
                       ax: Axes = NO_AXES):
    """One block's decode step against its cache ({"k", "v"} for an
    attention block, {"h", "conv"} for an SSM block; on a mesh this
    rank's block of it).  ``attn_fn`` swaps the attention-cache
    implementation (same signature as ``L.attention_decode``, without
    ``ax``: the serving engine's, which runs on one device); SSM blocks
    ignore it."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        w = _block_window(cfg, j)
        if attn_fn is None:
            h, new_cache = L.attention_decode(cfg, p["mixer"], h, cache, pos,
                                              window=w, ax=ax)
        else:
            h, new_cache = attn_fn(cfg, p["mixer"], h, cache, pos, window=w)
    else:
        h, new_cache = S.mamba_decode(cfg, p["mixer"], h, cache, ax=ax)
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
    x = x + h
    h = _ffn(cfg, rc, p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), is_moe,
             ax)
    if cfg.post_block_norms:
        h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
    return x + h, new_cache


def _token_rows(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The token rows of the embedding in ``dtype``, unscaled: a decode
    step's input.  The reference's ``decode_step`` and serving steps embed
    the decode token without ``embed_scale`` (its prefill scales), and the
    port follows it."""
    # rows of the cast table == cast rows of the table: gather first, so
    # the whole embedding is never cast per call
    return params["embed"][tokens].to(dtype)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, frontend,
           dtype) -> torch.Tensor:
    """A sequence's input (B, F + S, D): a frontend config's (B, F, D)
    ``frontend`` embeddings, then the tokens' rows, the whole scaled where
    the config says.  A frontend config refuses ``frontend=None``, as the
    reference's assert does."""
    x = _token_rows(params, tokens, dtype)
    if cfg.frontend:
        if frontend is None:
            raise ValueError(f"{cfg.name} needs frontend embeddings")
        x = torch.cat([frontend.to(dtype), x], dim=1)
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


def _stack_caches(parts: dict) -> dict:
    """{"b{j}": [per-superblock cache dicts]} -> {"b{j}": {name: stacked
    over superblocks}}."""
    return {key: {name: torch.stack([c[name] for c in caches])
                  for name in caches[0]}
            for key, caches in parts.items()}


def _weights(cfg: ModelConfig, params: dict, ax: Axes):
    """(top, block) for an inference step: ``top(name)`` is a leaf outside
    the stack ("embed", "final_norm", "lm_head") and ``block(j, sb)``
    pattern block ``j``'s parameters in superblock ``sb``, each whole.
    Off a mesh they are views of ``params``; on a mesh ``params`` is this
    rank's shards and each is gathered when asked for."""
    if ax.mesh is None:
        return params.__getitem__, lambda j, sb: superblock_params(params,
                                                                   j, sb)
    specs = spec_tree(model_specs(cfg), ax.resolve)

    def top(name):
        return gather_shard(params[name], specs[name], ax.mesh)

    def block(j, sb):
        key = f"b{j}"
        return gather_superblock(params["blocks"][key], specs["blocks"][key],
                                 ax.mesh, sb)
    return top, block


def _head(cfg: ModelConfig, top, embed) -> dict:
    """``_unembed``'s parameters: ``embed`` (the step's embedding) where
    the config ties it, else ``lm_head``."""
    return {"embed": embed} if cfg.tie_embeddings else \
        {"lm_head": top("lm_head")}


def prefill(cfg: ModelConfig, rc: RunConfig, params: dict,
            tokens: torch.Tensor, frontend=None, *, ax: Axes = NO_AXES):
    """Inference prefill: returns (last-position logits (B, 1, Vp), decode
    cache ``{"blocks": {"b{j}": ...}}``), each leaf stacked over
    superblocks: an attention block's {"k", "v"} (n_superblocks, B, t, KV,
    HD), t = S or the window; an SSM block's {"h" (n_superblocks, B, Di,
    N) float32, "conv" (n_superblocks, B, K-1, Di)}.  S counts a frontend
    config's ``frontend`` positions, which come first.  On a mesh
    (module docstring) ``params`` are this rank's shards, ``tokens`` and
    ``frontend`` its rows, and the logits and cache its blocks."""
    dtype = getattr(torch, rc.compute_dtype)
    top, block = _weights(cfg, params, ax)
    embed = top("embed")
    x = _embed(cfg, {"embed": embed}, tokens, frontend, dtype)
    if not cfg.tie_embeddings:
        embed = None
    pattern = cfg.block_pattern()
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    caches = {f"b{j}": [] for j in range(len(pattern))}
    for sb in range(cfg.n_superblocks):
        for j, (kind, is_moe) in enumerate(pattern):
            p = block(j, sb)
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kind == "attn":
                w = _block_window(cfg, j)
                t = min(s, w) if w else s
                if s % t:
                    raise ValueError("ring cache needs seq % window == 0")
                h, (k, v) = L.attention(cfg, rc, p["mixer"], h, window=w,
                                        positions=positions, return_kv=True,
                                        ax=ax)
                caches[f"b{j}"].append({"k": L.cache_block(k[:, -t:], ax),
                                        "v": L.cache_block(v[:, -t:], ax)})
            else:
                h, sc = S.mamba_prefill(cfg, p["mixer"], h, ax=ax)
                caches[f"b{j}"].append(sc)
            if cfg.post_block_norms:
                h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
            x = x + h
            h = _ffn(cfg, rc, p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                     is_moe, ax)
            if cfg.post_block_norms:
                h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
            x = x + h
            del p                # on a mesh: the block's gathered weights
    x = L.rmsnorm(top("final_norm"), x, cfg.norm_eps)
    logits = _unembed(cfg, _head(cfg, top, embed), x[:, -1:])
    return logits, {"blocks": _stack_caches(caches)}


def decode_step(cfg: ModelConfig, rc: RunConfig, params: dict,
                token: torch.Tensor, cache: dict, pos: torch.Tensor, *,
                ax: Axes = NO_AXES):
    """One decode step.  token: (B, 1) int64; pos: () current position;
    ``cache`` as ``prefill`` returns it (attention caches padded to the
    decode buffer).  Returns (logits (B, 1, Vp), new cache).  On a mesh
    ``params`` are this rank's shards, ``token`` its rows and ``cache``
    its block, and the logits and new cache are its blocks."""
    dtype = getattr(torch, rc.compute_dtype)
    top, block = _weights(cfg, params, ax)
    embed = top("embed")
    x = _token_rows({"embed": embed}, token, dtype)
    if not cfg.tie_embeddings:
        embed = None
    pattern = cfg.block_pattern()
    new = {f"b{j}": [] for j in range(len(pattern))}
    for sb in range(cfg.n_superblocks):
        for j, (kind, is_moe) in enumerate(pattern):
            c = {name: leaf[sb]
                 for name, leaf in cache["blocks"][f"b{j}"].items()}
            x, nc = apply_block_decode(cfg, rc, block(j, sb), x, c, pos,
                                       kind, is_moe, j, ax=ax)
            new[f"b{j}"].append(nc)
    x = L.rmsnorm(top("final_norm"), x, cfg.norm_eps)
    return _unembed(cfg, _head(cfg, top, embed), x), \
        {"blocks": _stack_caches(new)}
