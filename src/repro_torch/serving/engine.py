"""Batched serving engine over the banked paged-KV pool (port of
``repro.serving.engine``).

In the default ``kv_mode="paged"`` the prefill K/V is ingested into
per-layer bank-major page pools (one ``banked_scatter`` per pool) and every
decode step moves all KV traffic through the CUDA kernels on those pools:

  * read: each step gathers every sequence's page list from the K and V
    pools (``banked_gather``, the paged-attention read);
  * write: the new token's K/V goes into the gathered view and each
    sequence's current page is written back (``banked_scatter``, a
    read-modify-write append, in place).

Every decode step also records its exact ``AddressTrace`` (``step_trace``
/ ``serving_trace``), so ``cost_many`` prices the serving traffic on the
paper's memories.  ``kv_mode="dense"`` keeps the seq-contiguous reference
cache the paged path is held against.  (The reference's continuous-batching
``run_scheduler`` and its fault paths come with a later slice.)
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import arch as _arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import kvcache as KV


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, new) generated ids
    prompt_len: int
    steps: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, rc: RunConfig, params: dict,
                 max_batch: int = 8, max_seq: int = 256, mem_arch="16B",
                 kv_mode: str = "paged", page_len: int = 8, device="cuda"):
        self.cfg, self.rc = cfg, rc
        self.params = params
        self.device = torch.device(device)
        self.max_batch, self.max_seq = max_batch, max_seq
        #: the memory architecture the KV page banking derives from
        self.mem_arch = _arch.resolve(mem_arch)
        if kv_mode not in ("paged", "dense"):
            raise ValueError(f"kv_mode must be 'paged' or 'dense', "
                             f"got {kv_mode!r}")
        if kv_mode == "paged" and self.mem_arch.layout is None:
            raise ValueError(
                f"{self.mem_arch.name} has no banked layout; pick a banked "
                f"mem_arch for paged-KV serving (or kv_mode='dense')")
        self.kv_mode = kv_mode
        self.page_len = page_len
        self.kv_cfg = (self.paged_kv_config(page_len)
                       if kv_mode == "paged" else None)
        self._step_traces: list = []
        self._prefill_trace = None
        #: final PageTableState of the last paged generate
        self.last_pages: KV.PageTableState | None = None

    # -- configuration -----------------------------------------------------

    def paged_kv_config(self, page_len: int = 8) -> KV.PagedKVConfig:
        """The banked page-pool layout for this engine's batch/seq budget:
        bank count and page→bank map from ``mem_arch``'s ``BankedLayout``;
        the pool holds 2× the worst-case live pages."""
        lay = self.mem_arch.layout
        if lay is None:
            raise ValueError(
                f"{self.mem_arch.name} has no banked layout; pick a banked "
                f"mem_arch for paged-KV serving")
        kv_heads = self.cfg.n_kv_heads or self.cfg.n_heads
        return KV.PagedKVConfig.from_arch(
            self.mem_arch,
            n_pages=KV.pool_pages(lay.n_banks, self.max_batch, self.max_seq,
                                  page_len),
            page_len=page_len, kv_heads=kv_heads, head_dim=self.cfg.hd)

    @property
    def n_kv_layers(self) -> int:
        """Attention layers with a KV pool (pattern attn blocks × stack)."""
        return self.cfg.n_superblocks * sum(
            1 for kind, _ in self.cfg.block_pattern() if kind == "attn")

    # -- paged decode path -------------------------------------------------

    def _paged_attention_decode(self, cfg, p, x, cache, pos, *,
                                window: int = 0, pages=None, step_pos=0):
        """``L.attention_decode`` against the banked page pool: gather the
        sequences' pages, insert the new token, attend, write each current
        page back.  Same einsums, masks and dtypes as the dense path.
        ``step_pos`` is ``pos`` on the host (it picks the current page
        without a device sync)."""
        kv = self.kv_cfg
        arch = self.mem_arch
        b = x.shape[0]
        plen = kv.page_len
        n_pt = pages.page_table.shape[1]
        s_all = n_pt * plen
        kvh, hd = cfg.n_kv_heads, cfg.hd
        q, k_new, v_new = L._qkv(cfg, p, x, pos[None])
        ids = pages.page_table.clamp(min=0).reshape(-1)
        ck = KV.gather_pages(arch, kv, cache["k"], ids)
        cv = KV.gather_pages(arch, kv, cache["v"], ids)
        ck = ck.reshape(b, s_all, kvh, hd)
        cv = cv.reshape(b, s_all, kvh, hd)
        idx = torch.arange(s_all, device=x.device)
        hot = (idx == pos)[None, :, None, None]
        ck = torch.where(hot, k_new.to(ck.dtype), ck)
        cv = torch.where(hot, v_new.to(cv.dtype), cv)
        valid = (idx[None, :] <= pos) & torch.repeat_interleave(
            pages.page_table >= 0, plen, dim=1)
        if window:
            valid &= (pos - idx[None, :]) < window
        s = torch.einsum("bqkgh,btkh->bkgqt", q,
                         ck.to(q.dtype)) / math.sqrt(hd)
        s = L.softcap(s, cfg.attn_softcap)
        s = torch.where(valid[:, None, None, None, :], s, L.NEG_INF)
        pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bkgqt,btkh->bqkgh", pr, cv.to(q.dtype))
        o = o.reshape(b, 1, cfg.n_heads, hd)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
        # read-modify-write append: the current page goes back to the pool
        pg = step_pos // plen
        cur = pages.page_table[:, pg].clamp(min=0)
        line = slice(pg * plen, (pg + 1) * plen)
        k_line = ck[:, line].reshape(b, -1).contiguous()
        v_line = cv[:, line].reshape(b, -1).contiguous()
        kp = KV.scatter_pages(arch, kv, cache["k"], cur, k_line)
        vp = KV.scatter_pages(arch, kv, cache["v"], cur, v_line)
        return out, {"k": kp, "v": vp}

    def _paged_step(self, params, tok, pools, pages, pos: int):
        """One full-model decode step at position ``pos`` over the page
        pools (updated in place).  Returns (logits, pools, pages)."""
        cfg, rc = self.cfg, self.rc
        dtype = getattr(torch, rc.compute_dtype)
        need = (pages.seq_lens % self.kv_cfg.page_len) == 0
        pages, _ = KV.allocate_pages(self.kv_cfg, pages, need)
        x = T._embed(cfg, params, tok, dtype)
        attn_fn = functools.partial(self._paged_attention_decode, pages=pages,
                                    step_pos=pos)
        pos = torch.tensor(pos, device=self.device)
        for sb in range(cfg.n_superblocks):
            for j, (kind, is_moe) in enumerate(cfg.block_pattern()):
                key = f"b{j}s{sb}"
                x, pools[key] = T.apply_block_decode(
                    cfg, rc, T.superblock_params(params, j, sb), x,
                    pools[key], pos, kind, is_moe, j, attn_fn=attn_fn)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = T._unembed(cfg, params, x)
        return logits, pools, pages._replace(seq_lens=pages.seq_lens + 1)

    def _ingest_prefill(self, cache, plen: int, batch: int):
        """Allocate every prompt page and scatter the prefill K/V into the
        per-layer pools (one banked_scatter per pool); after this no dense
        KV state survives.  Returns (pools, pages)."""
        kv = self.kv_cfg
        n_pref = -(-plen // kv.page_len)
        pages = KV.fill_prompt_pages(kv, batch, self.max_seq, plen,
                                     self.device)
        ids = pages.page_table[:, :n_pref].clamp(min=0).reshape(-1)

        def pool_of(kc):
            # kc: (B, t, KV, HD) with t ≤ plen (a sliding-window prefill
            # keeps only the window; earlier slots stay zero and masked)
            t = kc.shape[1]
            buf = kc.new_zeros((batch, n_pref * kv.page_len) + kc.shape[2:])
            buf[:, plen - t:plen] = kc
            rows = buf.reshape(batch * n_pref, kv.row_width)
            pool2d = kc.new_zeros((kv.n_pages, kv.row_width))
            return KV.scatter_pages(self.mem_arch, kv, pool2d, ids, rows)

        pools = {}
        for j, (kind, _) in enumerate(self.cfg.block_pattern()):
            bc = cache["blocks"][f"b{j}"]
            for sb in range(self.cfg.n_superblocks):
                pools[f"b{j}s{sb}"] = {"k": pool_of(bc["k"][sb]),
                                       "v": pool_of(bc["v"][sb])}
        return pools, pages

    # -- dense reference path ----------------------------------------------

    def _pad_cache(self, cache, prompt_len: int):
        """Grow prefill caches (len = prompt) to the decode buffer
        (max_seq); ring (SWA) caches at window size stay as they are."""
        def grow(x):
            if x.shape[2] != prompt_len:
                return x
            win = self.cfg.sliding_window
            if win and prompt_len == win:
                return x
            pad = x.new_zeros(x.shape[:2] + (self.max_seq - prompt_len,)
                              + x.shape[3:])
            return torch.cat([x, pad], dim=2)
        return {"blocks": {key: {h: grow(c[h]) for h in ("k", "v")}
                           for key, c in cache["blocks"].items()}}

    # -- generation --------------------------------------------------------

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, prompt_len) integer token ids (a padded batch)."""
        b, plen = prompts.shape
        if b > self.max_batch or plen + max_new_tokens > self.max_seq:
            raise ValueError(f"batch {b} x {plen}+{max_new_tokens} tokens "
                             f"exceeds the engine's {self.max_batch} x "
                             f"{self.max_seq}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                     device=self.device)
            logits, cache = T.prefill(self.cfg, self.rc, self.params, tokens)
            tok = self._sample(logits[:, -1], temperature, gen)
            out = [tok]
            paged = self.kv_mode == "paged"
            if paged:
                pools, pages = self._ingest_prefill(cache, plen, b)
                del cache                   # no dense KV survives prefill
                self._step_traces = []
                self._prefill_trace = KV.prefill_trace(
                    self.kv_cfg, pages.page_table, plen, self.n_kv_layers)
            else:
                cache = self._pad_cache(cache, plen)
            for i in range(1, max_new_tokens):
                pos = plen + i - 1
                if paged:
                    logits, pools, pages = self._paged_step(
                        self.params, tok, pools, pages, pos)
                    self._step_traces.append(KV.decode_step_trace(
                        self.kv_cfg, pages.page_table, pos,
                        self.n_kv_layers))
                else:
                    logits, cache = T.decode_step(
                        self.cfg, self.rc, self.params, tok, cache,
                        torch.tensor(pos, device=self.device))
                tok = self._sample(logits[:, -1], temperature, gen)
                out.append(tok)
            if paged:
                self.last_pages = pages
            tokens_out = torch.cat(out, dim=1).cpu().numpy()
        return GenerationResult(tokens=tokens_out, prompt_len=plen,
                                steps=max_new_tokens)

    def _sample(self, logits, temperature: float, gen: torch.Generator):
        logits = logits[..., :self.cfg.vocab_size]
        if temperature <= 0.0:
            return logits.argmax(dim=-1)[:, None]
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    # -- serving-cost introspection ----------------------------------------

    def step_trace(self, step: int = -1):
        """The exact ``AddressTrace`` one decode step put on the KV pool
        (recorded by the last ``generate``)."""
        if not self._step_traces:
            raise RuntimeError(
                "no decode traces recorded; run generate() with "
                "kv_mode='paged' and max_new_tokens >= 2 first "
                "(the first token comes from prefill, not a decode step)")
        return self._step_traces[step]

    def serving_trace(self, include_prefill: bool = True):
        """The last generation's full KV ``AddressTrace`` (prefill page
        writes + every decode step)."""
        from repro_torch.core.trace import AddressTrace
        return AddressTrace.concat(*self._trace_chunks(include_prefill))

    def serving_stream(self, include_prefill: bool = True):
        """The last generation's KV traffic as a re-iterable
        ``TraceStream`` of per-step blocks."""
        from repro_torch.core.trace import TraceStream
        return TraceStream(self._trace_chunks(include_prefill),
                           meta={"what": "serving-live",
                                 "arch": self.mem_arch.name,
                                 "steps": len(self._step_traces)})

    def serving_cost(self, archs=None, include_prefill: bool = True,
                     block_ops: int | None = None, device=None):
        """Price the last generation's serving traffic with ``cost_many``
        (on the engine's device unless ``device`` says otherwise).
        ``archs`` defaults to this engine's ``mem_arch`` (one
        ``TraceCost``); a list returns one ``TraceCost`` per entry."""
        from repro_torch.core.cost_engine import cost_many
        stream = self.serving_stream(include_prefill)
        device = self.device if device is None else device
        if archs is None:
            return cost_many([self.mem_arch], stream, block_ops=block_ops,
                             device=device)[0]
        return cost_many(list(archs), stream, block_ops=block_ops,
                         device=device)

    def _trace_chunks(self, include_prefill: bool) -> list:
        chunks = list(self._step_traces)
        if include_prefill and self._prefill_trace is not None:
            chunks = [self._prefill_trace] + chunks
        if not chunks:
            raise RuntimeError(
                "no traces recorded; run generate() with kv_mode='paged'")
        return chunks
